"""Ops: layers, norms, attention, schedule, kernel dispatch."""
