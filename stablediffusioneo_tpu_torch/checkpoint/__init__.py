"""Checkpoint conversion."""
