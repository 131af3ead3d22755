"""Sampler and application pipeline."""
