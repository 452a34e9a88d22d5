"""Resilience plumbing copied from the JAX package: atomic file writes."""
