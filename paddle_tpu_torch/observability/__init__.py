"""Stdlib observability plumbing copied from the JAX package."""
