"""Core runtime of the port: precision policies, and the fluid path's IR,
op registry, lowering, backward and executor."""

from . import compile_cache  # noqa: F401
