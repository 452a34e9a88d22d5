"""Admission errors shared by the serving front end.

The subset of the JAX package's `serving/batcher.py` that the decode
engine and the HTTP server raise and answer (the dynamic batcher itself
is not ported).
"""

from __future__ import annotations

__all__ = ["QueueFullError", "ServerClosed"]


class QueueFullError(RuntimeError):
    """Admission control: max_queue requests already pending (HTTP 503)."""


class ServerClosed(RuntimeError):
    """Submitted during/after shutdown drain (HTTP 503)."""
