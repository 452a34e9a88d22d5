"""Server configuration.

The subset of the JAX package's `serving/engine.py` that a decode-only
server reads: where to listen. The bucketed predict engine (`model_dir`
and its knobs) is not ported.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ServingConfig"]


class ServingConfig:
    """host=None binds 127.0.0.1; port=0 binds an ephemeral port."""

    def __init__(self, *, host: Optional[str] = None, port: int = 0):
        self.host = host
        self.port = int(port)
