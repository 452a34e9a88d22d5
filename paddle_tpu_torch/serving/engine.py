"""Server configuration.

The subset of the JAX package's `serving/engine.py` that a decode-only
server reads: where to listen, and whether `Server.start` warms its
decode engines before it binds. The bucketed predict engine
(`model_dir` and its knobs) is not ported (ROADMAP item 17).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ServingConfig"]


class ServingConfig:
    """host=None binds 127.0.0.1; port=0 binds an ephemeral port.
    warmup=True (the default): `Server.start` runs every decode
    engine's `warmup()` before it binds, and the health probe reads
    "warming" while an engine is not warm."""

    def __init__(self, *, host: Optional[str] = None, port: int = 0,
                 warmup: bool = True):
        self.host = host
        self.port = int(port)
        self.warmup = bool(warmup)
