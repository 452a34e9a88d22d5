"""Token serving: the paged KV cache, the continuous-batching decode
engine and its HTTP front end."""

from .batcher import QueueFullError, ServerClosed
from .decode import DecodeConfig, DecodeEngine, DecodeHandle
from .engine import ServingConfig
from .httpd import Server

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeHandle", "QueueFullError",
           "Server", "ServerClosed", "ServingConfig"]
