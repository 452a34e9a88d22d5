"""Token serving: the paged KV cache, the continuous-batching decode
engine with its KV reuse (chunked prefill, the prefix cache,
speculative decoding), and its HTTP front end."""

from .batcher import QueueFullError, ServerClosed
from .decode import DecodeConfig, DecodeEngine, DecodeHandle
from .engine import ServingConfig
from .httpd import Server
from .kv_reuse import ReuseBlockAllocator, accept_length, hash_blocks

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeHandle", "QueueFullError",
           "ReuseBlockAllocator", "Server", "ServerClosed", "ServingConfig",
           "accept_length", "hash_blocks"]
