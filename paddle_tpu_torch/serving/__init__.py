"""Serving: the bucketed predict path (`BucketPolicy`, the `Batcher`,
the `Engine` around an `inference.Predictor`), token serving (the paged
KV cache, the continuous-batching decode engine with its KV reuse:
chunked prefill, the prefix cache, speculative decoding), and the HTTP
front end that serves both (POST /v1/predict and /v1/generate)."""

from .batcher import (Batcher, EngineError, QueueFullError, RequestTimeout,
                      ServerClosed)
from .bucketing import BucketPolicy, common_batch
from .decode import DecodeConfig, DecodeEngine, DecodeHandle
from .engine import Engine, ServingConfig
from .httpd import Server
from .kv_reuse import ReuseBlockAllocator, accept_length, hash_blocks

__all__ = ["Batcher", "BucketPolicy", "DecodeConfig", "DecodeEngine",
           "DecodeHandle", "Engine", "EngineError", "QueueFullError",
           "RequestTimeout", "ReuseBlockAllocator", "Server", "ServerClosed",
           "ServingConfig", "accept_length", "common_batch", "hash_blocks"]
