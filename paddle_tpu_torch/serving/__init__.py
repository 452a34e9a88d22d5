"""Serving: the bucketed predict path (`BucketPolicy`, the `Batcher`,
the `Engine` around an `inference.Predictor`), token serving (the paged
KV cache, the continuous-batching decode engine with its KV reuse:
chunked prefill, the prefix cache, speculative decoding), per-tenant
QoS on both (tiers, weighted-fair admission, quotas, typed sheds), the
HTTP front end that serves both (POST /v1/predict and /v1/generate,
more predict slots, hot swap from the model registry) and the fleet
tier (the `Router` and its HTTP front, the `Autoscaler`; the replica
process is `python -m paddle_tpu_torch.serving.replica`)."""

from .batcher import (Batcher, EngineError, QueueFullError, RequestTimeout,
                      ServerClosed)
from .bucketing import BucketPolicy, common_batch
from .decode import DecodeConfig, DecodeEngine, DecodeHandle
from .engine import Engine, ServingConfig
from .httpd import Server
from .kv_cache import BlockAllocator, KVCacheConfig, NoBlocksError
from .kv_reuse import ReuseBlockAllocator, accept_length, hash_blocks
from .qos import QoSPolicy, ShedError, TenantSpec, WeightedFairScheduler
from .registry import ModelRegistry, RegistryError
from .router import (FleetError, FleetTimeout, NoReplicasError,
                     ReplicaRejected, Router, RouterServer,
                     StreamBrokenError, TierShed)
from .autoscale import Autoscaler

__all__ = ["Autoscaler", "Batcher", "BlockAllocator", "BucketPolicy",
           "DecodeConfig", "DecodeEngine", "DecodeHandle", "Engine",
           "EngineError", "FleetError", "FleetTimeout", "KVCacheConfig",
           "ModelRegistry", "NoBlocksError", "NoReplicasError", "QoSPolicy",
           "QueueFullError", "RegistryError", "ReplicaRejected",
           "RequestTimeout", "ReuseBlockAllocator", "Router", "RouterServer",
           "Server", "ServerClosed", "ServingConfig", "ShedError",
           "StreamBrokenError", "TenantSpec", "TierShed",
           "WeightedFairScheduler", "accept_length", "common_batch",
           "hash_blocks"]
