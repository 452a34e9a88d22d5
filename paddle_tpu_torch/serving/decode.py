"""Continuous-batching autoregressive decode engine, in PyTorch.

Counterpart of the JAX package's `serving/decode.py`, with the same
scheduler:

- a paged KV cache (kv_cache.py): blocks allocated on admit and as a
  sequence grows, freed on finish;
- continuous (in-flight) batching: new requests join the running decode
  batch every step and finished ones retire without draining it;
- a prefill/decode phase split: a prompt pads to the smallest
  prefill bucket that fits (powers of two from 8 up to max_len by
  default), a decode step runs at the smallest configured slot count
  that holds the live sequences;
- a warm phase grid: `warmup()` runs every (phase, size) pair once
  before the scheduler starts. Each prefill bucket runs eagerly (which
  builds K1-fwd and warms cuBLAS and the allocator, so no live request
  pays the cold start), and on CUDA every phase whose inputs are static
  (each decode slot count's step, and the KV-reuse phases below) is
  captured as one CUDA graph, which every later call at that size
  replays: the counterpart of the JAX package's one AOT executable per
  (phase, size). An engine never warmed runs every phase eagerly.
  `export_warmstart` / `load_warmstart` carry the grid's fingerprints
  between processes (a CUDA graph cannot be serialized);
- one-step-late token resolve: step N is dispatched with step N-1's
  tokens still on the device, and step N-1's tokens reach the host
  through a non-blocking copy into pinned memory plus a CUDA event,
  read while step N runs;
- recompute preemption when the pool runs dry: the youngest sequence
  frees its blocks and is re-queued with prompt + generated tokens;
  tokens already streamed are not re-emitted;
- KV reuse (kv_reuse.py), switched on by any of three DecodeConfig
  knobs: `prefill_chunk` (one fixed-size chunk phase replaces the
  prefill buckets; prompts prefill slice by slice, one slice between
  decode rounds), `prefix_cache` (a ref-counted, chain-hashed block
  index: a prompt whose leading full blocks are cached skips their
  prefill; LRU eviction; copy-on-write before a write into a shared
  block) and `spec_k` with a draft model (`DecodeEngine(...,
  draft=(params, cfg))`: the draft proposes k tokens, one batched
  target step verifies them, the exact greedy accept rule keeps the
  stream equal to plain decode's). Such an engine runs the synchronous
  loop (`_loop_sync`, as the JAX package's): each round reads its
  tokens before the next, with no one-step-late resolve. Its phases
  `chunk`, `draft_chunk`, `draft_decode` and `verify` are captured as
  CUDA graphs in the engine's one graph pool, `draft_prefill` runs
  eagerly as `prefill` does, and all of them write the pools in place;
- boot validation: config findings in the analysis Finding shape
  (`paddle_tpu_torch/analysis.py`), PADDLE_TPU_VALIDATE=2 refuses to
  boot a broken grid; below level 2 an engine with an error finding
  boots, reports it in `status()`, and refuses to warm or serve;
- per-tenant QoS (`DecodeConfig(qos=...)`, a `qos.QoSPolicy` or its
  `from_spec` dict; `submit(..., tenant=...)`), on both loops: the
  next waiting request is picked by (tier, weighted-fair virtual time),
  charged its prompt at admission and one unit per emitted token; a
  full queue sheds the lowest tier, newest first, through
  `qos.ShedError`; a quota caps one tenant's waiting, prefilling and
  active requests; the preemption victim under KV pressure is the
  lowest tier, youngest admission first. Without a policy admission is
  FIFO and the victim the youngest, as before;
- the JAX package's decode, KV-reuse and tenant metrics (same names,
  same update points), its `decode`, `shed` and `warmstart` events and
  its per-request trace spans;
- the JAX package's observability hooks: the boot validation's
  `record_analysis`, a perfwatch sample per prefill, chunk and decode
  round (live MFU; the FLOPs come from `GPTConfig.forward_flops`, since
  a captured CUDA graph has no cost analysis), the prefill's and the
  token fetch's dispatch-to-ready latency, and memwatch owner rows
  `kv_pool`, `params` and (with the prefix cache) `prefix_cache`,
  suffixed `[tag]` under `DecodeConfig(model_tag=tag)`; the engines'
  CUDA-graph pools are memwatch's executable bytes.

Sampling is greedy through ops.beam.beam_search with beam_size=1,
whose finished-freeze keeps an ended slot emitting eos.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import queue
import threading
import time
import weakref
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import analysis as _an
from .. import profiler as _profiler
from .. import resolve_device
from ..core import compile_cache as _cc
from ..core import precision as _precision
from ..kernels import _build
from ..observability import events as _events
from ..observability import memwatch as _memwatch
from ..observability import metrics as _m
from ..observability import perfwatch as _perfwatch
from ..observability import telemetry as _telemetry
from ..observability import tracing as _tracing
from ..resilience.atomic import write_bytes
from .batcher import QueueFullError, ServerClosed
from .kv_cache import (BlockAllocator, KVCacheConfig, NoBlocksError,
                       build_block_table, init_pools)
from . import kv_reuse as _kvr
from .kv_reuse import ReuseBlockAllocator

if TYPE_CHECKING:  # qos.py imports batcher; runtime import is deferred
    from .qos import WeightedFairScheduler

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeHandle",
           "DECODE_WARMSTART_FORMAT"]

DECODE_WARMSTART_FORMAT = "paddle_tpu_torch-decode-warmstart-v1"

QUEUE_DEPTH = _m.gauge(
    "paddle_tpu_decode_queue_depth",
    "Requests waiting for a decode slot")
SLOTS = _m.gauge(
    "paddle_tpu_decode_slots",
    "Decode slots (state=active|configured)", labelnames=("state",))
KV_BLOCKS = _m.gauge(
    "paddle_tpu_decode_kv_blocks",
    "KV-cache pool blocks (state=used|free)", labelnames=("state",))
TTFT_SECONDS = _m.histogram(
    "paddle_tpu_decode_ttft_seconds",
    "Submit-to-first-token latency (prefill completion)")
STEP_SECONDS = _m.histogram(
    "paddle_tpu_decode_step_seconds",
    "Wall seconds per decode step (dispatch N to dispatch N+1)")
TOKENS = _m.counter(
    "paddle_tpu_decode_tokens_total",
    "Tokens sampled (phase=prefill|decode)", labelnames=("phase",))
STEPS = _m.counter(
    "paddle_tpu_decode_steps_total",
    "Phase executions (phase=prefill|decode|draft|verify)",
    labelnames=("phase",))
REQUESTS = _m.counter(
    "paddle_tpu_decode_requests_total",
    "Finished requests by outcome (eos|length|rejected|cancelled|error)",
    labelnames=("outcome",))
PREEMPTIONS = _m.counter(
    "paddle_tpu_decode_preemptions_total",
    "Sequences preempted back to the queue on KV-pool pressure")
OCCUPANCY = _m.histogram(
    "paddle_tpu_decode_slot_occupancy",
    "Active slots / compiled slot count per decode step",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))


# the engines whose CUDA-graph pools memwatch reports as its executable
# bytes: added at construction, dropped at stop()
_graph_engines: "weakref.WeakSet[DecodeEngine]" = weakref.WeakSet()


def _graph_pool_bytes(pool) -> int:
    """Bytes of the caching allocator's segments in a CUDA-graph pool
    (`torch.cuda.graph_pool_handle()`), from torch.cuda.memory_snapshot;
    0 when the snapshot does not name segment pools."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _graph_pools() -> Tuple[int, int]:
    """memwatch's executables provider: (bytes, captured graphs) over
    the live engines' graph pools."""
    nbytes = graphs = 0
    for eng in list(_graph_engines):
        if eng._graph_pool is not None:
            nbytes += _graph_pool_bytes(eng._graph_pool)
            graphs += len(eng._graphs)
    return nbytes, graphs


_memwatch.set_executables_provider(_graph_pools)


def _pow2_lengths(lo: int, hi: int) -> Tuple[int, ...]:
    out, b = [], int(lo)
    while b < hi:
        out.append(b)
        b *= 2
    out.append(int(hi))
    return tuple(sorted(set(out)))


class DecodeConfig:
    """Knobs of the decode engine.

    decode_slots: the slot counts a decode step runs at; each step runs
    at the smallest one >= live sequences. prefill_buckets: prompt-length
    buckets (powers of two from 8 up to max_len by default); a prompt
    pads to the smallest bucket that fits. num_blocks/block_size: the KV
    pool (block 0 is the null block). precision: "bf16" (default) or
    "f32" for pools and compute. static_batching=True admits only into
    an EMPTY batch (the drain-between-batches baseline). warmstart: the
    path of an artifact from `export_warmstart`, loaded at construction
    (`load_warmstart`).

    KV-reuse knobs, as the JAX package's: prefill_chunk > 0 replaces
    the prefill-bucket grid with ONE fixed-size chunk phase, prompts
    prefilling in slices interleaved with decode rounds;
    prefix_cache=True (requires prefill_chunk) makes the allocator
    ref-counted with a content-hash index, so shared prompt prefixes
    resolve to live pool blocks; spec_k > 0 (requires a draft model
    passed to DecodeEngine) proposes k tokens a round through the draft
    and verifies them in one batched target step with the exact greedy
    accept rule. Any of them switches the engine onto the synchronous
    reuse scheduler.

    model_tag: the memwatch owner suffix for multi-model processes:
    with model_tag="m" the engine's owner rows are "kv_pool[m]",
    "params[m]" and "prefix_cache[m]"."""

    def __init__(self, *, block_size: int = 16, num_blocks: int = 64,
                 decode_slots: Sequence[int] = (4, 8),
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_len: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 max_queue: int = 64,
                 precision: str = "bf16",
                 static_batching: bool = False,
                 warmstart: Optional[str] = None,
                 prefix_cache: bool = False,
                 prefill_chunk: int = 0,
                 spec_k: int = 0,
                 qos=None,
                 model_tag: Optional[str] = None):
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.decode_slots = tuple(sorted({int(s) for s in decode_slots}))
        self.prefill_buckets = tuple(sorted({int(b) for b in
                                             prefill_buckets})) \
            if prefill_buckets is not None else None
        self.max_len = max_len
        self.eos_id = eos_id
        self.max_queue = int(max_queue)
        self.precision = str(precision)
        self.static_batching = bool(static_batching)
        self.warmstart = warmstart
        self.prefix_cache = bool(prefix_cache)
        self.prefill_chunk = int(prefill_chunk)
        self.spec_k = int(spec_k)
        # per-tenant QoS policy (a qos.QoSPolicy or its from_spec dict;
        # None = single-tenant FIFO)
        self.qos = qos
        self.model_tag = model_tag
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{self.prefill_chunk}")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.prefix_cache and not self.prefill_chunk:
            raise ValueError(
                "prefix_cache=True requires prefill_chunk > 0: reused "
                "prefixes start the computed suffix mid-prompt, which "
                "only the chunked (gather-attention) prefill program "
                "supports")


class DecodeHandle:
    """Client side of one generation: a thread-safe token stream.

    `tokens()` yields token ids as the scheduler emits them and ends
    when the request finishes; `result(timeout_s)` collects them all.
    `info` fills in as generation progresses (ttft_s, finish_reason,
    n_tokens)."""

    def __init__(self, req: "_Request"):
        self._req = req

    @property
    def info(self) -> Dict:
        r = self._req
        return {
            "prompt_len": int(r.prompt_len0),
            "n_tokens": len(r.generated),
            "ttft_s": (r.t_first - r.t_submit) if r.t_first else None,
            "finish_reason": r.finish_reason,
        }

    def tokens(self, timeout_s: Optional[float] = None):
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        while True:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                item = self._req.events.get(timeout=left)
            except queue.Empty:
                raise TimeoutError(
                    f"generation produced no token within {timeout_s}s")
            if item is None:
                if self._req.error is not None:
                    raise self._req.error
                return
            yield item

    def result(self, timeout_s: Optional[float] = None) -> List[int]:
        return list(self.tokens(timeout_s=timeout_s))


class _Request:
    __slots__ = ("rid", "prompt", "prompt_len0", "max_new", "generated",
                 "events", "t_submit", "t_first", "finish_reason",
                 "error", "cancelled", "last_token", "pos", "blocks",
                 "admitted_at", "tctx", "enqueued_at",
                 "prefill_pos", "draft_pos", "n_reused", "hashes",
                 "tenant")

    def __init__(self, rid: int, prompt: np.ndarray, max_new: int,
                 tenant: str = "default"):
        self.tenant = tenant
        self.rid = rid
        # captured on the submitter's thread; the scheduler thread
        # records queue-wait/prefill/TTFT spans against it later
        self.tctx = _tracing.current_trace()
        self.prompt = prompt                   # grows on preempt-replay
        self.prompt_len0 = len(prompt)         # original, for reporting
        self.max_new = int(max_new)
        self.generated: List[int] = []
        self.events: "queue.Queue" = queue.Queue()
        self.t_submit = time.monotonic()
        self.enqueued_at = self.t_submit   # re-stamped on preempt requeue
        self.t_first: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.cancelled = False
        # slot state (meaningful while active)
        self.last_token = 0
        self.pos = 0                           # next KV write position
        self.blocks: List[int] = []
        self.admitted_at = 0.0
        # KV-reuse state (chunked prefill / prefix cache / speculation)
        self.prefill_pos = 0     # next prompt position to chunk-prefill
        self.draft_pos = 0       # next DRAFT KV write position
        self.n_reused = 0        # prefix blocks resolved from the cache
        self.hashes = None       # chain hashes of the prompt's blocks


class _TokenFetch:
    """A decode step's tokens on their way to the host. On CUDA: a
    non-blocking copy into pinned memory and an event recorded behind
    it on the current stream, so `result()` waits for that step only.
    On the CPU the tokens are already there."""

    __slots__ = ("_host", "_event")

    def __init__(self, tok: torch.Tensor):
        self._event = None
        if tok.device.type == "cuda":
            self._host = torch.empty(tok.shape, dtype=tok.dtype,
                                     pin_memory=True)
            self._host.copy_(tok, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tok

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class _Pending:
    """One in-flight decode step: the token fetch plus the exact batch
    composition it was dispatched with."""

    __slots__ = ("fetch", "tok_dev", "snapshot", "slots", "t_dispatch")

    def __init__(self, tok_dev, snapshot, slots):
        self.fetch = _TokenFetch(tok_dev)
        self.tok_dev = tok_dev
        self.snapshot = snapshot               # tuple of rids (padded -1)
        self.slots = slots                     # list of Optional[_Request]
        self.t_dispatch = time.perf_counter()


class _PhaseGraph:
    """One phase at one size captured as a CUDA graph: its static inputs
    (in the phase function's argument order), its static output (the
    sampled tokens, int64) and the pools and params whose addresses the
    graph holds. Every replay writes the same output tensor."""

    __slots__ = ("graph", "inputs", "out", "pools", "params")


class DecodeEngine:
    """Continuous-batching token generation over a paged KV cache.

    Built from in-memory model state: `params` (the flat dict of
    `models.gpt`, dense configs only) and `model_cfg`; with
    `DecodeConfig(spec_k=k)`, also `draft=(draft_params, draft_cfg)`,
    the draft model (a smaller GPT with the same vocabulary; its pools
    share the target's block tables, so one allocation and one prefix
    hit cover both models). The params are cast to the precision's
    dtype and moved to `device` (cuda unless the caller passes
    device="cpu"). `submit()` is thread-safe and reject-not-block
    (QueueFullError when `max_queue` prompts wait); one scheduler
    thread owns the device pools, the allocator, and every phase call.
    `warmup()`, before the scheduler starts, warms the phase grid (see
    the module docstring).

    A config fault is a boot-validation finding (`analysis`), raised
    as AnalysisError only at PADDLE_TPU_VALIDATE=2, as in the JAX
    package. Below that level an engine with an error finding (a
    mixture-of-experts config, a max_len beyond the model's positional
    table, a pool that cannot hold one sequence, a draft whose
    vocabulary differs, ...) constructs and reports it in `status()`,
    allocates no KV pool, and refuses to warm or serve: `warmup()`,
    `start()` and `submit()` raise naming the findings."""

    def __init__(self, params, model_cfg, config: Optional[DecodeConfig]
                 = None, draft=None, *, device=None):
        from ..models import gpt as _gpt

        self._gpt = _gpt
        self.device = resolve_device(device)
        self.config = config or DecodeConfig()
        self.model_cfg = model_cfg
        self.prefill_chunk = self.config.prefill_chunk
        self.spec_k = self.config.spec_k
        if self.spec_k and draft is None:
            raise ValueError(
                "spec_k > 0 requires a draft model: pass "
                "DecodeEngine(..., draft=(draft_params, draft_cfg))")
        if draft is not None and not self.spec_k:
            raise ValueError(
                "a draft model was passed but spec_k == 0; set "
                "DecodeConfig(spec_k=k) to enable speculation")
        # any reuse feature runs the synchronous scheduler (_loop_sync)
        self._sync = bool(self.prefill_chunk or self.spec_k)
        if self.config.precision not in ("f32", "bf16"):
            raise ValueError(
                f"unsupported decode precision "
                f"{self.config.precision!r}; choose from ['f32', 'bf16']")
        self._compute_dtype = _precision.compute_dtype(self.config.precision)
        self.params = self._cast(params)
        max_len = int(self.config.max_len or model_cfg.max_len)
        self.kv_cfg = self._kv_config(model_cfg, max_len)
        self.prefill_buckets = self.config.prefill_buckets \
            if self.config.prefill_buckets is not None \
            else _pow2_lengths(min(8, max_len), max_len)
        self.decode_slots = self.config.decode_slots
        self.eos_id = -1 if self.config.eos_id is None \
            else int(self.config.eos_id)

        # the draft model (speculative decoding): its pools share
        # num_blocks, block_size and max_len with the target's, so the
        # block tables are shared
        self._draft = draft
        self._draft_params = self._draft_cfg = self._draft_kv_cfg = None
        if draft is not None:
            draft_params, self._draft_cfg = draft
            self._draft_params = self._cast(draft_params)
            self._draft_kv_cfg = self._kv_config(self._draft_cfg, max_len)

        self._findings: List[_an.Finding] = []
        self.analysis = self._validate_boot()
        self._boot_errors = [f for f in self._findings
                             if f.severity == _an.ERROR]

        # an engine that will not serve allocates no pool
        self._pools = self._draft_pools = None
        if not self._boot_errors:
            self._pools = init_pools(self.kv_cfg, self.device)
            if draft is not None:
                self._draft_pools = init_pools(self._draft_kv_cfg,
                                               self.device)
        self._alloc = ReuseBlockAllocator(self.kv_cfg) \
            if self.config.prefix_cache else BlockAllocator(self.kv_cfg)
        self._device_kind = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else "cpu"
        # each phase's FLOPs at each size, for the perfwatch samples
        self._flops = {key: self._phase_flops(key)
                       for key in self._phase_keys()}
        self._mem_handles = self._register_memory()
        # re-entrant: _count takes it from paths that already hold it
        self._cv = threading.Condition(threading.RLock())
        # per-tenant QoS (None = single-tenant FIFO). Deferred import:
        # qos.py pulls QueueFullError from batcher.
        from . import qos as _qos_mod

        self._qosm = _qos_mod
        self._qos = _qos_mod.QoSPolicy.from_spec(
            getattr(self.config, "qos", None))
        self._wfq: Optional["WeightedFairScheduler"] = \
            _qos_mod.WeightedFairScheduler(self._qos) \
            if self._qos is not None else None
        self._waiting: "collections.deque[_Request]" = collections.deque()
        self._active: List[_Request] = []
        # chunked-prefill stage: admitted (blocks reserved) but not yet
        # fully prefilled; the sync loop advances the FRONT request one
        # chunk per iteration, interleaved with decode rounds
        self._prefilling: "collections.deque[_Request]" = \
            collections.deque()
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._closed = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._rid = 0
        self._last_slot_config: Optional[int] = None
        self._counts = {k: 0 for k in
                        ("eos", "length", "rejected", "cancelled",
                         "error", "preempted")}
        # the warm phase grid: phases warmed so far, the phases captured
        # per (phase, size) key (CUDA) sharing one memory pool, and how
        # many calls of each captured kind ran as a replay or eagerly
        self.warmed = False
        self.warmstart_adopted = 0
        self._warm: set = set()
        self._warming = False
        self._warm_error: Optional[BaseException] = None
        self._graphs: Dict[Tuple[str, int], _PhaseGraph] = {}
        self._graph_pool = None
        self._runs = {kind: {"replayed": 0, "eager": 0}
                      for kind in sorted({k for k, _ in self._phase_keys()}
                                         - self._EAGER)}
        self._digest: Optional[str] = None
        SLOTS.set(max(self.decode_slots), state="configured")
        if self.config.warmstart:
            self.load_warmstart(self.config.warmstart)

    def _register_memory(self) -> List[int]:
        """memwatch providers of this engine's KV pools and params (and
        of the prefix cache's retained blocks), as the JAX engine
        registers them: callables over the CURRENT tensors, weakref'd so
        a dropped engine never pins its pools."""
        ref = weakref.ref(self)

        def kv_tensors():
            eng = ref()
            if eng is None:
                return ()
            return list(eng._pools or ()) + list(eng._draft_pools or ())

        def param_tensors():
            eng = ref()
            if eng is None:
                return ()
            out = list(eng.params.values())
            if eng._draft_params is not None:
                out.extend(eng._draft_params.values())
            return out

        tag = self.config.model_tag
        own = (lambda base: f"{base}[{tag}]") if tag else (lambda b: b)
        handles = [_memwatch.register_provider(own("kv_pool"), kv_tensors),
                   _memwatch.register_provider(own("params"),
                                               param_tensors)]
        if self.config.prefix_cache:
            # the cached blocks' bytes live INSIDE the kv_pool tensors:
            # reported beside them, never added to the total
            per_block = self._prefix_block_bytes()

            def prefix_bytes():
                eng = ref()
                if eng is None:
                    return (0, 0)
                n = eng._alloc.cached_blocks()
                return (n * per_block, n)

            handles.append(_memwatch.register_bytes_provider(
                own("prefix_cache"), prefix_bytes))
        _graph_engines.add(self)
        return handles

    def _prefix_block_bytes(self) -> int:
        """Device bytes ONE cached block retains across both models'
        pools (K and V, all layers): the unit of the prefix_cache row."""
        def per(kv: KVCacheConfig) -> int:
            return (2 * kv.layers * kv.block_size * kv.kv_heads *
                    kv.head_dim * getattr(torch, kv.dtype).itemsize)
        n = per(self.kv_cfg)
        if self._draft_kv_cfg is not None:
            n += per(self._draft_kv_cfg)
        return n

    def _phase_flops(self, key: Tuple[str, int]) -> float:
        """One run's forward FLOPs of a (phase, size) key, by
        `GPTConfig.forward_flops`: a prefill bucket T attends over T,
        the gather phases over the whole block table."""
        kind, n = key
        draft = kind.startswith("draft_")
        cfg = self._draft_cfg if draft else self.model_cfg
        base = kind[6:] if draft else kind
        table = self.kv_cfg.max_blocks_per_seq * self.kv_cfg.block_size
        if base == "prefill":
            return cfg.forward_flops(n, n, 1)
        if base == "chunk":
            return cfg.forward_flops(n, table, 1)
        if base == "verify":
            w = n * (self.spec_k + 1)
            return cfg.forward_flops(w, table, w)
        return cfg.forward_flops(n, table, n)

    def _cast(self, params) -> Dict[str, torch.Tensor]:
        return {k: _precision.cast_floating(v, self._compute_dtype)
                .to(self.device) for k, v in params.items()}

    def _kv_config(self, cfg, max_len: int) -> KVCacheConfig:
        return KVCacheConfig(
            layers=cfg.layers, kv_heads=cfg.heads, head_dim=cfg.head_dim,
            max_len=max_len, block_size=self.config.block_size,
            num_blocks=self.config.num_blocks,
            dtype=str(self._compute_dtype).replace("torch.", ""))

    # -- boot validation -------------------------------------------------

    def _validate_boot(self) -> Dict[str, int]:
        """Config findings in the analysis Finding shape, with the JAX
        package's severities, pass name, messages and variables for
        every knob this engine has. Always runs (boot is one-time) and
        raises AnalysisError only at PADDLE_TPU_VALIDATE=2. The JAX
        package's `decode_trace` pass shape-traces every phase at boot;
        mha refuses the meta device, so a phase has no cheap shape-only
        run in torch, and that pass runs inside `warmup()`, where each
        phase runs once."""
        t0 = time.perf_counter()

        def add(sev, msg, var=None):
            self._findings.append(_an.Finding(
                severity=sev, pass_name="decode_config", message=msg,
                var=var))

        kv, mc = self.kv_cfg, self.model_cfg
        if getattr(mc, "n_experts", 0):
            add(_an.ERROR, "MoE decode is unsupported: the paged decode "
                "step has no expert-dispatch path (ROADMAP item 4) — "
                "serve a dense config")
        if kv.usable_blocks < kv.max_blocks_per_seq:
            add(_an.ERROR,
                f"KV pool cannot hold ONE full sequence: "
                f"{kv.usable_blocks} usable blocks < "
                f"{kv.max_blocks_per_seq} blocks for max_len "
                f"{kv.max_len}", var="num_blocks")
        worst = max(self.decode_slots) * kv.max_blocks_per_seq
        if kv.usable_blocks < worst:
            add(_an.WARNING,
                f"KV pool oversubscribed: {kv.usable_blocks} usable "
                f"blocks < {worst} worst-case ({max(self.decode_slots)} "
                f"slots x {kv.max_blocks_per_seq} blocks) — expect "
                "preemptions under full-length load", var="num_blocks")
        if kv.max_len > mc.max_len:
            add(_an.ERROR,
                f"max_len {kv.max_len} exceeds the model's positional "
                f"table ({mc.max_len})", var="max_len")
        if not (-1 <= self.eos_id < mc.vocab_size):
            add(_an.ERROR,
                f"eos_id {self.eos_id} outside vocab [0, "
                f"{mc.vocab_size})", var="eos_id")
        if self.prefill_chunk:
            # the chunk phase covers ANY prompt length under max_len, so
            # the bucket-coverage checks (the "largest prefill bucket <
            # max_len" preemption-replay warning too) are retired on this
            # path: a preemption's replay re-chunks at any length
            if self.prefill_chunk > kv.max_len:
                add(_an.ERROR,
                    f"prefill_chunk {self.prefill_chunk} exceeds "
                    f"max_len {kv.max_len}", var="prefill_chunk")
        else:
            for t in self.prefill_buckets:
                if t > kv.max_len:
                    add(_an.ERROR, f"prefill bucket {t} exceeds max_len "
                        f"{kv.max_len}", var="prefill_buckets")
            if max(self.prefill_buckets) < kv.max_len:
                add(_an.WARNING,
                    f"largest prefill bucket "
                    f"{max(self.prefill_buckets)} < max_len "
                    f"{kv.max_len}: a pool-pressure preemption whose "
                    "replay prompt (original + generated) outgrows the "
                    "bucket set fails that request — extend "
                    "prefill_buckets to max_len if preemptions are "
                    "expected", var="prefill_buckets")
        if self._draft_cfg is not None:
            dc = self._draft_cfg
            if dc.vocab_size != mc.vocab_size:
                add(_an.ERROR,
                    f"draft vocab_size {dc.vocab_size} != target "
                    f"{mc.vocab_size}: proposed ids would be "
                    "meaningless to the verifier", var="draft")
            if dc.max_len < kv.max_len:
                add(_an.ERROR,
                    f"draft max_len {dc.max_len} < serving max_len "
                    f"{kv.max_len}: the draft runs every position the "
                    "target does", var="draft")
            if getattr(dc, "n_experts", 0):
                add(_an.ERROR, "MoE draft is unsupported (same "
                    "constraint as the target model)", var="draft")
        if self.spec_k and self.spec_k >= kv.max_len:
            add(_an.ERROR, f"spec_k {self.spec_k} >= max_len "
                f"{kv.max_len}", var="spec_k")
        for s in self.decode_slots:
            if s < 1:
                add(_an.ERROR, f"decode slot count {s} < 1",
                    var="decode_slots")
        _telemetry.record_analysis(
            self._findings, n_ops=len(self._phase_keys()),
            where="decode", seconds=time.perf_counter() - t0)
        return self._tally()

    def _tally(self) -> Dict[str, int]:
        """The findings so far as the `analysis` counts; raises
        AnalysisError when one is an error and PADDLE_TPU_VALIDATE=2."""
        out = {"errors": 0, "warnings": 0, "infos": 0}
        for f in self._findings:
            out[f.severity + "s"] = out.get(f.severity + "s", 0) + 1
        if out["errors"] and _an.validate_level() >= 2:
            raise _an.AnalysisError(self._findings)
        return out

    def _refuse_invalid(self) -> None:
        """Raise when boot validation found an error (below
        PADDLE_TPU_VALIDATE=2, where the engine constructs): it neither
        warms nor serves, and there is no eager fallback."""
        if self._boot_errors:
            raise RuntimeError(
                "this engine's boot validation found "
                f"{len(self._boot_errors)} error(s); it does not serve: " +
                "; ".join(str(f) for f in self._boot_errors))

    # -- phase grid / warmstart ----------------------------------------

    # phases that run eagerly even when warmed: a prefill's prompt
    # length is a host int (apply_prefill's slice of the padded bucket)
    _EAGER = frozenset({"prefill", "draft_prefill"})

    def _phase_keys(self) -> List[Tuple[str, int]]:
        keys: List[Tuple[str, int]] = []
        if self.prefill_chunk:
            keys.append(("chunk", self.prefill_chunk))
        else:
            keys.extend(("prefill", t) for t in self.prefill_buckets)
        keys.extend(("decode", s) for s in self.decode_slots)
        if self._draft is not None:
            if self.prefill_chunk:
                keys.append(("draft_chunk", self.prefill_chunk))
            else:
                keys.extend(("draft_prefill", t)
                            for t in self.prefill_buckets)
            keys.extend(("draft_decode", s) for s in self.decode_slots)
            keys.extend(("verify", s) for s in self.decode_slots)
        return keys

    def _warm_order(self, keys) -> List[Tuple[str, int]]:
        """The eager prefills first, then the chunk phases, then the
        slot-count phases largest first: the largest capture sizes the
        shared graph pool, which the smaller ones then reuse."""
        def order(key):
            kind, n = key
            if kind in self._EAGER:
                return (0, n, kind)
            if kind.endswith("chunk"):
                return (1, n, kind)
            return (2, -n, kind)
        return sorted(keys, key=order)

    def warmup(self) -> int:
        """Warm every phase of the grid; returns how many phases are
        ready. Idempotent: a phase warmed before (by an earlier call or
        from a warmstart artifact) is not run again.

        A prefill bucket T (the draft's too) runs once on a [1, T]
        prompt with an all-zero block table, so every write lands in the
        null block. Every other phase (decode and draft_decode at S
        slots, verify at S slots of k + 1 tokens, chunk and draft_chunk
        at C tokens) is, on CUDA, run once eagerly on a side stream and
        then captured as one CUDA graph on static, all-zero input
        buffers (`_phase_buffers`); on the CPU it runs once eagerly and
        nothing is captured.

        Runs before the scheduler: called after start() it raises
        RuntimeError (a capture while the scheduler launches on the
        device would be illegal). A phase that raises becomes an ERROR
        finding under `decode_trace` in `analysis`, and the call raises:
        AnalysisError at PADDLE_TPU_VALIDATE=2, else the phase's own
        error. An engine whose warmup failed never serves."""
        self._warm_keys(self._phase_keys())
        self.warmed = True
        return len(self._warm)

    def _warm_keys(self, keys) -> None:
        self._refuse_invalid()
        with self._cv:
            while self._warming:
                self._cv.wait()
            if self._thread is not None:
                raise RuntimeError(
                    "warmup runs before start(): the scheduler thread "
                    "already launches on the device")
            if self._closed:
                raise RuntimeError("decode engine is stopped")
            self._warming = True
        try:
            with torch.inference_mode(), self._on_device():
                for key in self._warm_order(keys):
                    if key not in self._warm:
                        self._warm_phase(key)
        finally:
            with self._cv:
                self._warming = False
                self._cv.notify_all()

    def _warm_phase(self, key: Tuple[str, int]) -> None:
        kind, n = key
        try:
            if kind in self._EAGER:
                draft = kind == "draft_prefill"
                ids = torch.zeros((1, n), dtype=torch.int32,
                                  device=self.device)
                bt = torch.zeros((self.kv_cfg.max_blocks_per_seq,),
                                 dtype=torch.int32, device=self.device)
                int(self._prefill(draft, ids, n, bt)[0])
            elif self.device.type == "cuda":
                self._graphs[key] = self._capture(key)
            else:
                self._phase_call(kind, self._phase_buffers(key))
        except Exception as e:
            self._warm_error = e
            self._findings.append(_an.Finding(
                severity=_an.ERROR, pass_name="decode_trace",
                message=f"{kind}@{n} fails to warm: "
                        f"{type(e).__name__}: {str(e)[:200]}"))
            self.analysis = self._tally()   # AnalysisError at level 2
            raise
        self._warm.add(key)

    def _phase_state(self, kind: str):
        """(params, model config, pools) a phase kind runs on: the
        draft's for draft_*, the target's otherwise."""
        if kind.startswith("draft_"):
            return self._draft_params, self._draft_cfg, self._draft_pools
        return self.params, self.model_cfg, self._pools

    def _prefill(self, draft: bool, ids, length: int, block_table
                 ) -> torch.Tensor:
        """A whole-prompt prefill of the target or the draft (eager)."""
        params, cfg, (kp, vp) = self._phase_state(
            "draft_prefill" if draft else "prefill")
        return self._gpt.apply_prefill(
            params, cfg, ids, length, kp, vp, block_table,
            block_size=self.kv_cfg.block_size, eos_id=self.eos_id)

    def _phase_buffers(self, key: Tuple[str, int]) -> Tuple[torch.Tensor,
                                                           ...]:
        """All-zero inputs of a captured phase, in its function's
        argument order before the pools, then its block table(s):
        decode/draft_decode (ids[S], positions[S], tables[S, MB]),
        verify (ids[S, k+1], positions[S], tables[S, MB]), chunk and
        draft_chunk (ids[1, C], start[], length[], table[MB]). Every
        write lands in the null block."""
        kind, n = key
        mb = self.kv_cfg.max_blocks_per_seq

        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        if kind.endswith("chunk"):
            return z(1, n), z(), z(), z(mb)
        width = (n, self.spec_k + 1) if kind == "verify" else (n,)
        return z(*width), z(n), z(n, mb)

    def _phase_call(self, kind: str, inputs) -> torch.Tensor:
        """Run one captured-kind phase eagerly on `inputs` (device
        tensors, `_phase_buffers`' order); returns its tokens."""
        params, cfg, (kp, vp) = self._phase_state(kind)
        base = kind[6:] if kind.startswith("draft_") else kind
        fn = getattr(self._gpt, {"decode": "apply_decode_step",
                                 "verify": "apply_verify_step",
                                 "chunk": "apply_prefill_chunk"}[base])
        *front, table = inputs
        return fn(params, cfg, *front, kp, vp, table,
                  block_size=self.kv_cfg.block_size, eos_id=self.eos_id)

    def _capture(self, key: Tuple[str, int]) -> _PhaseGraph:
        """One phase at one size as a CUDA graph on static buffers. One
        eager run on a side stream first (cuBLAS handles and workspaces,
        allocator blocks); the capture then shares the engine's one
        graph memory pool."""
        kind = key[0]
        g = _PhaseGraph()
        g.inputs = self._phase_buffers(key)
        g.params, _, g.pools = self._phase_state(kind)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._phase_call(kind, g.inputs)
        cur.wait_stream(side)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph, pool=self._graph_pool):
            g.out = self._phase_call(kind, g.inputs)
        return g

    def _run_phase(self, key: Tuple[str, int], *args) -> torch.Tensor:
        """Launch one phase of a captured kind: a replay of its graph
        when warmup captured one, else the eager call. Each argument is
        a host array or a device tensor, in `_phase_buffers`' order.
        A replay returns the graph's static output, which the next
        replay of the same graph overwrites: read or copy it first."""
        kind = key[0]
        g = self._graphs.get(key)
        if g is None:
            out = self._phase_call(kind, [
                self._tensor(a) if isinstance(a, np.ndarray) else a
                for a in args])
            self._runs[kind]["eager"] += 1
            return out
        params, _, pools = self._phase_state(kind)
        if g.pools is not pools or g.params is not params:
            raise RuntimeError(
                "the KV pools or the params were rebound after "
                "warmup(); the captured phases hold the old tensors' "
                "addresses")
        for dst, a in zip(g.inputs, args):
            # a device argument may be int64 tokens (a previous step's
            # output): the copy casts them to the static int32 buffer
            dst.copy_(self._pinned(a) if isinstance(a, np.ndarray) else a,
                      non_blocking=True)
        g.graph.replay()
        self._runs[kind]["replayed"] += 1
        return g.out

    def _phase_fingerprint(self, key: Tuple[str, int]) -> str:
        """A phase's input shapes and dtypes and the kernel sources it
        launches: what a warmstart entry must match to be adopted."""
        kind, n = key
        draft = kind.startswith("draft_")
        base = kind[6:] if draft else kind
        kv = self._draft_kv_cfg if draft else self.kv_cfg
        mb = kv.max_blocks_per_seq
        pool = [kv.layers, kv.num_blocks, kv.block_size, kv.kv_heads,
                kv.head_dim]
        kernels = []
        if base == "prefill":
            inputs = [["ids", [1, n], "int32"], ["block_table", [mb],
                                                 "int32"]]
            kernels = ["flash_attention"]    # K1-fwd in mha(causal)
        elif base == "chunk":
            inputs = [["ids", [1, n], "int32"], ["start", [], "int32"],
                      ["length", [], "int32"],
                      ["block_table", [mb], "int32"]]
        else:
            width = [n, self.spec_k + 1] if base == "verify" else [n]
            inputs = [["ids", width, "int32"], ["positions", [n], "int32"],
                      ["block_tables", [n, mb], "int32"]]
        inputs += [["k_pool", pool, kv.dtype], ["v_pool", pool, kv.dtype]]
        sig = {"phase": kind, "size": n, "inputs": inputs,
               "kernels": {k: _build.source_hash(k) for k in kernels}}
        return hashlib.sha256(
            json.dumps(sig, sort_keys=True).encode()).hexdigest()

    def _model_digest(self) -> str:
        """Binds warmstart artifacts to THIS model + grid: params
        content, model config, and the kv/pool geometry that shapes
        every phase. Computed once: the params are never rebound (the
        captured steps hold their addresses)."""
        if self._digest is None:
            h = hashlib.sha256()
            h.update(repr((self.model_cfg, self.kv_cfg,
                           self.decode_slots, self.prefill_buckets,
                           self.config.precision, self.eos_id,
                           self.prefill_chunk, self.spec_k,
                           self._draft_cfg)).encode())
            for prefix, params in (("", self.params),
                                   ("draft:", self._draft_params or {})):
                for name in sorted(params):
                    t = params[name].detach().contiguous().cpu()
                    h.update(f"{prefix}{name}:{t.dtype}:"
                             f"{tuple(t.shape)}".encode())
                    # as bytes: numpy has no bfloat16
                    h.update(t.reshape(-1).view(torch.uint8).numpy()
                             .tobytes())
            self._digest = h.hexdigest()
        return self._digest

    def export_warmstart(self, path: str) -> int:
        """Write the grid's warmstart artifact (JSON, written through
        `resilience.atomic`): this process's `environment_meta`, the
        model digest, the grid and one entry per warmed phase, carrying
        the phase's fingerprint. Call after warmup(); returns how many
        phases it carries."""
        entries = [{"phase": k, "size": n,
                    "fingerprint": self._phase_fingerprint((k, n))}
                   for k, n in self._phase_keys() if (k, n) in self._warm]
        grid = {"decode": list(self.decode_slots)}
        if self.prefill_chunk:
            # the chunk phase collapses the bucket dimension: the
            # artifact advertises the chunk size, not buckets
            grid["chunk"] = self.prefill_chunk
        else:
            grid["prefill"] = list(self.prefill_buckets)
        if self.spec_k:
            grid["spec_k"] = self.spec_k
        art = dict(_cc.environment_meta(self.device),
                   format=DECODE_WARMSTART_FORMAT,
                   model_digest=self._model_digest(),
                   grid=grid,
                   created_at=time.time(),
                   entries=entries)
        write_bytes(path, json.dumps(art, sort_keys=True).encode())
        _events.emit("warmstart", action="export_decode", path=path,
                     entries=len(entries))
        return len(entries)

    def load_warmstart(self, path: str) -> int:
        """Adopt the phases of a decode warmstart artifact: each entry
        whose fingerprint matches is warmed now, as warmup() warms it.
        Same degradation contract as the JAX package's: an unreadable
        file, another environment or a foreign model digest costs a
        `warmstart` reject event and returns 0, never a boot failure.
        Returns how many phases were adopted (`warmstart_adopted`)."""
        try:
            with open(path, "rb") as f:
                art = json.loads(f.read())
            if not isinstance(art, dict) or \
                    art.get("format") != DECODE_WARMSTART_FORMAT:
                raise ValueError("not a decode warmstart artifact")
        except (OSError, ValueError) as e:
            _events.emit("warmstart", action="reject", path=path,
                         reason=f"unreadable: {str(e)[:200]}")
            self.warmstart_adopted = 0
            return 0
        env = _cc.environment_meta(self.device)
        stored = {k: art.get(k) for k in env}
        if stored != env:
            _events.emit("warmstart", action="reject", path=path,
                         reason=f"environment mismatch: artifact "
                                f"{stored} vs process {env}")
            self.warmstart_adopted = 0
            return 0
        if art.get("model_digest") != self._model_digest():
            _events.emit("warmstart", action="reject", path=path,
                         reason="model digest mismatch — artifact baked "
                                "from a different model/grid")
            self.warmstart_adopted = 0
            return 0
        grid = set(self._phase_keys())
        adopt = set()
        for entry in art.get("entries") or []:
            try:
                key = (str(entry["phase"]), int(entry["size"]))
                fp = entry["fingerprint"]
            except (KeyError, TypeError, ValueError):
                continue    # a malformed entry costs that phase only
            if key in grid and fp == self._phase_fingerprint(key):
                adopt.add(key)
        if adopt:
            self._warm_keys(adopt)
        self.warmstart_adopted = len(adopt)
        _events.emit("warmstart", action="load_decode", path=path,
                     adopted=len(adopt))
        return len(adopt)

    # -- public API ----------------------------------------------------

    def start(self):
        """Start the scheduler thread (idempotent; submit() calls it).
        Waits for a warmup in progress; raises when a warmup failed or
        boot validation found an error."""
        self._refuse_invalid()
        with self._cv:
            while self._warming:
                self._cv.wait()
            if self._thread is not None or self._closed:
                return
            if self._warm_error is not None:
                raise RuntimeError(
                    f"this engine's warmup failed "
                    f"({type(self._warm_error).__name__}: "
                    f"{self._warm_error}); it does not serve")
            self._thread = threading.Thread(
                target=self._run, name="paddle-tpu-torch-decode",
                daemon=True)
            self._thread.start()
            _events.emit("decode", action="start",
                         slots=list(self.decode_slots),
                         prefill_buckets=list(self.prefill_buckets),
                         blocks=self.kv_cfg.usable_blocks)

    def submit(self, prompt_ids, max_new_tokens: int = 16,
               tenant: Optional[str] = None) -> DecodeHandle:
        """Enqueue one generation; returns its token-stream handle.
        Reject-not-block: QueueFullError (HTTP 503) when max_queue
        prompts already wait, ServerClosed after stop() or drain().
        Under a QoS policy (DecodeConfig(qos=...)) a full queue sheds
        the lowest-tier waiter (newest first within the tier) through
        qos.ShedError, possibly a queued victim, in which case this
        arrival is admitted in its place; per-tenant quotas bound one
        tenant's waiting, prefilling and active requests. Raises
        RuntimeError on an engine whose boot validation found an
        error."""
        self._refuse_invalid()
        prompt = np.asarray(prompt_ids, np.int32).ravel()
        if prompt.size < 1:
            raise ValueError("prompt must carry at least one token id")
        if self.prefill_chunk:
            # chunked prefill has no bucket ceiling: any prompt that
            # leaves room to generate under max_len is admissible
            if prompt.size > self.kv_cfg.max_len - 1:
                raise ValueError(
                    f"prompt length {prompt.size} leaves no room to "
                    f"generate under max_len {self.kv_cfg.max_len}")
        elif prompt.size > self.prefill_buckets[-1]:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the largest "
                f"prefill bucket {self.prefill_buckets[-1]}")
        if int(prompt.min()) < 0 or \
                int(prompt.max()) >= self.model_cfg.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, "
                f"{self.model_cfg.vocab_size})")
        room = self.kv_cfg.max_len - int(prompt.size)
        if room < 1:
            raise ValueError(
                f"prompt length {prompt.size} leaves no room to "
                f"generate under max_len {self.kv_cfg.max_len}")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        max_new = min(int(max_new_tokens), room)
        tenant = str(tenant) if tenant else self._qosm.DEFAULT_TENANT
        shed_victim: Optional[_Request] = None
        shed_err: Optional[BaseException] = None
        with self._cv:
            if self._closed:
                self._count("rejected", tenant)
                raise ServerClosed("decode engine is stopped")
            if self._draining:
                self._count("rejected", tenant)
                raise ServerClosed(
                    "decode engine is draining; request rejected")
            qos = self._qos
            if qos is not None:
                quota = qos.quota_of(tenant)
                if quota is not None:
                    have = sum(1 for r in self._waiting
                               if r.tenant == tenant) \
                        + sum(1 for r in self._active
                              if r.tenant == tenant) \
                        + sum(1 for r in self._prefilling
                              if r.tenant == tenant)
                    if have >= quota:
                        tier = qos.tier_of(tenant)
                        self._qosm.SHEDS.inc(tier=tier, kind="quota")
                        _events.emit("shed", where="decode",
                                     tenant=tenant, tier=tier,
                                     shed="quota")
                        self._count("rejected", tenant)
                        raise self._qosm.ShedError(
                            f"tenant {tenant!r} over quota ({quota} "
                            "concurrent generations); request rejected",
                            tenant=tenant, tier=tier, kind="quota")
            if len(self._waiting) >= self.config.max_queue:
                if qos is None:
                    self._count("rejected", tenant)
                    raise QueueFullError(
                        f"decode queue full ({self.config.max_queue} "
                        "waiting); request rejected")
                # tier-ordered shed: lowest tier first, newest first
                # within the tier, the arrival included as a candidate
                entries = [(r.tenant, r.rid) for r in self._waiting] \
                    + [(tenant, self._rid + 1)]
                vi = self._qosm.shed_victim(entries, qos)
                v_tenant = entries[vi][0]
                v_tier = qos.tier_of(v_tenant)
                self._qosm.SHEDS.inc(tier=v_tier, kind="queue")
                _events.emit("shed", where="decode", tenant=v_tenant,
                             tier=v_tier, shed="queue")
                err = self._qosm.ShedError(
                    f"decode queue full ({self.config.max_queue} "
                    f"waiting); shed tier {v_tier!r} (tenant "
                    f"{v_tenant!r})",
                    tenant=v_tenant, tier=v_tier, kind="queue")
                if vi == len(entries) - 1:   # the arrival is the victim
                    self._count("rejected", tenant)
                    raise err
                shed_victim = self._waiting[vi]
                del self._waiting[vi]
                shed_err = err
            self._rid += 1
            req = _Request(self._rid, prompt, max_new, tenant)
            self._waiting.append(req)
            QUEUE_DEPTH.set(len(self._waiting))
            self._cv.notify_all()
        if shed_victim is not None:
            # outside the lock: end the victim's stream with the typed
            # error
            shed_victim.error = shed_err
            self._count("rejected", shed_victim.tenant)
            shed_victim.finish_reason = "rejected"
            shed_victim.events.put(None)
        self.start()
        return DecodeHandle(req)

    def cancel(self, handle: DecodeHandle):
        """Abandon one generation (the HTTP front end calls this when a
        streaming client disconnects): the scheduler retires it at its
        next iteration, freeing its slot and blocks. Idempotent."""
        with self._cv:
            handle._req.cancelled = True
            self._cv.notify_all()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting (new submits raise ServerClosed) but let every
        waiting and active generation finish. Returns True when the
        engine emptied within `timeout_s`."""
        deadline = time.monotonic() + float(timeout_s)
        with self._cv:
            if not self._draining:
                self._draining = True
                _events.emit("decode", action="drain",
                             waiting=len(self._waiting),
                             active=len(self._active))
        while time.monotonic() < deadline:
            with self._cv:
                if self._closed or (not self._waiting
                                    and not self._active
                                    and not self._prefilling):
                    return True
            time.sleep(0.01)
        with self._cv:
            return not self._waiting and not self._active \
                and not self._prefilling

    def stop(self):
        """Stop the scheduler: waiting and active requests are cancelled
        (their streams end with finish_reason='cancelled'). Idempotent;
        joins the thread. Requests enqueued before any scheduler thread
        existed are finished here."""
        with self._cv:
            if not self._closed:
                self._closed = True
                self._cv.notify_all()
            t = self._thread
            stranded = [] if t is not None else list(self._waiting)
            if t is None and stranded:
                self._waiting.clear()
                QUEUE_DEPTH.set(0)
        for req in stranded:
            self._finish(req, "cancelled")
        if t is not None:
            t.join(timeout=30.0)
        for h in self._mem_handles:
            _memwatch.unregister_provider(h)
        self._mem_handles = []
        _graph_engines.discard(self)
        _events.emit("decode", action="stop")

    def load(self) -> Tuple[int, int]:
        """(queued, active): the cheap pair the /v1/load probe folds
        into its scalar load score without building the full status
        document."""
        with self._cv:
            return (len(self._waiting),
                    len(self._active) + len(self._prefilling))

    def status(self) -> Dict:
        with self._cv:
            waiting = len(self._waiting)
            active = len(self._active)
            prefilling = len(self._prefilling)
            live_tokens = sum(r.pos for r in self._active)
            live_tokens += sum(r.prefill_pos for r in self._prefilling)
            counts = dict(self._counts)
            draining = self._draining
        grid = {"decode_slots": list(self.decode_slots)}
        if self.prefill_chunk:
            grid["prefill_chunk"] = self.prefill_chunk
        else:
            grid["prefill_buckets"] = list(self.prefill_buckets)
        out = {
            "draining": draining,
            "device": str(self.device),
            "phase_grid": grid,
            "queue_depth": waiting,
            "active": active,
            "slot_config": self._last_slot_config,
            "static_batching": self.config.static_batching,
            "precision": self.config.precision,
            "eos_id": self.eos_id,
            "warmed": self.warmed,
            "warmstart_adopted": self.warmstart_adopted,
            "analysis": self.analysis,
            # decode steps served by a captured graph or eagerly
            "decode_steps": dict(self._runs["decode"]),
            # the same for every captured kind of the grid
            "phase_runs": {k: dict(v) for k, v in self._runs.items()},
            "kv": self._alloc.stats(live_tokens=live_tokens),
            "requests": counts,
        }
        if self._qos is not None:
            out["qos"] = {
                "policy": self._qos.spec_dict(),
                "served_shares": {
                    t: round(s, 4) for t, s in
                    self._wfq.served_shares().items()},
            }
        if self._sync:
            out["prefilling"] = prefilling
            out["kv_reuse"] = {
                "prefix_cache": self.config.prefix_cache,
                "prefill_chunk": self.prefill_chunk,
                "spec_k": self.spec_k,
                "spec_proposed": self._spec_proposed,
                "spec_accepted": self._spec_accepted,
                "spec_accept_rate": round(
                    self._spec_accepted / self._spec_proposed, 4)
                if self._spec_proposed else None,
            }
        return out

    # -- scheduler internals (single thread owns everything below) -----

    def _count(self, outcome: str, tenant: Optional[str] = None):
        REQUESTS.inc(outcome=outcome)
        if self._qos is not None and tenant is not None:
            self._qosm.TENANT_REQUESTS.inc(
                tenant=tenant, tier=self._qos.tier_of(tenant),
                outcome=outcome)
        with self._cv:
            self._counts[outcome] = self._counts.get(outcome, 0) + 1

    def _emit_token(self, req: _Request, tok: int, phase: str):
        req.last_token = int(tok)
        req.generated.append(int(tok))
        TOKENS.inc(phase=phase)
        if self._wfq is not None:
            # token-granular service charge: the admission pick reads
            # these virtual times, so sustained token flow to one
            # tenant defers its next admission in favor of underserved
            # same-tier tenants
            self._wfq.charge(req.tenant, 1)
            self._qosm.TENANT_TOKENS.inc(tenant=req.tenant)
        if req.t_first is None:
            req.t_first = time.monotonic()
            TTFT_SECONDS.observe(req.t_first - req.t_submit)
            if self._qos is not None:
                self._qosm.TENANT_TTFT_SECONDS.observe(
                    req.t_first - req.t_submit, tenant=req.tenant)
            # per-request TTFT span: submit -> first sampled token
            _tracing.record_trace_span(
                "decode.ttft", req.tctx, req.t_first - req.t_submit,
                cat="decode", rid=req.rid, prompt_len=req.prompt_len0,
                tenant=req.tenant)
        req.events.put(int(tok))

    def _finished_reason(self, req: _Request) -> Optional[str]:
        if req.generated and req.generated[-1] == self.eos_id:
            return "eos"
        if len(req.generated) >= req.max_new:
            return "length"
        return None

    def _finish(self, req: _Request, reason: str):
        req.finish_reason = reason
        now = time.monotonic()
        if req.t_first is not None and len(req.generated) > 1:
            # decode-phase span: first token -> last token (the
            # prefill/TTFT spans cover everything before it)
            _tracing.record_trace_span(
                "decode.decode", req.tctx, now - req.t_first,
                cat="decode", rid=req.rid,
                tokens=len(req.generated) - 1)
        _tracing.record_trace_span(
            "decode.generate", req.tctx, now - req.t_submit,
            cat="decode", rid=req.rid, tokens=len(req.generated),
            reason=reason, tenant=req.tenant)
        if req.blocks:
            self._alloc.free(req.blocks)   # reuse allocator: decref;
            req.blocks = []                # cached blocks go to the LRU
        if req in self._active:
            self._active.remove(req)
        if req in self._prefilling:
            self._prefilling.remove(req)
        self._count(reason, req.tenant)
        req.events.put(None)
        self._kv_gauges()

    def _kv_gauges(self):
        KV_BLOCKS.set(self._alloc.used_blocks(), state="used")
        KV_BLOCKS.set(self._alloc.free_blocks(), state="free")
        if self.config.prefix_cache:
            KV_BLOCKS.set(self._alloc.cached_blocks(), state="cached")
        SLOTS.set(len(self._active), state="active")

    def _bucket_for_len(self, n: int) -> Optional[int]:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return None

    def _slot_config(self) -> int:
        n = max(1, len(self._active))
        for s in self.decode_slots:
            if n <= s:
                return s
        return self.decode_slots[-1]

    def _sweep_cancelled(self):
        """Retire requests whose clients abandoned them (cancel()):
        waiting ones leave the queue, active ones free their slot and
        blocks. A cancelled request with a token still in flight is
        skipped by _resolve's not-in-active check."""
        with self._cv:
            gone_waiting = [r for r in self._waiting if r.cancelled]
            for r in gone_waiting:
                self._waiting.remove(r)
            if gone_waiting:
                QUEUE_DEPTH.set(len(self._waiting))
        for r in gone_waiting:
            self._finish(r, "cancelled")
        for r in [r for r in self._active if r.cancelled]:
            self._finish(r, "cancelled")
        for r in [r for r in self._prefilling if r.cancelled]:
            self._finish(r, "cancelled")

    def _pick_waiting_locked(self) -> int:
        """Index of the next waiting request to admit (caller holds
        _cv, _waiting non-empty): FIFO without a QoS policy; (tier
        priority, weighted-fair virtual time) with one."""
        if self._wfq is None:
            return 0
        return self._wfq.pick([r.tenant for r in self._waiting])

    def _victim_key(self, r: _Request):
        """Preemption ordering under KV pressure: lowest tier first
        (max tier rank), youngest admission within the tier; the
        youngest-first rule alone when no QoS policy is attached (rank
        is constant 0)."""
        rank = 0 if self._qos is None else self._qos.rank_of(r.tenant)
        return (rank, r.admitted_at)

    def _admit(self) -> bool:
        """Move waiting requests into free slots while blocks last;
        each admission runs its prefill (the admission boundary is the
        one place the scheduler syncs with the device). Returns whether
        the batch composition changed."""
        changed = False
        max_slots = self.decode_slots[-1]
        while True:
            with self._cv:
                if not self._waiting or self._closed:
                    break
                if self.config.static_batching and self._active:
                    break  # drain-between-batches baseline
                if len(self._active) >= max_slots:
                    break
                idx = self._pick_waiting_locked()
                req = self._waiting[idx]
                need = -(-len(req.prompt) // self.kv_cfg.block_size)
                if not self._alloc.can_alloc(need):
                    break  # blocks scale with live tokens: defer
                del self._waiting[idx]
                QUEUE_DEPTH.set(len(self._waiting))
            self._prefill_one(req)
            changed = True
        return changed

    def _pinned(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor, in pinned memory on a CUDA engine,
        so a copy from it to the device does not wait for the stream."""
        t = torch.from_numpy(a)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On CUDA the copy goes
        through pinned memory and does not wait for the stream, so
        building a step's inputs never blocks on the step before."""
        return self._pinned(a).to(self.device, non_blocking=True)

    def _prefill_one(self, req: _Request):
        # the admission boundary: everything since (re-)enqueue was wait
        _tracing.record_trace_span(
            "decode.queue_wait", req.tctx,
            time.monotonic() - req.enqueued_at, cat="decode",
            rid=req.rid, tenant=req.tenant)
        if self._wfq is not None:
            # prefill service charge: a long prompt is real work even
            # before its first decode token
            self._wfq.charge(req.tenant, len(req.prompt))
        plen = len(req.prompt)
        bucket = self._bucket_for_len(plen)
        if bucket is None:  # replay grew past the largest bucket
            req.error = RuntimeError(
                f"prompt+generated length {plen} exceeds the largest "
                f"prefill bucket {self.prefill_buckets[-1]}")
            self._finish(req, "error")
            return
        need = -(-plen // self.kv_cfg.block_size)
        req.blocks = self._alloc.alloc(need)
        bt = build_block_table(req.blocks, self.kv_cfg.max_blocks_per_seq)
        ids = np.empty((1, bucket), np.int32)
        ids[0, :plen] = req.prompt
        ids[0, plen:] = req.prompt[-1]         # edge-pad (in-distribution)
        ids, bt = self._tensor(ids), self._tensor(bt)
        t0 = time.perf_counter()
        tok = self._prefill(False, ids, plen, bt)
        if self._draft is not None:
            # the draft prefills EVERY sequence (same ids, same block
            # table, its own pools) so speculation can start at the
            # first decode round
            self._prefill(True, ids, plen, bt)
            req.draft_pos = plen
            STEPS.inc(phase="draft")
        tok0 = int(tok[0])                     # admission-boundary sync
        STEPS.inc(phase="prefill")
        _tracing.record_trace_span(
            "decode.prefill", req.tctx, time.perf_counter() - t0,
            cat="decode", t0_perf=t0, rid=req.rid, bucket=int(bucket),
            prompt_len=plen)
        _telemetry.record_dispatch_ready(
            "decode:prefill", time.perf_counter() - t0)
        # live-MFU sample: the bucket's FLOPs over this prefill's wall
        # window (one token emitted — the TTFT token)
        _perfwatch.record_step(
            "prefill", time.perf_counter() - t0,
            flops=self._flops[("prefill", bucket)], tokens=1,
            device_kind=self._device_kind)
        req.pos = plen
        req.admitted_at = time.monotonic()
        self._active.append(req)
        self._emit_token(req, tok0, phase="prefill")
        reason = self._finished_reason(req)
        if reason:
            self._finish(req, reason)
        self._kv_gauges()

    def _grow_blocks(self, pending: Optional[_Pending]
                     ) -> Optional[_Pending]:
        """Ensure every active slot owns the block its next write
        lands in. On pool exhaustion: resolve the in-flight step (its
        finishes may free blocks), retry, then preempt the youngest
        active sequence (lowest tier first under QoS) until the step
        fits."""
        while True:
            short = None
            for req in self._active:
                bi = req.pos // self.kv_cfg.block_size
                while bi >= len(req.blocks):
                    try:
                        req.blocks.extend(self._alloc.alloc(1))
                    except NoBlocksError:
                        short = req
                        break
                if short is not None:
                    break
            if short is None:
                return pending
            if pending is not None:
                pending = self._resolve(pending)
                continue  # finishes may have freed enough
            victim = max(self._active, key=self._victim_key)
            self._preempt(victim)

    def _preempt(self, req: _Request):
        """Recompute preemption: free the victim's blocks and requeue it
        (front) with prompt = original + generated; the replay prefill
        regenerates its KV and its NEXT token."""
        if req in self._active:
            self._active.remove(req)
        else:
            self._prefilling.remove(req)
        self._alloc.free(req.blocks)   # reuse allocator: decref; a
        req.blocks = []                # shared prefix survives for the
        req.prefill_pos = 0            # replay to hit again
        req.draft_pos = 0
        req.n_reused = 0
        req.hashes = None
        req.prompt = np.concatenate(
            [req.prompt[:req.prompt_len0],
             np.asarray(req.generated, np.int32)])
        req.enqueued_at = time.monotonic()
        with self._cv:
            self._waiting.appendleft(req)
            QUEUE_DEPTH.set(len(self._waiting))
            self._counts["preempted"] += 1
        PREEMPTIONS.inc()
        extra = {"trace_id": req.tctx.trace_id} \
            if req.tctx is not None and req.tctx.sampled else {}
        _events.emit("decode", action="preempt", rid=req.rid,
                     generated=len(req.generated), tenant=req.tenant,
                     **extra)
        _tracing.record_trace_span(
            "decode.preempt", req.tctx, 0.0, cat="decode", rid=req.rid,
            generated=len(req.generated))
        self._kv_gauges()

    def _snapshot(self, C: int) -> Tuple[Tuple[int, ...],
                                         List[Optional[_Request]]]:
        slots: List[Optional[_Request]] = list(self._active[:C])
        while len(slots) < C:
            slots.append(None)
        return tuple(r.rid if r else -1 for r in slots), slots

    def _dispatch(self, ids_arg, C: int) -> _Pending:
        """Launch one decode step at slot count C: a replay of its
        captured graph when warmup captured one, else the eager step.
        `ids_arg` is a host array or the previous step's tokens on the
        device (possibly this graph's own static output, copied into
        its static ids before the replay)."""
        positions = np.zeros((C,), np.int32)
        bts = np.zeros((C, self.kv_cfg.max_blocks_per_seq), np.int32)
        sig, slots = self._snapshot(C)
        for i, req in enumerate(slots):
            if req is None:
                continue
            positions[i] = req.pos
            bts[i] = build_block_table(req.blocks,
                                       self.kv_cfg.max_blocks_per_seq)
        tok = self._run_phase(("decode", C), ids_arg, positions, bts)
        for req in slots:
            if req is not None:
                req.pos += 1
        STEPS.inc(phase="decode")
        OCCUPANCY.observe(sum(1 for r in slots if r is not None) / C)
        self._last_slot_config = C
        return _Pending(tok, sig, slots)

    def _resolve(self, pending: _Pending) -> None:
        """Consume one in-flight step's tokens: stream them, detect
        finishes, retire (freeing blocks). Tokens for slots that were
        already retired/preempted after dispatch are discarded."""
        t_wait = time.perf_counter()
        ready = pending.fetch.ready()
        toks = pending.fetch.result()
        now = time.perf_counter()
        wall = now - pending.t_dispatch
        STEP_SECONDS.observe(wall)
        # the token fetch's telemetry, as the JAX engine's FetchHandle
        # (site "decode") records it
        _telemetry.record_dispatch_ready("fetch:decode", wall)
        if not ready:
            _telemetry.record_host_blocked("fetch:decode", now - t_wait)
        # live-MFU sample: the slot count's FLOPs over the dispatch to
        # resolve window; the fetch wait is the host-blocked share,
        # occupied slots are the tokens produced
        C = len(pending.slots)
        _perfwatch.record_step(
            "decode", wall, flops=self._flops[("decode", C)],
            tokens=sum(1 for r in pending.slots if r is not None),
            host_blocked=min(now - t_wait, wall),
            device_kind=self._device_kind)
        for i, req in enumerate(pending.slots):
            if req is None or req not in self._active:
                continue
            self._emit_token(req, int(toks[i]), phase="decode")
            reason = self._finished_reason(req)
            if reason:
                self._finish(req, reason)
        return None

    def _on_device(self):
        return torch.cuda.device(self.device) \
            if self.device.type == "cuda" else contextlib.nullcontext()

    def _run(self):
        with torch.inference_mode(), self._on_device():
            (self._loop_sync if self._sync else self._loop)()

    def _loop(self):
        pending: Optional[_Pending] = None
        try:
            while True:
                with self._cv:
                    while not self._closed and not self._waiting \
                            and not self._active and pending is None:
                        self._cv.wait(timeout=0.5)
                    if self._closed:
                        break
                with _profiler.device_step():
                    self._sweep_cancelled()
                    self._admit()
                    if not self._active:
                        if pending is not None:
                            pending = self._resolve(pending)
                        continue
                    pending = self._grow_blocks(pending)
                    if not self._active:  # growth preempted everything
                        continue
                    C = self._slot_config()
                    sig, slots = self._snapshot(C)
                    if pending is not None and pending.snapshot == sig:
                        # steady state: feed the previous step's tokens
                        # back on the DEVICE; the host never touched them
                        ids_arg = pending.tok_dev
                    else:
                        if pending is not None:
                            pending = self._resolve(pending)
                            self._admit()  # retirements freed slots
                            # a request admitted HERE whose prompt length
                            # is an exact block multiple needs its next
                            # block before this dispatch, or its first
                            # decode write lands in the null block
                            self._grow_blocks(None)
                            if not self._active:
                                continue
                            C = self._slot_config()
                            sig, slots = self._snapshot(C)
                        ids_arg = np.zeros((C,), np.int32)
                        for i, req in enumerate(slots):
                            if req is not None:
                                ids_arg[i] = req.last_token
                    new_pending = self._dispatch(ids_arg, C)
                    if pending is not None:
                        # overlap: resolve step N-1 while step N runs
                        pending = self._resolve(pending)
                    pending = new_pending
        except BaseException as e:  # scheduler death must not hang clients
            with self._cv:
                reqs = list(self._active) + list(self._waiting)
                self._waiting.clear()
            for req in reqs:
                req.error = RuntimeError(
                    f"decode scheduler failed: {type(e).__name__}: {e}")
                req.error.__cause__ = e
                self._finish(req, "error")
            raise
        finally:
            if pending is not None:
                try:
                    with _profiler.device_step():
                        self._resolve(pending)
                except Exception:  # lint-exempt:swallow: shutdown path; clients are cancelled below
                    pass
            with self._cv:
                reqs = list(self._active) + list(self._waiting)
                self._waiting.clear()
                QUEUE_DEPTH.set(0)
            for req in reqs:
                self._finish(req, "cancelled")

    # -- KV-reuse scheduler (chunked prefill / prefix cache / spec) ----
    #
    # Any reuse feature runs THIS loop instead of _loop: synchronous
    # rounds (each reads its tokens on the host before the next
    # dispatch), trading the one-step-late resolve for mid-prompt
    # admission (one prompt chunk between decode rounds) and for
    # multi-token speculation rounds.

    def _reserve_chunked(self, req: _Request) -> bool:
        """Reserve the full block span for a prompt before chunking
        starts: prefix-cache hits splice cached blocks into the front
        of the table (skipping their recompute entirely), fresh blocks
        cover the rest. All-or-nothing: on a pool shortfall the hits
        are released (decref) and the request stays queued. Caller
        holds self._cv."""
        plen = len(req.prompt)
        bs = self.kv_cfg.block_size
        need = -(-plen // bs)
        reused: List[int] = []
        req.hashes = None
        if self.config.prefix_cache:
            req.hashes = _kvr.hash_blocks(req.prompt, bs)
            # block j is shareable iff (j+1)*bs <= plen-1: the computed
            # suffix keeps >= 1 prompt token, so the chunk phase always
            # produces the first-token logits
            usable = [h for j, h in enumerate(req.hashes)
                      if (j + 1) * bs <= plen - 1]
            reused = self._alloc.match_prefix(usable)
        if not self._alloc.can_alloc(need - len(reused)):
            if reused:
                self._alloc.free(reused)
            return False
        req.blocks = list(reused) + self._alloc.alloc(need - len(reused))
        req.n_reused = len(reused)
        req.prefill_pos = len(reused) * bs
        return True

    def _admit_sync(self):
        """Admission for the sync loop: chunked prompts reserve their
        block span and join the prefilling stage (their compute spreads
        over later iterations); without chunking (spec-only engines)
        the whole-prompt prefill runs here as in _admit."""
        max_slots = self.decode_slots[-1]
        while True:
            chunked = False
            with self._cv:
                if not self._waiting or self._closed:
                    return
                if self.config.static_batching and \
                        (self._active or self._prefilling):
                    return
                if len(self._active) + len(self._prefilling) \
                        >= max_slots:
                    return
                idx = self._pick_waiting_locked()
                req = self._waiting[idx]
                if self.prefill_chunk:
                    if not self._reserve_chunked(req):
                        return
                    chunked = True
                else:
                    need = -(-len(req.prompt) // self.kv_cfg.block_size)
                    if not self._alloc.can_alloc(need):
                        return
                del self._waiting[idx]
                QUEUE_DEPTH.set(len(self._waiting))
            if chunked:
                _tracing.record_trace_span(
                    "decode.queue_wait", req.tctx,
                    time.monotonic() - req.enqueued_at, cat="decode",
                    rid=req.rid, tenant=req.tenant)
                if self._wfq is not None:
                    self._wfq.charge(req.tenant, len(req.prompt))
                req.admitted_at = time.monotonic()
                self._prefilling.append(req)
                self._kv_gauges()
            else:
                self._prefill_one(req)

    def _pump_chunk(self):
        """Advance the FRONT prefilling request by one chunk (both
        models when a draft rides along). On the final chunk the
        request's full prompt blocks register in the prefix index, the
        first token emits, and the request joins the decode batch."""
        if not self._prefilling:
            return
        req = self._prefilling[0]
        Ck = self.prefill_chunk
        bs = self.kv_cfg.block_size
        plen = len(req.prompt)
        start = req.prefill_pos
        cid = np.empty((1, Ck), np.int32)
        seg = req.prompt[start:start + Ck]
        cid[0, :len(seg)] = seg
        cid[0, len(seg):] = req.prompt[-1]     # edge-pad (in-distribution)
        bt = build_block_table(req.blocks, self.kv_cfg.max_blocks_per_seq)
        scalars = (np.asarray(start, np.int32), np.asarray(plen, np.int32))
        t0 = time.perf_counter()
        tok = self._run_phase(("chunk", Ck), cid, *scalars, bt)
        STEPS.inc(phase="prefill")
        if self._draft is not None:
            self._run_phase(("draft_chunk", Ck), cid, *scalars, bt)
            STEPS.inc(phase="draft")
        req.prefill_pos = start + Ck
        done = req.prefill_pos >= plen
        _perfwatch.record_step(
            "prefill", time.perf_counter() - t0,
            flops=self._flops[("chunk", Ck)], tokens=1 if done else 0,
            device_kind=self._device_kind)
        if not done:
            return
        tok0 = int(tok[0])                     # end-of-prefill sync
        if self.config.prefix_cache and req.hashes:
            # contents are final: full prompt blocks are never written
            # again (decode/verify writes land at positions >= plen)
            for j, h in enumerate(req.hashes):
                if (j + 1) * bs <= plen - 1:
                    self._alloc.register(req.blocks[j], h)
        _tracing.record_trace_span(
            "decode.prefill", req.tctx,
            time.monotonic() - req.admitted_at, cat="decode",
            rid=req.rid, chunk=int(Ck), prompt_len=plen,
            reused_blocks=req.n_reused)
        req.pos = plen
        req.draft_pos = plen
        self._prefilling.popleft()
        self._active.append(req)
        self._emit_token(req, tok0, phase="prefill")
        reason = self._finished_reason(req)
        if reason:
            self._finish(req, reason)
        self._kv_gauges()

    def _cow_guard(self, req: _Request, lo: int, hi: int):
        """Copy-on-write safety net: any SHARED block among req's block
        indices [lo, hi] (the imminent write span) is replaced by a
        private copy before the write. Unreachable in the normal flow
        (shared blocks lie strictly inside the prompt prefix, writes
        land at positions >= prompt length), but a forced share must
        not let one sequence corrupt another's prefix. The rows are
        copied in place in both models' pools (captured phases hold
        the pools' addresses) and only the host block table changes."""
        if not self.config.prefix_cache:
            return
        for bi in range(lo, min(hi, len(req.blocks) - 1) + 1):
            blk = req.blocks[bi]
            if not self._alloc.is_shared(blk):
                continue
            new = self._alloc.cow_alloc(blk)
            for pools in (self._pools, self._draft_pools):
                for pool in pools or ():
                    pool[:, new].copy_(pool[:, blk])
            req.blocks[bi] = new

    def _grow_blocks_sync(self, span: int):
        """Every active slot owns (privately) the blocks its next
        `span` KV writes land in. On pool exhaustion the youngest
        admitted sequence (active or still prefilling; lowest tier
        first under QoS) is preempted until the round fits."""
        bs = self.kv_cfg.block_size
        while True:
            short = None
            try:
                for req in self._active:
                    lo = req.pos // bs
                    hi = (req.pos + span - 1) // bs
                    while hi >= len(req.blocks):
                        req.blocks.extend(self._alloc.alloc(1))
                    self._cow_guard(req, lo, hi)
            except NoBlocksError:
                short = req
            if short is None:
                return
            candidates = list(self._active) + list(self._prefilling)
            victim = max(candidates, key=self._victim_key)
            self._preempt(victim)
            if not self._active:
                return

    def _round_inputs(self, C: int, slots):
        """A round's host inputs at slot count C: each slot's last
        token, next write position and block table (empty slots: zero,
        so their writes land in the null block)."""
        ids = np.zeros((C,), np.int32)
        positions = np.zeros((C,), np.int32)
        bts = np.zeros((C, self.kv_cfg.max_blocks_per_seq), np.int32)
        for i, req in enumerate(slots):
            if req is None:
                continue
            ids[i] = req.last_token
            positions[i] = req.pos
            bts[i] = build_block_table(req.blocks,
                                       self.kv_cfg.max_blocks_per_seq)
        return ids, positions, bts

    def _step_plain_sync(self):
        """One synchronous decode round: every active slot advances
        one token. With a draft model present (speculation's near-
        max_len fallback) the draft runs the same round in lockstep so
        its KV stays position-aligned for the next spec round."""
        self._grow_blocks_sync(1)
        if not self._active:
            return
        C = self._slot_config()
        sig, slots = self._snapshot(C)
        ids, positions, bts = self._round_inputs(C, slots)
        t0 = time.perf_counter()
        tok = self._run_phase(("decode", C), ids, positions, bts)
        if self._draft is not None:
            self._draft_catch_up()
            self._run_phase(("draft_decode", C), ids, positions, bts)
            STEPS.inc(phase="draft")
        toks = tok.cpu().numpy()               # synchronous resolve
        wall = time.perf_counter() - t0
        STEP_SECONDS.observe(wall)
        STEPS.inc(phase="decode")
        occupied = sum(1 for r in slots if r is not None)
        OCCUPANCY.observe(occupied / C)
        self._last_slot_config = C
        _perfwatch.record_step(
            "decode", wall, flops=self._flops[("decode", C)],
            tokens=occupied, device_kind=self._device_kind)
        for i, req in enumerate(slots):
            if req is None or req not in self._active:
                continue
            req.pos += 1
            if self._draft is not None:
                req.draft_pos = req.pos
            self._emit_token(req, int(toks[i]), phase="decode")
            reason = self._finished_reason(req)
            if reason:
                self._finish(req, reason)

    def _draft_catch_up(self):
        """After a fully accepted spec round the draft's KV trails the
        target by EXACTLY one position (the round's bonus token never
        passed through the draft). One batched draft step feeds each
        lagging slot the token AT its missing position; the other
        slots ride along with all-zero block tables, so their writes
        land in the null block."""
        if not any(r.draft_pos < r.pos for r in self._active):
            return
        C = self._slot_config()
        sig, slots = self._snapshot(C)
        ids = np.zeros((C,), np.int32)
        positions = np.zeros((C,), np.int32)
        bts = np.zeros((C, self.kv_cfg.max_blocks_per_seq), np.int32)
        for i, req in enumerate(slots):
            if req is None or req.draft_pos >= req.pos:
                continue
            # the token at position pos-1 is the second-newest emission
            ids[i] = req.generated[-2] if len(req.generated) >= 2 \
                else int(req.prompt[-1])
            positions[i] = req.draft_pos
            bts[i] = build_block_table(req.blocks,
                                       self.kv_cfg.max_blocks_per_seq)
        self._run_phase(("draft_decode", C), ids, positions, bts)
        STEPS.inc(phase="draft")
        for req in slots:
            if req is not None and req.draft_pos < req.pos:
                req.draft_pos += 1

    def _step_spec(self):
        """One speculation round: k chained draft proposals, one batched
        target verification, the exact greedy accept rule; the emitted
        stream equals plain decode's, at up to k+1 tokens per target
        step. A slot too close to max_len for the k+1-token span demotes
        the WHOLE round to the plain path (the batch runs one phase per
        round)."""
        k = self.spec_k
        if any(r.pos + k > self.kv_cfg.max_len - 1
               for r in self._active):
            self._step_plain_sync()
            return
        self._grow_blocks_sync(k + 1)
        if not self._active:
            return
        self._draft_catch_up()
        C = self._slot_config()
        sig, slots = self._snapshot(C)
        ids, positions, bts = self._round_inputs(C, slots)
        t0 = time.perf_counter()
        # one sync: the proposals and the verification outputs
        both = self._spec_launch(C, ids, positions, bts).cpu().numpy()
        STEPS.inc(k, phase="draft")
        STEPS.inc(phase="verify")
        props, outs = both[:, :k], both[:, k:]
        wall = time.perf_counter() - t0
        STEP_SECONDS.observe(wall)
        OCCUPANCY.observe(sum(1 for r in slots if r is not None) / C)
        self._last_slot_config = C
        emitted = 0
        for i, req in enumerate(slots):
            if req is None or req not in self._active:
                continue
            row = [int(x) for x in outs[i]]
            a = _kvr.accept_length(props[i], row)
            self._spec_proposed += k
            self._spec_accepted += a
            pos0 = req.pos
            remaining = req.max_new - len(req.generated)
            emit = []
            for t in row[:min(a + 1, remaining)]:
                emit.append(t)
                if t == self.eos_id:
                    break
            req.pos = pos0 + len(emit)
            # a full accept leaves the draft one position behind (the
            # bonus token o_k never passed through it); any rejection
            # lands draft_pos exactly at the new pos
            req.draft_pos = min(pos0 + k, req.pos)
            for t in emit:
                self._emit_token(req, int(t), phase="decode")
            emitted += len(emit)
            reason = self._finished_reason(req)
            if reason:
                self._finish(req, reason)
        if self._spec_proposed:
            _kvr.SPEC_ACCEPT_RATE.set(
                self._spec_accepted / self._spec_proposed)
        _perfwatch.record_step(
            "decode", wall, flops=self._flops[("verify", C)],
            tokens=emitted, device_kind=self._device_kind)

    def _spec_launch(self, C: int, ids: np.ndarray, positions: np.ndarray,
                     bts: np.ndarray) -> torch.Tensor:
        """A speculation round's device work at slot count C, with no
        host sync: k draft steps, then the target's verification.
        Returns [C, 2k+1] int64 on the device: the k proposals, then
        the k+1 verification outputs. The verify window [last_token,
        d_1..d_k] is built on the device: each draft step's tokens are
        COPIED into column j+1 (the next replay overwrites its static
        output) and fed from there to the next step, at positions + j."""
        k = self.spec_k
        ids_v = torch.empty((C, k + 1), dtype=torch.int32,
                            device=self.device)
        ids_v[:, 0].copy_(self._tensor(ids))
        bts_d = self._tensor(bts)
        for j in range(k):
            dtok = self._run_phase(("draft_decode", C), ids_v[:, j],
                                   positions + j, bts_d)
            ids_v[:, j + 1].copy_(dtok)
        vtok = self._run_phase(("verify", C), ids_v, positions, bts_d)
        return torch.cat([ids_v[:, 1:].long(), vtok], dim=1)

    def _loop_sync(self):
        try:
            while True:
                with self._cv:
                    while not self._closed and not self._waiting \
                            and not self._active \
                            and not self._prefilling:
                        self._cv.wait(timeout=0.5)
                    if self._closed:
                        break
                with _profiler.device_step():
                    self._sweep_cancelled()
                    self._admit_sync()
                    self._pump_chunk()             # one slice per iteration
                    if not self._active:
                        continue
                    if self.spec_k:
                        self._step_spec()
                    else:
                        self._step_plain_sync()
        except BaseException as e:  # scheduler death must not hang clients
            with self._cv:
                reqs = (list(self._active) + list(self._prefilling) +
                        list(self._waiting))
                self._waiting.clear()
            for req in reqs:
                req.error = RuntimeError(
                    f"decode scheduler failed: {type(e).__name__}: {e}")
                req.error.__cause__ = e
                self._finish(req, "error")
            raise
        finally:
            with self._cv:
                reqs = (list(self._active) + list(self._prefilling) +
                        list(self._waiting))
                self._waiting.clear()
                QUEUE_DEPTH.set(0)
            for req in reqs:
                self._finish(req, "cancelled")
