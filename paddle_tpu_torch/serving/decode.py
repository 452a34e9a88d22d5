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
  pays the cold start), and on CUDA each decode slot count's step is
  captured as one CUDA graph, which every later step at that slot count
  replays: the counterpart of the JAX package's one AOT executable per
  (phase, size). An engine never warmed runs every step eagerly.
  `export_warmstart` / `load_warmstart` carry the grid's fingerprints
  between processes (a CUDA graph cannot be serialized);
- one-step-late token resolve: step N is dispatched with step N-1's
  tokens still on the device, and step N-1's tokens reach the host
  through a non-blocking copy into pinned memory plus a CUDA event,
  read while step N runs;
- recompute preemption when the pool runs dry: the youngest sequence
  frees its blocks and is re-queued with prompt + generated tokens;
  tokens already streamed are not re-emitted;
- boot validation: config findings in the analysis Finding shape
  (`paddle_tpu_torch/analysis.py`), PADDLE_TPU_VALIDATE=2 refuses to
  serve a broken grid;
- the JAX package's decode metrics (same names, same update points),
  its `decode` and `warmstart` events and its per-request trace spans.

Sampling is greedy through ops.beam.beam_search with beam_size=1,
whose finished-freeze keeps an ended slot emitting eos.

Not ported yet: QoS and tenants (ROADMAP item 17); KV reuse (chunked
prefill, prefix cache) and speculative decoding with its draft model
(item 11); memwatch, perfwatch and telemetry (item 18).
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import analysis as _an
from .. import resolve_device
from ..core import compile_cache as _cc
from ..core import precision as _precision
from ..kernels import _build
from ..observability import events as _events
from ..observability import metrics as _m
from ..observability import tracing as _tracing
from ..resilience.atomic import write_bytes
from .batcher import QueueFullError, ServerClosed
from .kv_cache import (BlockAllocator, KVCacheConfig, NoBlocksError,
                       build_block_table, init_pools)

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
    (`load_warmstart`)."""

    def __init__(self, *, block_size: int = 16, num_blocks: int = 64,
                 decode_slots: Sequence[int] = (4, 8),
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_len: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 max_queue: int = 64,
                 precision: str = "bf16",
                 static_batching: bool = False,
                 warmstart: Optional[str] = None):
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
                 "admitted_at", "tctx", "enqueued_at")

    def __init__(self, rid: int, prompt: np.ndarray, max_new: int):
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


class _StepGraph:
    """One slot count's decode step captured as a CUDA graph: its static
    inputs (ids int32, positions, block tables), its static output (the
    next tokens, int64) and the pools and params whose addresses the
    graph holds."""

    __slots__ = ("graph", "ids", "positions", "block_tables", "tok",
                 "pools", "params")


class DecodeEngine:
    """Continuous-batching token generation over a paged KV cache.

    Built from in-memory model state: `params` (the flat dict of
    `models.gpt`, dense configs only) and `model_cfg`. The params are
    cast to the precision's dtype and moved to `device` (cuda unless
    the caller passes device="cpu"). `submit()` is thread-safe and
    reject-not-block (QueueFullError when `max_queue` prompts wait);
    one scheduler thread owns the device pools, the allocator, and
    every phase call. `warmup()`, before the scheduler starts, warms
    the phase grid (see the module docstring).

    Construction raises at once where the engine cannot run at all: a
    mixture-of-experts config (the paged decode step has no
    expert-dispatch path) and a max_len beyond the model's positional
    table. Every other config fault is a boot-validation finding
    (`analysis`), raised only at PADDLE_TPU_VALIDATE=2, as in the JAX
    package."""

    def __init__(self, params, model_cfg, config: Optional[DecodeConfig]
                 = None, *, device=None):
        from ..models import gpt as _gpt

        self._gpt = _gpt
        self.device = resolve_device(device)
        self.config = config or DecodeConfig()
        self.model_cfg = model_cfg
        if getattr(model_cfg, "n_experts", 0):
            raise ValueError("MoE decode is unsupported: the paged decode "
                             "step has no expert-dispatch path; serve a "
                             "dense config")
        if self.config.precision not in ("f32", "bf16"):
            raise ValueError(
                f"unsupported decode precision "
                f"{self.config.precision!r}; choose from ['f32', 'bf16']")
        self._compute_dtype = _precision.compute_dtype(self.config.precision)
        self.params = {
            k: _precision.cast_floating(v, self._compute_dtype)
            .to(self.device) for k, v in params.items()}
        max_len = int(self.config.max_len or model_cfg.max_len)
        if max_len > model_cfg.max_len:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"positional table ({model_cfg.max_len})")
        self.kv_cfg = KVCacheConfig(
            layers=model_cfg.layers, kv_heads=model_cfg.heads,
            head_dim=model_cfg.head_dim, max_len=max_len,
            block_size=self.config.block_size,
            num_blocks=self.config.num_blocks,
            dtype=str(self._compute_dtype).replace("torch.", ""))
        self.prefill_buckets = self.config.prefill_buckets \
            if self.config.prefill_buckets is not None \
            else _pow2_lengths(min(8, max_len), max_len)
        self.decode_slots = self.config.decode_slots
        self.eos_id = -1 if self.config.eos_id is None \
            else int(self.config.eos_id)

        self._findings: List[_an.Finding] = []
        self.analysis = self._validate_boot()

        self._pools = init_pools(self.kv_cfg, self.device)
        self._alloc = BlockAllocator(self.kv_cfg)
        # re-entrant: _count takes it from paths that already hold it
        self._cv = threading.Condition(threading.RLock())
        self._waiting: "collections.deque[_Request]" = collections.deque()
        self._active: List[_Request] = []
        self._closed = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._rid = 0
        self._last_slot_config: Optional[int] = None
        self._counts = {k: 0 for k in
                        ("eos", "length", "rejected", "cancelled",
                         "error", "preempted")}
        # the warm phase grid: phases warmed so far, the decode steps
        # captured per slot count (CUDA) sharing one memory pool, and
        # how many decode steps ran as a replay or eagerly
        self.warmed = False
        self.warmstart_adopted = 0
        self._warm: set = set()
        self._warming = False
        self._warm_error: Optional[BaseException] = None
        self._graphs: Dict[int, _StepGraph] = {}
        self._graph_pool = None
        self._steps = {"replayed": 0, "eager": 0}
        self._digest: Optional[str] = None
        SLOTS.set(max(self.decode_slots), state="configured")
        if self.config.warmstart:
            self.load_warmstart(self.config.warmstart)

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
        def add(sev, msg, var=None):
            self._findings.append(_an.Finding(
                severity=sev, pass_name="decode_config", message=msg,
                var=var))

        kv, mc = self.kv_cfg, self.model_cfg
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
        if not (-1 <= self.eos_id < mc.vocab_size):
            add(_an.ERROR,
                f"eos_id {self.eos_id} outside vocab [0, "
                f"{mc.vocab_size})", var="eos_id")
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
        for s in self.decode_slots:
            if s < 1:
                add(_an.ERROR, f"decode slot count {s} < 1",
                    var="decode_slots")
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

    # -- phase grid / warmstart ----------------------------------------

    def _phase_keys(self) -> List[Tuple[str, int]]:
        return [("prefill", t) for t in self.prefill_buckets] + \
            [("decode", s) for s in self.decode_slots]

    def _warm_order(self, keys) -> List[Tuple[str, int]]:
        """Prefill buckets first, then the slot counts largest first:
        the largest capture sizes the shared graph pool, which the
        smaller ones then reuse."""
        return sorted(keys, key=lambda k: (k[0] != "prefill",
                                           -k[1] if k[0] == "decode"
                                           else k[1]))

    def warmup(self) -> int:
        """Warm every phase of the grid; returns how many phases are
        ready. Idempotent: a phase warmed before (by an earlier call or
        from a warmstart artifact) is not run again.

        A prefill bucket T runs once on a [1, T] prompt with an all-zero
        block table, so every write lands in the null block. A decode
        slot count S is, on CUDA, run once eagerly on a side stream and
        then captured as one CUDA graph on static buffers (ids[S],
        positions[S], block_tables[S, MB], all zero); on the CPU it runs
        once eagerly and nothing is captured.

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
            if kind == "prefill":
                ids = torch.zeros((1, n), dtype=torch.int32,
                                  device=self.device)
                bt = torch.zeros((self.kv_cfg.max_blocks_per_seq,),
                                 dtype=torch.int32, device=self.device)
                kp, vp = self._pools
                int(self._gpt.apply_prefill(
                    self.params, self.model_cfg, ids, n, kp, vp, bt,
                    block_size=self.kv_cfg.block_size,
                    eos_id=self.eos_id)[0])
            elif self.device.type == "cuda":
                self._graphs[n] = self._capture_step(n)
            else:
                self._decode_step(*self._step_buffers(n))
        except Exception as e:
            self._warm_error = e
            self._findings.append(_an.Finding(
                severity=_an.ERROR, pass_name="decode_trace",
                message=f"{kind}@{n} fails to warm: "
                        f"{type(e).__name__}: {str(e)[:200]}"))
            self.analysis = self._tally()   # AnalysisError at level 2
            raise
        self._warm.add(key)

    def _step_buffers(self, S: int):
        """All-zero decode inputs for S slots: ids, positions and block
        tables (every write lands in the null block)."""
        mb = self.kv_cfg.max_blocks_per_seq
        return (torch.zeros((S,), dtype=torch.int32, device=self.device),
                torch.zeros((S,), dtype=torch.int32, device=self.device),
                torch.zeros((S, mb), dtype=torch.int32, device=self.device))

    def _decode_step(self, ids, positions, block_tables) -> torch.Tensor:
        kp, vp = self._pools
        return self._gpt.apply_decode_step(
            self.params, self.model_cfg, ids, positions, kp, vp,
            block_tables, block_size=self.kv_cfg.block_size,
            eos_id=self.eos_id)

    def _capture_step(self, S: int) -> _StepGraph:
        """S slots' decode step as a CUDA graph on static buffers. One
        eager run on a side stream first (cuBLAS handles and workspaces,
        allocator blocks); the capture then shares the engine's one
        graph memory pool."""
        g = _StepGraph()
        g.ids, g.positions, g.block_tables = self._step_buffers(S)
        g.pools, g.params = self._pools, self.params
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._decode_step(g.ids, g.positions, g.block_tables)
        cur.wait_stream(side)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph, pool=self._graph_pool):
            g.tok = self._decode_step(g.ids, g.positions, g.block_tables)
        return g

    def _phase_fingerprint(self, key: Tuple[str, int]) -> str:
        """A phase's input shapes and dtypes and the kernel sources it
        launches: what a warmstart entry must match to be adopted."""
        kind, n = key
        kv = self.kv_cfg
        mb = kv.max_blocks_per_seq
        pool = [kv.layers, kv.num_blocks, kv.block_size, kv.kv_heads,
                kv.head_dim]
        if kind == "prefill":
            inputs = [["ids", [1, n], "int32"], ["block_table", [mb],
                                                 "int32"]]
            kernels = ["flash_attention"]    # K1-fwd in mha(causal)
        else:
            inputs = [["ids", [n], "int32"], ["positions", [n], "int32"],
                      ["block_tables", [n, mb], "int32"]]
            kernels = []
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
                           self.config.precision, self.eos_id)).encode())
            for name in sorted(self.params):
                t = self.params[name].detach().contiguous().cpu()
                h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
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
        art = dict(_cc.environment_meta(self.device),
                   format=DECODE_WARMSTART_FORMAT,
                   model_digest=self._model_digest(),
                   grid={"decode": list(self.decode_slots),
                         "prefill": list(self.prefill_buckets)},
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
        Waits for a warmup in progress; raises when a warmup failed."""
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

    def submit(self, prompt_ids, max_new_tokens: int = 16) -> DecodeHandle:
        """Enqueue one generation; returns its token-stream handle.
        Reject-not-block: QueueFullError (HTTP 503) when max_queue
        prompts already wait, ServerClosed after stop() or drain()."""
        prompt = np.asarray(prompt_ids, np.int32).ravel()
        if prompt.size < 1:
            raise ValueError("prompt must carry at least one token id")
        if prompt.size > self.prefill_buckets[-1]:
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
        with self._cv:
            if self._closed:
                self._count("rejected")
                raise ServerClosed("decode engine is stopped")
            if self._draining:
                self._count("rejected")
                raise ServerClosed(
                    "decode engine is draining; request rejected")
            if len(self._waiting) >= self.config.max_queue:
                self._count("rejected")
                raise QueueFullError(
                    f"decode queue full ({self.config.max_queue} "
                    "waiting); request rejected")
            self._rid += 1
            req = _Request(self._rid, prompt, max_new)
            self._waiting.append(req)
            QUEUE_DEPTH.set(len(self._waiting))
            self._cv.notify_all()
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
                                    and not self._active):
                    return True
            time.sleep(0.01)
        with self._cv:
            return not self._waiting and not self._active

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
        _events.emit("decode", action="stop")

    def load(self) -> Tuple[int, int]:
        """(queued, active): the cheap pair the /v1/load probe folds
        into its scalar load score without building the full status
        document."""
        with self._cv:
            return len(self._waiting), len(self._active)

    def status(self) -> Dict:
        with self._cv:
            waiting = len(self._waiting)
            active = len(self._active)
            live_tokens = sum(r.pos for r in self._active)
            counts = dict(self._counts)
            draining = self._draining
        return {
            "draining": draining,
            "device": str(self.device),
            "phase_grid": {"decode_slots": list(self.decode_slots),
                           "prefill_buckets": list(self.prefill_buckets)},
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
            "decode_steps": dict(self._steps),
            "kv": self._alloc.stats(live_tokens=live_tokens),
            "requests": counts,
        }

    # -- scheduler internals (single thread owns everything below) -----

    def _count(self, outcome: str):
        REQUESTS.inc(outcome=outcome)
        with self._cv:
            self._counts[outcome] = self._counts.get(outcome, 0) + 1

    def _emit_token(self, req: _Request, tok: int, phase: str):
        req.last_token = int(tok)
        req.generated.append(int(tok))
        TOKENS.inc(phase=phase)
        if req.t_first is None:
            req.t_first = time.monotonic()
            TTFT_SECONDS.observe(req.t_first - req.t_submit)
            # per-request TTFT span: submit -> first sampled token
            _tracing.record_trace_span(
                "decode.ttft", req.tctx, req.t_first - req.t_submit,
                cat="decode", rid=req.rid, prompt_len=req.prompt_len0)
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
            reason=reason)
        if req.blocks:
            self._alloc.free(req.blocks)
            req.blocks = []
        if req in self._active:
            self._active.remove(req)
        self._count(reason)
        req.events.put(None)
        self._kv_gauges()

    def _kv_gauges(self):
        KV_BLOCKS.set(self._alloc.used_blocks(), state="used")
        KV_BLOCKS.set(self._alloc.free_blocks(), state="free")
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
                req = self._waiting[0]
                need = -(-len(req.prompt) // self.kv_cfg.block_size)
                if not self._alloc.can_alloc(need):
                    break  # blocks scale with live tokens: defer
                self._waiting.popleft()
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
            rid=req.rid)
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
        kp, vp = self._pools
        t0 = time.perf_counter()
        tok = self._gpt.apply_prefill(
            self.params, self.model_cfg, self._tensor(ids), plen, kp, vp,
            self._tensor(bt), block_size=self.kv_cfg.block_size,
            eos_id=self.eos_id)
        tok0 = int(tok[0])                     # admission-boundary sync
        STEPS.inc(phase="prefill")
        _tracing.record_trace_span(
            "decode.prefill", req.tctx, time.perf_counter() - t0,
            cat="decode", t0_perf=t0, rid=req.rid, bucket=int(bucket),
            prompt_len=plen)
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
        active sequence until the step fits."""
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
            victim = max(self._active, key=lambda r: r.admitted_at)
            self._preempt(victim)

    def _preempt(self, req: _Request):
        """Recompute preemption: free the victim's blocks and requeue it
        (front) with prompt = original + generated; the replay prefill
        regenerates its KV and its NEXT token."""
        self._active.remove(req)
        self._alloc.free(req.blocks)
        req.blocks = []
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
                     generated=len(req.generated), **extra)
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
        device."""
        positions = np.zeros((C,), np.int32)
        bts = np.zeros((C, self.kv_cfg.max_blocks_per_seq), np.int32)
        sig, slots = self._snapshot(C)
        for i, req in enumerate(slots):
            if req is None:
                continue
            positions[i] = req.pos
            bts[i] = build_block_table(req.blocks,
                                       self.kv_cfg.max_blocks_per_seq)
        g = self._graphs.get(C)
        if g is not None:
            if g.pools is not self._pools or g.params is not self.params:
                raise RuntimeError(
                    "the KV pools or the params were rebound after "
                    "warmup(); the captured decode steps hold the old "
                    "tensors' addresses")
            # the static ids are int32; the previous step's tokens
            # (possibly this graph's own static output) are int64 and
            # are cast on this device-to-device copy
            g.ids.copy_(self._pinned(ids_arg) if isinstance(
                ids_arg, np.ndarray) else ids_arg, non_blocking=True)
            g.positions.copy_(self._pinned(positions), non_blocking=True)
            g.block_tables.copy_(self._pinned(bts), non_blocking=True)
            g.graph.replay()
            tok = g.tok
            self._steps["replayed"] += 1
        else:
            if isinstance(ids_arg, np.ndarray):
                ids_arg = self._tensor(ids_arg)
            tok = self._decode_step(ids_arg, self._tensor(positions),
                                    self._tensor(bts))
            self._steps["eager"] += 1
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
        toks = pending.fetch.result()
        STEP_SECONDS.observe(time.perf_counter() - pending.t_dispatch)
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
            self._loop()

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
                    self._resolve(pending)
                except Exception:  # lint-exempt:swallow: shutdown path; clients are cancelled below
                    pass
            with self._cv:
                reqs = list(self._active) + list(self._waiting)
                self._waiting.clear()
                QUEUE_DEPTH.set(0)
            for req in reqs:
                self._finish(req, "cancelled")
