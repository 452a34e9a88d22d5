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
- one-step-late token resolve: step N is dispatched with step N-1's
  tokens still on the device, and step N-1's tokens reach the host
  through a non-blocking copy into pinned memory plus a CUDA event,
  read while step N runs;
- recompute preemption when the pool runs dry: the youngest sequence
  frees its blocks and is re-queued with prompt + generated tokens;
  tokens already streamed are not re-emitted.

Sampling is greedy through ops.beam.beam_search with beam_size=1,
whose finished-freeze keeps an ended slot emitting eos.

Not ported yet: warmstart artifacts, QoS, KV reuse (chunked prefill,
prefix cache), speculative decoding and its draft model, boot
validation, perfwatch and memwatch, and the metrics/tracing hooks.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core import precision as _precision
from .batcher import QueueFullError, ServerClosed
from .kv_cache import (BlockAllocator, KVCacheConfig, NoBlocksError,
                       build_block_table, init_pools)

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeHandle"]


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
    an EMPTY batch (the drain-between-batches baseline)."""

    def __init__(self, *, block_size: int = 16, num_blocks: int = 64,
                 decode_slots: Sequence[int] = (4, 8),
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_len: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 max_queue: int = 64,
                 precision: str = "bf16",
                 static_batching: bool = False):
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
                 "admitted_at")

    def __init__(self, rid: int, prompt: np.ndarray, max_new: int):
        self.rid = rid
        self.prompt = prompt                   # grows on preempt-replay
        self.prompt_len0 = len(prompt)         # original, for reporting
        self.max_new = int(max_new)
        self.generated: List[int] = []
        self.events: "queue.Queue" = queue.Queue()
        self.t_submit = time.monotonic()
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

    __slots__ = ("fetch", "tok_dev", "snapshot", "slots")

    def __init__(self, tok_dev, snapshot, slots):
        self.fetch = _TokenFetch(tok_dev)
        self.tok_dev = tok_dev
        self.snapshot = snapshot               # tuple of rids (padded -1)
        self.slots = slots                     # list of Optional[_Request]


class DecodeEngine:
    """Continuous-batching token generation over a paged KV cache.

    Built from in-memory model state: `params` (the flat dict of
    `models.gpt`, dense configs only) and `model_cfg`. The params are
    cast to the precision's dtype and moved to `device` (cuda unless
    the caller passes device="cpu"). `submit()` is thread-safe and
    reject-not-block (QueueFullError when `max_queue` prompts wait);
    one scheduler thread owns the device pools, the allocator, and
    every phase call."""

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

    # -- public API ----------------------------------------------------

    def start(self):
        """Start the scheduler thread (idempotent; submit() calls it)."""
        with self._cv:
            if self._thread is not None or self._closed:
                return
            self._thread = threading.Thread(
                target=self._run, name="paddle-tpu-torch-decode",
                daemon=True)
            self._thread.start()

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
            self._draining = True
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
        for req in stranded:
            self._finish(req, "cancelled")
        if t is not None:
            t.join(timeout=30.0)

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
            "kv": self._alloc.stats(live_tokens=live_tokens),
            "requests": counts,
        }

    # -- scheduler internals (single thread owns everything below) -----

    def _count(self, outcome: str):
        with self._cv:
            self._counts[outcome] = self._counts.get(outcome, 0) + 1

    def _emit_token(self, req: _Request, tok: int):
        req.last_token = int(tok)
        req.generated.append(int(tok))
        if req.t_first is None:
            req.t_first = time.monotonic()
        req.events.put(int(tok))

    def _finished_reason(self, req: _Request) -> Optional[str]:
        if req.generated and req.generated[-1] == self.eos_id:
            return "eos"
        if len(req.generated) >= req.max_new:
            return "length"
        return None

    def _finish(self, req: _Request, reason: str):
        req.finish_reason = reason
        if req.blocks:
            self._alloc.free(req.blocks)
            req.blocks = []
        if req in self._active:
            self._active.remove(req)
        self._count(reason)
        req.events.put(None)

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
            self._prefill_one(req)
            changed = True
        return changed

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On CUDA the copy goes
        through pinned memory and does not wait for the stream, so
        building a step's inputs never blocks on the step before."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _prefill_one(self, req: _Request):
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
        tok = self._gpt.apply_prefill(
            self.params, self.model_cfg, self._tensor(ids), plen, kp, vp,
            self._tensor(bt), block_size=self.kv_cfg.block_size,
            eos_id=self.eos_id)
        tok0 = int(tok[0])                     # admission-boundary sync
        req.pos = plen
        req.admitted_at = time.monotonic()
        self._active.append(req)
        self._emit_token(req, tok0)
        reason = self._finished_reason(req)
        if reason:
            self._finish(req, reason)

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
        with self._cv:
            self._waiting.appendleft(req)
        self._count("preempted")

    def _snapshot(self, C: int) -> Tuple[Tuple[int, ...],
                                         List[Optional[_Request]]]:
        slots: List[Optional[_Request]] = list(self._active[:C])
        while len(slots) < C:
            slots.append(None)
        return tuple(r.rid if r else -1 for r in slots), slots

    def _dispatch(self, ids_arg, C: int) -> _Pending:
        kp, vp = self._pools
        positions = np.zeros((C,), np.int32)
        bts = np.zeros((C, self.kv_cfg.max_blocks_per_seq), np.int32)
        sig, slots = self._snapshot(C)
        for i, req in enumerate(slots):
            if req is None:
                continue
            positions[i] = req.pos
            bts[i] = build_block_table(req.blocks,
                                       self.kv_cfg.max_blocks_per_seq)
        if isinstance(ids_arg, np.ndarray):
            ids_arg = self._tensor(ids_arg)
        tok = self._gpt.apply_decode_step(
            self.params, self.model_cfg, ids_arg, self._tensor(positions),
            kp, vp, self._tensor(bts), block_size=self.kv_cfg.block_size,
            eos_id=self.eos_id)
        for req in slots:
            if req is not None:
                req.pos += 1
        self._last_slot_config = C
        return _Pending(tok, sig, slots)

    def _resolve(self, pending: _Pending) -> None:
        """Consume one in-flight step's tokens: stream them, detect
        finishes, retire (freeing blocks). Tokens for slots that were
        already retired/preempted after dispatch are discarded."""
        toks = pending.fetch.result()
        for i, req in enumerate(pending.slots):
            if req is None or req not in self._active:
                continue
            self._emit_token(req, int(toks[i]))
            reason = self._finished_reason(req)
            if reason:
                self._finish(req, reason)
        return None

    def _run(self):
        with torch.inference_mode():
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    self._loop()
            else:
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
            for req in reqs:
                self._finish(req, "cancelled")
