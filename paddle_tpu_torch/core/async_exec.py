"""Host-overlap primitives: the JAX package's `core/async_exec.py` on
torch. Lazy fetches, bounded in-flight windows, and background prefetch
stages.

`FetchHandle` holds values a step left on the device and reads them on
the host only at `result()`. On CUDA it records an event on the current
stream when it is made (after the step's launches), and `result()`
waits on it, then reads each value with `.item()` (the loop's losses)
or, made with `numpy=True` (the executor's fetches), as a numpy array.
A value on the CPU is ready at once. The handle drops its device
references when it resolves, so a resolved handle holds no device
memory. `map(fn)` is a handle whose result is `fn` of this one's (the
Predictor's bucket slicing). `inflight_stats()` counts the handles not
yet resolved. `run_stream` stamps a window's handle with `start_step`
and `n_steps`.

`InFlightWindow` bounds the unresolved handles: admitting past its
limit resolves the oldest first, so a producer running ahead never
holds more than `limit` windows of fetch buffers on the device.

`Prefetcher` is a bounded background stage over any iterator: a daemon
thread pulls from the source, applies `transfer`, and parks the results
in a queue of `depth` slots. A producer's error re-raises in the
consumer where it iterates; `close()` (also on exhaustion and on a
`with` exit) stops the thread, drains the queue and joins.

`DevicePrefetcher` is a Prefetcher whose transfer puts each batch on a
device ahead of the step that reads it (the JAX package's
`jax.device_put`, which is asynchronous and ordered for free). On CUDA
the producer thread makes the device current first, copies each array
from pinned host memory with `non_blocking=True` on a side stream of
its own and records an event there. The consumer's thread, when it
takes the batch, makes its current stream wait on that event and
`record_stream`s each tensor on it, so the caching allocator reuses
neither the device tensor nor (through the pinned-host allocator's own
event) the host buffer before the consumer's work on it is done.

`train_loop` keeps at most `fetch_window` (default `DEFAULT_IN_FLIGHT`)
handles outstanding, so the host enqueues step N+1 while the device
still runs step N. The mixed precision policies read `finite` on the
host once a step (`parallel/train.py`, to skip the optimizer), which
already waits for the step: under them the window overlaps nothing.

The telemetry is the JAX package's: `paddle_tpu_async_inflight_
fetches` follows the open handles, a resolve records its
dispatch-to-ready latency (`paddle_tpu_dispatch_ready_seconds{site=
"fetch:<site>"}`) and, when the event was not yet done, the host's wait
(`paddle_tpu_host_blocked_seconds_total`); a prefetch stage records its
items and queue depth (`record_prefetch_item`,
`record_prefetch_depth`) and, when the consumer outran it, the
consumer's wait (`record_host_blocked("prefetch:<stage>")`).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, List, Optional

from ..observability import telemetry as _telemetry

__all__ = ["FetchHandle", "MappedHandle", "InFlightWindow", "Prefetcher",
           "DevicePrefetcher", "mesh_device_put", "inflight_stats",
           "reset_inflight_stats", "DEFAULT_IN_FLIGHT",
           "device_prefetch_wanted", "stream_window_default"]

# Two in flight: one step computing on the device while the host reads
# the loss of the one before, the JAX package's double buffer.
DEFAULT_IN_FLIGHT = 2

_acct_lock = threading.Lock()
_open_handles = 0
_open_high_water = 0


def inflight_stats() -> dict:
    """{open, high_water}: handles not yet resolved, and the most open
    at once since `reset_inflight_stats()`."""
    with _acct_lock:
        return {"open": _open_handles, "high_water": _open_high_water}


def reset_inflight_stats():
    global _open_high_water
    with _acct_lock:
        _open_high_water = _open_handles


def to_numpy(v):
    """A host numpy copy of `v` (a tensor, bfloat16 read as float32, or
    anything numpy takes)."""
    import numpy as np
    import torch

    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(v)


def _is_cuda(v) -> bool:
    return getattr(getattr(v, "device", None), "type", None) == "cuda"


class FetchHandle:
    """A lazy fetch of `values` (tensors or host scalars); see the
    module docstring."""

    __slots__ = ("_values", "_result", "_event", "_lock", "_numpy",
                 "_site", "_dispatch_t", "n_steps", "start_step")

    def __init__(self, values: Iterable[Any], numpy: bool = False,
                 site: str = "executor"):
        global _open_handles, _open_high_water
        self._values: List[Any] = list(values)
        self._numpy = numpy
        self._site = site
        self._dispatch_t = time.perf_counter()
        self._result: List[Any] = []
        self._lock = threading.Lock()
        self._event = None
        # run_stream stamps these, so a driver maps a window's handle to
        # its global steps
        self.n_steps: Optional[int] = None
        self.start_step: Optional[int] = None
        dev = next((v.device for v in self._values if _is_cuda(v)), None)
        if dev is not None:
            import torch

            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        with _acct_lock:
            _open_handles += 1
            _open_high_water = max(_open_high_water, _open_handles)
            n = _open_handles
        _telemetry.record_async_inflight(n)

    def result(self, stall: bool = True) -> List[Any]:
        """Wait for the device, read every value to the host (`.item()`
        for a tensor), drop the device references, and return the list
        (cached). stall=False classifies the wait as the caller's
        normal rhythm: host-blocked time, but no pipeline stall."""
        global _open_handles
        with self._lock:
            if self._values is None:
                return self._result
            t0 = time.perf_counter()
            was_ready = self._event is None or self._event.query()
            if self._event is not None:
                self._event.synchronize()
            if self._numpy:
                self._result = [to_numpy(v) for v in self._values]
            else:
                self._result = [v.item() if hasattr(v, "item") else v
                                for v in self._values]
            self._values = None
            self._event = None
            now = time.perf_counter()
            site = "fetch:" + self._site
            _telemetry.record_dispatch_ready(site, now - self._dispatch_t)
            if not was_ready:
                _telemetry.record_host_blocked(site, now - t0, stall=stall)
        with _acct_lock:
            _open_handles = max(0, _open_handles - 1)
            n = _open_handles
        _telemetry.record_async_inflight(n)
        return self._result

    def map(self, fn: Callable[[Any], Any]) -> "MappedHandle":
        """A lazy handle resolving to fn(self.result())."""
        return MappedHandle(self, fn)

    def ready(self) -> bool:
        """True when resolving would not wait (resolved, or the step's
        event is done)."""
        ev = self._event
        return self._values is None or ev is None or ev.query()

    def raw(self) -> Optional[List[Any]]:
        """The unresolved device values (None once resolved)."""
        with self._lock:
            return None if self._values is None else list(self._values)


class MappedHandle:
    """`FetchHandle.map`'s result: resolves its source, then applies
    `fn` once (cached)."""

    __slots__ = ("_src", "_fn", "_done", "_value")

    def __init__(self, src, fn: Callable[[Any], Any]):
        self._src, self._fn = src, fn
        self._done, self._value = False, None

    def result(self, stall: bool = True):
        if not self._done:
            self._value = self._fn(self._src.result(stall))
            self._done = True
        return self._value

    def map(self, fn: Callable[[Any], Any]) -> "MappedHandle":
        return MappedHandle(self, fn)


class InFlightWindow:
    """Bound on unresolved FetchHandles: admitting past `limit` resolves
    the oldest handle first (waiting until its step finished), so at
    most `limit` windows of fetch buffers are ever on the device. This
    is the backpressure that couples the host's run-ahead to the
    device's progress."""

    def __init__(self, limit: int = DEFAULT_IN_FLIGHT,
                 site: str = "stream"):
        self.limit = max(1, int(limit))
        self.site = site
        self._dq: "deque[FetchHandle]" = deque()
        self.high_water = 0

    def reserve(self):
        """Make room for one more handle: resolve the oldest until at
        most limit-1 remain. Call BEFORE dispatching the next window, so
        the new handle's buffers never coexist with a full window. The
        wait is the window doing its job, not a pipeline stall:
        resolved with stall=False."""
        while len(self._dq) >= self.limit:
            self._dq.popleft().result(stall=False)

    def admit(self, handle: FetchHandle) -> FetchHandle:
        self.reserve()
        self._dq.append(handle)
        if len(self._dq) > self.high_water:
            self.high_water = len(self._dq)
        return handle

    def drain(self):
        """Resolve everything outstanding (end of stream, shutdown)."""
        while self._dq:
            self._dq.popleft().result(stall=False)


# ---------------------------------------------------------------------------
# Prefetch stages
# ---------------------------------------------------------------------------


def _map_arrays(batch, fn):
    """`fn` over the arrays of a feed batch: a dict (the feeds), list or
    tuple of arrays, or one array."""
    if isinstance(batch, dict):
        return {k: _map_arrays(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_arrays(v, fn) for v in batch)
    return fn(batch)


class _DeviceBatch:
    """A batch the producer put on the device, with the event its copies
    end at and the pinned host buffers they read."""

    __slots__ = ("batch", "event", "host", "device")

    def __init__(self, batch, event, host, device):
        self.batch, self.event, self.host = batch, event, host
        self.device = device


class _ToDevice:
    """The transfer stage of a DevicePrefetcher: runs on the producer
    thread, see the module docstring."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self._stream = None

    def __call__(self, batch):
        import numpy as np
        import torch

        if self.device.type != "cuda":
            return _map_arrays(batch, lambda a: torch.as_tensor(
                np.asarray(a) if not isinstance(a, torch.Tensor) else a
            ).to(self.device))
        if self._stream is None:
            # this thread's first CUDA work: make the device current, or
            # its streams and copies would land on device 0
            torch.cuda.set_device(self.device)
            self._stream = torch.cuda.Stream(self.device)
        host = []

        def put(a):
            if isinstance(a, torch.Tensor) and a.device == self.device:
                return a
            t = torch.as_tensor(a if isinstance(a, torch.Tensor)
                                else np.ascontiguousarray(a))
            if not t.is_pinned():
                t = t.pin_memory()
            host.append(t)
            return t.to(self.device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            out = _map_arrays(batch, put)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _DeviceBatch(out, event, host, self.device)


def _receive(item):
    """Consumer side of a CUDA put: the current stream waits for the
    copies, and each tensor is marked used on it."""
    if not isinstance(item, _DeviceBatch):
        return item
    import torch

    stream = torch.cuda.current_stream(item.device)
    stream.wait_event(item.event)

    def mark(t):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(stream)
        return t

    return _map_arrays(item.batch, mark)


def _put_device(mesh, device):
    """The device a put goes to: the mesh's (the active one under
    `mesh_guard` when `mesh` is None), else `device` (default cuda,
    which raises on a machine without one)."""
    from .. import resolve_device

    if mesh is None:
        from ..parallel.mesh import current_mesh

        mesh = current_mesh()
    return mesh.devices[0] if mesh is not None else resolve_device(device)


def mesh_device_put(batch, mesh=None, axis: Optional[str] = None,
                    device=None):
    """Put a feed batch (dict, list or tuple of arrays) on the device
    ahead of the step that reads it, synchronously on the caller's
    thread. The JAX package splits the leading dim over the mesh's data
    axis here; the port's meshes are in-process ranks on one device
    whose lockstep runtime splits the rows itself, so the batch goes up
    whole, to the mesh's device (the active one under `mesh_guard` when
    `mesh` is None), or to `device` (default cuda) without a mesh.
    `axis` is accepted for the JAX package's signature."""
    del axis
    import torch

    dev = _put_device(mesh, device)

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        import numpy as np

        return torch.as_tensor(np.asarray(a), device=dev)

    return _map_arrays(batch, put)


class Prefetcher:
    """Bounded background stage over an iterator: a daemon thread pulls
    from `src`, applies `transfer`, and parks results in a queue of
    `depth` slots; iteration consumes them.

    Lifecycle contract:
      - an exception in `src` or `transfer` is re-raised to the
        consumer at the point of iteration, not swallowed;
      - `close()` (also called on exhaustion and on a `with` exit)
        signals the thread, drains the queue so a blocked put unblocks,
        and joins: no leaked thread when the consumer exits early.
    """

    _DONE = "done"
    _ITEM = "item"
    _ERROR = "error"

    def __init__(self, src: Iterable, depth: int = 2,
                 transfer: Optional[Callable[[Any], Any]] = None,
                 stage: str = "host"):
        self._src = src
        self._transfer = transfer
        self._stage = stage
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._exhausted = False
        self._thread = threading.Thread(
            target=self._produce, daemon=True,
            name=f"paddle-tpu-prefetch-{stage}")
        self._thread.start()

    # -- producer side -------------------------------------------------

    def _put(self, msg) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            for item in self._src:
                if self._stop.is_set():
                    return
                if self._transfer is not None:
                    item = self._transfer(item)
                if not self._put((self._ITEM, item)):
                    return
                _telemetry.record_prefetch_item(self._stage)
                _telemetry.record_prefetch_depth(self._stage,
                                                 self._q.qsize())
        except BaseException as e:  # propagate, never swallow
            self._put((self._ERROR, e))
        else:
            self._put((self._DONE, None))

    # -- consumer side -------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        empty = self._q.empty()
        t0 = time.perf_counter()
        kind, val = self._q.get()
        if empty:
            # the consumer outran the producer: input-bound time
            _telemetry.record_host_blocked(
                "prefetch:" + self._stage, time.perf_counter() - t0)
        _telemetry.record_prefetch_depth(self._stage, self._q.qsize())
        if kind == self._ITEM:
            return _receive(val)
        self._exhausted = True
        self.close()
        if kind == self._ERROR:
            raise val
        raise StopIteration

    def close(self):
        """Idempotent shutdown: stop the producer, unblock it, join."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    @property
    def thread(self) -> threading.Thread:
        return self._thread

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()


def DevicePrefetcher(src: Iterable, depth: int = 2, mesh=None,
                     axis: Optional[str] = None, device=None) -> Prefetcher:
    """Prefetcher whose transfer stage puts each batch on the device
    (the mesh's, under an active or given mesh, whole: see
    `mesh_device_put`; else `device`, default cuda, which raises on a
    machine without one): while step N computes, batch N+1 is already
    on the device and batch N+2 is being produced by whatever host
    stage feeds this one."""
    del axis
    return Prefetcher(src, depth=depth,
                      transfer=_ToDevice(_put_device(mesh, device)),
                      stage="device")


def device_prefetch_wanted(places, double_buffer: bool) -> bool:
    """One gate for every loader: prefetch to the DEVICE only where a
    transfer exists to hide. PADDLE_TPU_DEVICE_PREFETCH=1|0 overrides
    unconditionally (even against double_buffer=False); otherwise the
    double-buffer flag must be on AND `places` must include one that is
    not a CPUPlace: CPU places keep yielding mutable numpy, since the
    put stage there is pure overhead."""
    raw = os.environ.get("PADDLE_TPU_DEVICE_PREFETCH")
    if raw is not None and raw.strip() in ("0", "1"):
        return raw.strip() == "1"
    if not double_buffer or places is None:
        return False
    from .places import CPUPlace

    if not isinstance(places, (list, tuple)):
        places = [places]  # the fluid API accepts a bare place
    return any(not isinstance(p, CPUPlace) for p in places)


def prefetch_device(places):
    """The device a loader's DevicePrefetcher puts batches on: that of
    the first CUDA place in `places`, else of the first place (the CPU
    under a PADDLE_TPU_DEVICE_PREFETCH=1 override with CPU places), and
    cuda with no places (raising on a machine without a GPU)."""
    from .. import resolve_device

    if places is None:
        return resolve_device(None)
    if not isinstance(places, (list, tuple)):
        places = [places]
    devs = [p.torch_device() for p in places]
    return next((d for d in devs if d.type == "cuda"),
                devs[0] if devs else resolve_device(None))


def stream_window_default() -> int:
    """Window size for the streaming drivers (PADDLE_TPU_STREAM_WINDOW,
    default 8): steps run per dispatch. 1 disables streaming."""
    raw = os.environ.get("PADDLE_TPU_STREAM_WINDOW")
    if not raw:
        return 8
    try:
        return max(1, int(raw))
    except ValueError:
        return 8
