"""Lazy fetches: the subset of the JAX package's `core/async_exec.py`
that `parallel.train.train_loop` and `Executor.run(sync=False)` use.

`FetchHandle` holds values a step left on the device and reads them on
the host only at `result()`. On CUDA it records an event on the current
stream when it is made (after the step's launches), and `result()`
waits on it, then reads each value with `.item()` (the loop's losses)
or, made with `numpy=True` (the executor's fetches), as a numpy array.
A value on the CPU
is ready at once. The handle drops its device references when it
resolves, so a resolved handle holds no device memory. `map(fn)` is
a handle whose result is `fn` of this one's (the Predictor's bucket
slicing).
`inflight_stats()` counts the handles not yet resolved.

The fetch telemetry is the JAX package's: `paddle_tpu_async_inflight_
fetches` follows the open handles, and a resolve records its
dispatch-to-ready latency (`paddle_tpu_dispatch_ready_seconds{site=
"fetch:<site>"}`) and, when the event was not yet done, the host's
wait (`paddle_tpu_host_blocked_seconds_total`).

`train_loop` keeps at most `fetch_window` (default `DEFAULT_IN_FLIGHT`)
of them outstanding, so the host enqueues step N+1 while the device
still runs step N. The mixed precision policies read `finite` on the
host once a step (`parallel/train.py`, to skip the optimizer), which
already waits for the step: under them the window overlaps nothing.

Not ported: `InFlightWindow` and `Prefetcher` (ROADMAP item 16).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, List

from ..observability import telemetry as _telemetry

__all__ = ["FetchHandle", "MappedHandle", "inflight_stats",
           "reset_inflight_stats", "DEFAULT_IN_FLIGHT"]

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
                 "_site", "_dispatch_t")

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
