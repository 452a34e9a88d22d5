# Ported from the JAX package: paddle_tpu/observability/memwatch.py
# (stdlib; torch read from sys.modules). See the docstring for what differs.
"""Owner-tagged device-memory accounting + OOM forensics, on the CUDA
caching allocator.

The JAX package attributes a rate-limited `jax.live_arrays()` walk to
registered owners. torch has no live-array list, so the port sums the
owners' tensors instead:

  - the decode engine registers its KV pools and params
    (serving/decode.py), live train states register params/optimizer
    state (parallel/train.py) — registration is a PROVIDER callable
    returning the owner's CURRENT tensors, so tensors replaced later
    stay correctly attributed;
  - each owner's bytes are its tensors' storages, each storage counted
    once (by `untyped_storage().data_ptr()`), first registration
    winning on overlap;
  - in a process that initialized CUDA the device is the card: only
    CUDA tensors count, the total is `torch.cuda.memory_allocated()`
    (its buffers the allocator's active blocks), and everything the
    owners do not hold lands in owner="other". In a CPU-only process
    the total is the owners' sum;
  - the executables provider reports the decode engines' CUDA-graph
    pool bytes (serving/decode.py) as `executable_bytes`, where the
    JAX package reports its executables' generated code: inside the
    allocator's total, but outside every owner.

Gauges: paddle_tpu_hbm_bytes{owner} / paddle_tpu_hbm_buffers{owner},
paddle_tpu_hbm_watermark_bytes (high watermark of the live total),
paddle_tpu_executable_bytes, paddle_tpu_hbm_budget_bytes.

Budget: PADDLE_TPU_HBM_BUDGET_BYTES (int; unset = no budget). Crossing
85% logs a warning + `hbm_budget` event (level=warn); crossing 100%
logs an error + event (level=error). Transitions only — a sweep per
step must not spam the log.

OOM forensics: `oom_guard(kind)` / `maybe_handle_oom` wrap the dispatch
paths (the serving engine's bucket run). A `torch.cuda.OutOfMemoryError`
(or a MemoryError) escaping the body turns into a ranked per-owner
report in the log + an `oom` event before re-raising — a post-mortem
instead of a bare stack trace.

Import-light (stdlib at import; torch read from sys.modules in the
sweep). Every definition but the module docstring, `log`, the
`paddle_tpu_hbm_bytes` and `paddle_tpu_executable_bytes` help texts,
`_owned_ids` (here `_owned_storages` and `_device_total`), `sweep` and
`is_oom` is the JAX package's.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from . import events as _events
from . import metrics as _m

__all__ = ["register_provider", "register_bytes_provider",
           "unregister_provider",
           "set_executables_provider", "sweep", "report", "last_report",
           "status_block", "budget_bytes", "watermark_bytes",
           "is_oom", "maybe_handle_oom", "oom_guard", "reset"]

log = logging.getLogger("paddle_tpu_torch.observability.memwatch")

BUDGET_ENV = "PADDLE_TPU_HBM_BUDGET_BYTES"
WARN_FRACTION = 0.85
# sweeps triggered through status endpoints / forced paths still walk
# every live array; keep an internal floor so a tight status-poll loop
# cannot turn the walk into a per-request cost
_MIN_INTERVAL_S = 1.0

HBM_BYTES = _m.gauge(
    "paddle_tpu_hbm_bytes",
    "Live device bytes attributed to their owner (kv_pool | params | "
    "optimizer | other) by the rate-limited sweep of the owners' "
    "tensors against the CUDA allocator's total; owners sum to "
    "paddle_tpu_device_live_bytes",
    labelnames=("owner",))
HBM_BUFFERS = _m.gauge(
    "paddle_tpu_hbm_buffers",
    "Live device-array count per owner", labelnames=("owner",))
HBM_WATERMARK = _m.gauge(
    "paddle_tpu_hbm_watermark_bytes",
    "High watermark of total live device-buffer bytes since process "
    "start (ratchet; never decreases)")
HBM_BUDGET = _m.gauge(
    "paddle_tpu_hbm_budget_bytes",
    "Configured HBM budget (PADDLE_TPU_HBM_BUDGET_BYTES); 0 = no "
    "budget")
EXECUTABLE_BYTES = _m.gauge(
    "paddle_tpu_executable_bytes",
    "Bytes of the caching allocator's segments in the decode engines' "
    "CUDA-graph pools (inside the allocator's total, outside every "
    "owner)")
OOMS = _m.counter(
    "paddle_tpu_oom_total",
    "RESOURCE_EXHAUSTED errors intercepted on a dispatch path, by "
    "dispatch kind — each also dumps a ranked per-owner report and an "
    "`oom` event", labelnames=("kind",))

_lock = threading.Lock()
# insertion-ordered: attribution precedence when providers overlap
_providers: "Dict[int, tuple]" = {}   # handle -> (owner, fn)
# byte-providers: owners whose bytes live INSIDE other owners' arrays
# (e.g. prefix_cache blocks inside the kv_pool buffers) — reported as
# their own row but NOT added to the live-array total
_bytes_providers: "Dict[int, tuple]" = {}   # handle -> (owner, fn)
_next_handle = [0]
_exec_provider: List[Optional[Callable[[], tuple]]] = [None]
_watermark = [0.0]
_budget_state = ["ok"]                # ok | warn | error
_last_sweep_t = [0.0]
_last: List[Optional[Dict[str, Any]]] = [None]

TOP_N = 12


def register_provider(owner: str, fn: Callable[[], Iterable]) -> int:
    """Register a callable returning the owner's CURRENT arrays (called
    at sweep time, so buffers replaced by donation stay attributed).
    Returns a handle for unregister_provider. Providers must be cheap
    and exception-safe is not required — a raising provider is skipped
    for that sweep."""
    with _lock:
        _next_handle[0] += 1
        h = _next_handle[0]
        _providers[h] = (owner, fn)
    return h


def register_bytes_provider(owner: str,
                            fn: Callable[[], tuple]) -> int:
    """Register a callable returning `(bytes, count)` for an owner
    whose footprint is a SLICE of arrays someone else already owns —
    the prefix cache's retained blocks live inside the kv_pool
    buffers. The owner gets its own gauge/report row (like
    executable_bytes it rides ALONGSIDE the live-array total, never
    summed into it). Returns a handle for unregister_provider."""
    with _lock:
        _next_handle[0] += 1
        h = _next_handle[0]
        _bytes_providers[h] = (owner, fn)
    return h


def unregister_provider(handle: int):
    with _lock:
        _providers.pop(handle, None)
        _bytes_providers.pop(handle, None)


def set_executables_provider(fn: Callable[[], tuple]):
    """Install the callable returning (code_bytes_total, n_executables)
    for live compiled executables. Injection (not an import) so this
    module never imports core/executor — which imports IT at load."""
    _exec_provider[0] = fn


def budget_bytes() -> Optional[int]:
    raw = os.environ.get(BUDGET_ENV)
    if not raw:
        return None
    try:
        v = int(float(raw))
    except ValueError:
        return None
    return v if v > 0 else None


def watermark_bytes() -> int:
    return int(_watermark[0])


def reset():
    """Tests: drop providers, watermark and budget state."""
    with _lock:
        _providers.clear()
        _bytes_providers.clear()
    _watermark[0] = 0.0
    _budget_state[0] = "ok"
    _last_sweep_t[0] = 0.0
    _last[0] = None


def _owned_storages(cuda: bool) -> Dict[tuple, tuple]:
    """storage key -> (owner, nbytes, tensor), from every registered
    provider: each storage once (a view shares its base's), the first
    registration winning on overlap. Only CUDA tensors count when
    `cuda`, only CPU tensors otherwise."""
    with _lock:
        provs = list(_providers.values())
    want = "cuda" if cuda else "cpu"
    owned: Dict[tuple, tuple] = {}
    for owner, fn in provs:
        try:
            tensors = list(fn() or ())
        except Exception:  # lint-exempt:swallow: a dead provider (engine stopped mid-sweep) skips one sweep
            continue
        for t in tensors:
            dev = getattr(t, "device", None)
            if dev is None or dev.type != want:
                continue
            st = t.untyped_storage()
            key = (dev.type, dev.index, st.data_ptr())
            if key not in owned:
                owned[key] = (owner, int(st.nbytes()), t)
    return owned


def _device_total() -> Optional[tuple]:
    """(bytes, blocks) the CUDA caching allocator holds allocated over
    every device, or None in a process that has not initialized CUDA."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    nbytes = blocks = 0
    for d in range(torch.cuda.device_count()):
        nbytes += int(torch.cuda.memory_allocated(d))
        blocks += int(torch.cuda.memory_stats(d).get(
            "active.all.current", 0))
    return nbytes, blocks


def sweep(force: bool = False, top: bool = False
          ) -> Optional[Dict[str, Any]]:
    """Sum the owners' tensors by storage, take the allocator's total,
    refresh the gauges and budget state. Rate-limited unless `force`;
    returns the report dict. With `top`, the report carries the TOP_N
    largest owned storages ranked."""
    now = time.monotonic()
    if not force and now - _last_sweep_t[0] < _MIN_INTERVAL_S:
        return _last[0]
    _last_sweep_t[0] = now
    dev = _device_total()
    owned = _owned_storages(cuda=dev is not None)
    owners: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    top_rows: List[Dict[str, Any]] = []
    for owner, nb, t in owned.values():
        owners[owner] = owners.get(owner, 0) + nb
        counts[owner] = counts.get(owner, 0) + 1
        if top:
            top_rows.append({"owner": owner, "nbytes": nb,
                             "shape": list(t.shape),
                             "dtype": str(t.dtype).replace("torch.", "")})
    total, nbufs = sum(owners.values()), len(owned)
    if dev is not None:
        # the allocator holds everything: what no owner holds is other
        owners["other"] = max(0, dev[0] - total)
        counts["other"] = max(0, dev[1] - nbufs)
        total, nbufs = max(dev[0], total), max(dev[1], nbufs)
    # byte-providers: rows whose bytes live inside storages counted
    # above (prefix_cache ⊂ kv_pool) — attributed, never re-totalled
    with _lock:
        bprovs = list(_bytes_providers.values())
    for owner, fn in bprovs:
        try:
            nb, cnt = fn()
        except Exception:  # lint-exempt:swallow: a dead provider (engine stopped mid-sweep) skips one sweep
            continue
        owners[owner] = owners.get(owner, 0) + int(nb)
        counts[owner] = counts.get(owner, 0) + int(cnt)
    exec_bytes = n_exec = 0
    if _exec_provider[0] is not None:
        try:
            exec_bytes, n_exec = _exec_provider[0]()
        except Exception:  # lint-exempt:swallow: executable introspection is optional
            pass
    if total > _watermark[0]:
        _watermark[0] = float(total)
    for owner in set(owners) | {"kv_pool", "params", "optimizer",
                                "other"}:
        HBM_BYTES.set(owners.get(owner, 0), owner=owner)
        HBM_BUFFERS.set(counts.get(owner, 0), owner=owner)
    HBM_WATERMARK.set_max(total)
    EXECUTABLE_BYTES.set(exec_bytes)
    # keep the device totals in lockstep with the attributed sweep
    from . import telemetry as _telemetry

    _telemetry.record_device_memory(total, nbufs)
    budget = budget_bytes()
    HBM_BUDGET.set(budget or 0)
    _check_budget(total, budget)
    rep: Dict[str, Any] = {
        "total_bytes": total, "buffers": nbufs,
        "owners": dict(sorted(owners.items(),
                              key=lambda kv: -kv[1])),
        "watermark_bytes": int(_watermark[0]),
        "budget_bytes": budget,
        "budget_state": _budget_state[0],
        "executable_bytes": int(exec_bytes),
        "executables": int(n_exec),
    }
    if top:
        top_rows.sort(key=lambda r: -r["nbytes"])
        rep["top"] = top_rows[:TOP_N]
    _last[0] = {k: v for k, v in rep.items() if k != "top"}
    return rep


def _check_budget(total: int, budget: Optional[int]):
    if not budget:
        _budget_state[0] = "ok"
        return
    frac = total / budget
    state = "error" if frac >= 1.0 else \
        "warn" if frac >= WARN_FRACTION else "ok"
    prev = _budget_state[0]
    if state == prev:
        return
    _budget_state[0] = state
    if state == "ok":
        return  # recovery: gauge readers see it; no log line needed
    word = "exceeded" if state == "error" else "nearly exhausted"
    msg = (f"HBM budget {word}: {total} live bytes vs budget {budget} "
           f"({frac:.0%})")
    (log.error if state == "error" else log.warning)("%s", msg)
    _events.emit("hbm_budget", level=state, total_bytes=int(total),
                 budget_bytes=int(budget), fraction=round(frac, 4))


def report(top: bool = True) -> Optional[Dict[str, Any]]:
    """Fresh forced sweep with the ranked buffer list."""
    return sweep(force=True, top=top)


def last_report() -> Optional[Dict[str, Any]]:
    return _last[0]


def status_block() -> Dict[str, Any]:
    """The /v1/status `memory` block: per-owner bytes, watermark,
    budget. Sweeps through the internal rate limit, so a status poll
    is a dict copy in the common case and a live walk at most once a
    second."""
    rep = sweep(force=False)
    if rep is None:
        rep = _last[0] or {"total_bytes": 0, "buffers": 0, "owners": {},
                           "watermark_bytes": int(_watermark[0]),
                           "budget_bytes": budget_bytes(),
                           "budget_state": _budget_state[0],
                           "executable_bytes": 0, "executables": 0}
    return dict(rep)


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                "Out of memory", "out of memory", "OOM")


def is_oom(exc: BaseException) -> bool:
    """True for device allocation failures: torch raises
    `torch.cuda.OutOfMemoryError` ("CUDA out of memory"); a host
    MemoryError counts too, and so does any error whose text carries
    one of the markers."""
    if isinstance(exc, MemoryError):
        return True
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    s = f"{type(exc).__name__}: {exc}"
    return any(m in s for m in _OOM_MARKERS)


def _format_report(rep: Dict[str, Any]) -> str:
    lines = [f"  total {rep['total_bytes']} bytes in "
             f"{rep['buffers']} buffers; watermark "
             f"{rep['watermark_bytes']}; budget "
             f"{rep['budget_bytes'] or 'none'}; executables "
             f"{rep['executable_bytes']} bytes"]
    for owner, nb in rep["owners"].items():
        pct = 100.0 * nb / max(1, rep["total_bytes"])
        lines.append(f"  {owner:<12s} {nb:>16d} bytes  {pct:5.1f}%")
    for row in rep.get("top", ()):
        lines.append(f"    {row['owner']:<10s} {row['nbytes']:>14d}  "
                     f"{row['dtype']} {row['shape']}")
    return "\n".join(lines)


def maybe_handle_oom(kind: str, exc: BaseException) -> bool:
    """If `exc` is a device OOM: count it, force an attributed sweep,
    log the ranked per-owner report and emit an `oom` event. The caller
    re-raises either way; returns whether it was handled."""
    if not is_oom(exc):
        return False
    OOMS.inc(kind=kind)
    rep = sweep(force=True, top=True)
    fields: Dict[str, Any] = {"dispatch_kind": kind,
                              "error": str(exc)[:300]}
    if rep is not None:
        log.error("RESOURCE_EXHAUSTED on dispatch kind=%s — live-buffer "
                  "forensics:\n%s", kind, _format_report(rep))
        fields.update(
            total_bytes=rep["total_bytes"], buffers=rep["buffers"],
            owners=rep["owners"],
            watermark_bytes=rep["watermark_bytes"],
            budget_bytes=rep["budget_bytes"],
            top=[{"owner": r["owner"], "nbytes": r["nbytes"],
                  "shape": r["shape"], "dtype": r["dtype"]}
                 for r in rep.get("top", ())[:5]])
    else:
        log.error("RESOURCE_EXHAUSTED on dispatch kind=%s (live-array "
                  "walk unavailable): %s", kind, exc)
    _events.emit("oom", **fields)
    return True


@contextlib.contextmanager
def oom_guard(kind: str):
    """Wrap a dispatch path: a RESOURCE_EXHAUSTED escaping the body is
    dumped as forensics (ranked owner report + `oom` event) and
    re-raised unchanged."""
    try:
        yield
    except BaseException as e:
        maybe_handle_oom(kind, e)
        raise
