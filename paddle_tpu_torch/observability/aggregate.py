# Copied from the JAX package: paddle_tpu/observability/aggregate.py
# (stdlib only). Keep it in step with that file.
"""Cross-process time-series aggregation: read a `PADDLE_TPU_TS_DIR`
written by any number of recorder pids (timeseries.py) and evaluate
windowed expressions over the merged history — `increase()`, `rate()`,
latest-gauge roll-ups, merged histogram tables and bucket quantiles.

Stdlib-only and file-path importable, like tracing's readers: this is
the module `tools/obsdump.py top` loads WITHOUT the framework (and the
jax stack behind it) to render a fleet dashboard from disk. Sibling
modules (metrics.py for the shared `bucket_quantile`) are resolved
through `_sibling()`: the normal relative import inside the package, a
spec_from_file_location fallback when loaded standalone.

Semantics:
  * A window is `now - window_s < ts <= now` over record wall-clock
    stamps; `now` defaults to the newest record in the store (so
    offline analysis of an old dir still has a full window).
  * Counter/histogram samples are per-interval DELTAS (the recorder's
    encoding), so increase() is a plain sum over the window — no
    monotonic-reset heuristics needed here; the writer already handled
    resets.
  * Roll-ups SUM across pids and label sets by default; `labels=` keeps
    only series whose labels contain every given pair, `by=` groups the
    result by one label's values.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = ["read_ts_dir", "TSStore", "bucket_quantile"]


def _sibling(name: str):
    """Import a sibling observability module whether this file was
    imported as part of the package or loaded by file path (obsdump)."""
    if __package__:
        from importlib import import_module

        return import_module(f".{name}", __package__)
    import importlib.util

    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), name + ".py")
    spec = importlib.util.spec_from_file_location(f"_pt_obs_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bucket_quantile = _sibling("metrics").bucket_quantile


def read_ts_dir(directory: str) -> List[dict]:
    """Every record from every `ts-*.jsonl` segment in `directory`,
    sorted by timestamp. Malformed lines (a reader racing a non-atomic
    writer, a truncated copy) are skipped, not fatal."""
    records = []
    for path in sorted(glob.glob(os.path.join(directory, "ts-*.jsonl"))):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "ts" in rec:
                        records.append(rec)
        except OSError:
            continue  # segment deleted by retention mid-scan
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records


def _labels_match(labels: Dict[str, str],
                  want: Optional[Dict[str, str]]) -> bool:
    if not want:
        return True
    return all(str(labels.get(k)) == str(v) for k, v in want.items())


class TSStore:
    """An in-memory merge of one TS dir. Load once, query many — the
    SLO evaluator reloads per tick; obsdump --watch reloads per frame."""

    def __init__(self, records: List[dict]):
        self.records = sorted(records, key=lambda r: r.get("ts", 0.0))

    @classmethod
    def load(cls, directory: str) -> "TSStore":
        return cls(read_ts_dir(directory))

    def latest_ts(self) -> Optional[float]:
        return self.records[-1]["ts"] if self.records else None

    def pids(self) -> List[int]:
        return sorted({int(r.get("pid", 0)) for r in self.records})

    def names(self) -> List[str]:
        out = set()
        for rec in self.records:
            for s in rec.get("samples", ()):
                out.add(s.get("name"))
        return sorted(n for n in out if n)

    def _iter(self, name: str, kind: str, window_s: float,
              now: Optional[float], labels: Optional[Dict[str, str]]):
        if now is None:
            now = self.latest_ts()
        if now is None:
            return
        lo = now - float(window_s)
        for rec in self.records:
            ts = rec.get("ts", 0.0)
            if ts <= lo or ts > now:
                continue
            for s in rec.get("samples", ()):
                if s.get("name") != name or s.get("kind") != kind:
                    continue
                if not _labels_match(s.get("labels", {}), labels):
                    continue
                yield rec, s

    # -- expressions ---------------------------------------------------

    def increase(self, name: str, window_s: float,
                 now: Optional[float] = None,
                 labels: Optional[Dict[str, str]] = None,
                 by: Optional[str] = None):
        """Total counter growth over the window, summed across pids and
        label sets. With `by=<label>`: {label_value: growth}."""
        if by is None:
            return float(sum(
                s.get("delta", 0.0) for _, s in
                self._iter(name, "counter", window_s, now, labels)))
        out: Dict[str, float] = {}
        for _, s in self._iter(name, "counter", window_s, now, labels):
            k = str(s.get("labels", {}).get(by, ""))
            out[k] = out.get(k, 0.0) + float(s.get("delta", 0.0))
        return out

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None,
             labels: Optional[Dict[str, str]] = None,
             by: Optional[str] = None):
        """increase / window — events per second over the window."""
        inc = self.increase(name, window_s, now, labels, by)
        w = max(1e-9, float(window_s))
        if isinstance(inc, dict):
            return {k: v / w for k, v in inc.items()}
        return inc / w

    def gauge_latest(self, name: str, window_s: float = float("inf"),
                     now: Optional[float] = None,
                     labels: Optional[Dict[str, str]] = None,
                     by: Optional[str] = None):
        """Fleet roll-up of a gauge: the latest reading per (pid, label
        set) inside the window, summed (queue depths, replica counts —
        additive point-in-time state). With `by=`: grouped sums."""
        latest: Dict[Tuple, Tuple[float, float, Dict]] = {}
        for rec, s in self._iter(name, "gauge", window_s, now, labels):
            key = (rec.get("pid"),
                   tuple(sorted(s.get("labels", {}).items())))
            ts = rec.get("ts", 0.0)
            prev = latest.get(key)
            if prev is None or ts >= prev[0]:
                latest[key] = (ts, float(s.get("value", 0.0)),
                               s.get("labels", {}))
        if by is None:
            return float(sum(v for _, v, _ in latest.values()))
        out: Dict[str, float] = {}
        for _, v, lab in latest.values():
            k = str(lab.get(by, ""))
            out[k] = out.get(k, 0.0) + v
        return out

    def hist_increase(self, name: str, window_s: float,
                      now: Optional[float] = None,
                      labels: Optional[Dict[str, str]] = None) -> Dict:
        """Histogram growth over the window merged across pids/labels:
        {"count", "sum", "buckets": [(le, n), ...]} with per-bin counts
        (the shape bucket_quantile takes)."""
        count, total = 0, 0.0
        bins: Dict[float, float] = {}
        for _, s in self._iter(name, "histogram", window_s, now, labels):
            count += int(s.get("count_delta", 0))
            total += float(s.get("sum_delta", 0.0))
            for le, n in s.get("bucket_deltas", ()):
                le = float(le)
                bins[le] = bins.get(le, 0.0) + float(n)
        return {"count": count, "sum": total,
                "buckets": sorted(bins.items())}

    def quantile(self, q: float, name: str, window_s: float,
                 now: Optional[float] = None,
                 labels: Optional[Dict[str, str]] = None):
        """Windowed histogram quantile (fleet-merged), via the shared
        bucket interpolation. None when the window saw no observations."""
        h = self.hist_increase(name, window_s, now, labels)
        return bucket_quantile(q, h["buckets"], h["count"])
