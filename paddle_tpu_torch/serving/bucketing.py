# Copied from the JAX package: paddle_tpu/serving/bucketing.py (numpy
# only), unchanged; keep it in step with its source.
"""Shape-bucket policy: map arbitrary request batch sizes onto a small
fixed set of compiled batch sizes.

The XLA engine compiles one executable per input signature, so serving
traffic whose batch size varies per request (bs=1..64) would compile up
to 64 executables — a recompile storm exactly when latency matters
most. The standard fix (Clipper NSDI'17, TF-Serving's batching layer)
is to round every batch up to the nearest of a few configured "bucket"
sizes, pad the feed rows, run the bucket-shaped executable, and slice
the outputs back to the true batch. Powers of two up to `max_batch`
bound both the signature count (log2) and the padding waste (<2x).

Stdlib+numpy only — shared by the synchronous `inference.Predictor`
(opt-in via `AnalysisConfig.enable_bucketing()`) and the serving
batcher/engine, so both paths agree on which signatures exist and the
AOT warmup set stays small and closed.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["BucketPolicy", "common_batch", "DEFAULT_MAX_BATCH"]

DEFAULT_MAX_BATCH = 64


def common_batch(feeds: Dict[str, object]) -> Optional[int]:
    """Leading dim shared by every feed array, or None when feeds
    disagree (or any is rank-0) — in which case bucketing does not
    apply and the caller falls back to exact-shape dispatch."""
    n = None
    for v in feeds.values():
        a = np.asarray(v)
        if a.ndim == 0:
            return None
        if n is None:
            n = int(a.shape[0])
        elif int(a.shape[0]) != n:
            return None
    return n


def _pow2_buckets(max_batch: int):
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class BucketPolicy:
    """A sorted set of allowed batch sizes plus the pad/slice helpers
    that move a request batch in and out of its bucket."""

    def __init__(self, max_batch: int = DEFAULT_MAX_BATCH,
                 buckets: Optional[Sequence[int]] = None):
        if buckets is not None:
            bs = sorted({int(b) for b in buckets})
            if not bs or bs[0] < 1:
                raise ValueError(f"buckets must be positive ints, got "
                                 f"{tuple(buckets)}")
            self.buckets = tuple(bs)
        else:
            if int(max_batch) < 1:
                raise ValueError(f"max_batch must be >= 1, got {max_batch}")
            self.buckets = _pow2_buckets(int(max_batch))
        self.max_batch = self.buckets[-1]

    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest bucket >= n, or None when n exceeds the largest
        bucket (the caller then compiles the exact shape, or — in the
        batcher — never builds such a batch in the first place)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def pad_batch(self, arr, bucket: int) -> np.ndarray:
        """Pad axis 0 up to `bucket` rows by repeating the last real row.
        Edge-replication rather than zeros: a zero row can poison ops
        like log/division with NaN/Inf that then trip the health layer,
        while a repeated real row is always in-distribution. No copy
        when the array is already bucket-sized."""
        arr = np.asarray(arr)
        n = arr.shape[0]
        if n == bucket:
            return arr
        if n > bucket:
            raise ValueError(f"batch {n} does not fit bucket {bucket}")
        pad = np.repeat(arr[-1:], bucket - n, axis=0)
        return np.concatenate([arr, pad], axis=0)

    def slice_batch(self, arr, n: int) -> np.ndarray:
        """Undo pad_batch: the first n rows (no copy when nothing was
        padded)."""
        arr = np.asarray(arr)
        if arr.ndim == 0 or arr.shape[0] == n:
            return arr
        return arr[:n]
