# Copied from the JAX package: paddle_tpu/data_feeder.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""DataFeeder (reference: python/paddle/fluid/data_feeder.py) — converts
per-sample minibatch lists into the feed dict of batched numpy arrays."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .core.framework import Variable
from .core.ir import normalize_dtype

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None):
        self.feed_vars = feed_list
        self.place = place

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        columns: List[List] = [[] for _ in self.feed_vars]
        for sample in iterable:
            assert len(sample) == len(self.feed_vars), \
                f"sample has {len(sample)} slots, expected {len(self.feed_vars)}"
            for i, v in enumerate(sample):
                columns[i].append(np.asarray(v))
        out = {}
        for var, col in zip(self.feed_vars, columns):
            name = var.name if isinstance(var, Variable) else str(var)
            dtype = normalize_dtype(var.dtype) if isinstance(var, Variable) else None
            arr = np.stack(col)
            # match declared rank: e.g. label declared [-1,1] but fed scalars
            if isinstance(var, Variable) and var.shape is not None:
                want_rank = len(var.shape)
                while arr.ndim < want_rank:
                    arr = arr[..., None]
                if arr.ndim == want_rank + 1 and arr.shape[-1] == 1 and \
                        var.shape[-1] != 1:
                    arr = arr[..., 0]
            if dtype is not None:
                arr = arr.astype(dtype)
            out[name] = arr
        return out
