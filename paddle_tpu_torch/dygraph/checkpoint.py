"""Dygraph checkpoints: the JAX package's `dygraph/checkpoint.py`
(reference: python/paddle/fluid/dygraph/checkpoint.py —
save_dygraph/load_dygraph). The same `.pdparams.npz` files, written
atomically (resilience.atomic: a kill mid-save leaves the previous file
whole), so each package reads the other's."""

from __future__ import annotations

import os

import numpy as np

from ..core.async_exec import to_numpy
from ..resilience import atomic as _atomic

__all__ = ["save_dygraph", "load_dygraph"]


def save_dygraph(state_dict, model_path):
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    arrays = {k: to_numpy(getattr(v, "value", v)) for k, v in state_dict.items()}
    _atomic.np_savez(model_path + ".pdparams", **arrays)


def load_dygraph(model_path):
    path = model_path + ".pdparams.npz"
    if not os.path.exists(path):
        path = model_path + ".pdparams"
    data = np.load(path)
    return {k: data[k] for k in data.files}, None
