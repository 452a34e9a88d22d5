# Copied from the JAX package: paddle_tpu/slim/prune.py, with the changes
# tests/test_torch_imports.py declares (SLIM_COPY_CHANGES): scope values
# are tensors that may lie on the card, read to the host and written back
# where they lie.
"""Magnitude pruning.

Reference: contrib/slim/prune/pruner.py (RatioPruner: zero the
smallest-magnitude weights per parameter) and prune_strategy.py
(SensitivePruneStrategy: per-parameter sensitivity = eval-metric drop as
a function of prune ratio, used to pick per-layer ratios under a global
budget).

TPU-native: pruning is a scope-level weight rewrite plus persistent 0/1
mask parameters; `apply_masks` appends an elementwise multiply with the
mask after each optimizer step so pruned weights stay zero while the
dense XLA matmuls run unchanged (sparsity on TPU is a memory/BW win at
export, not a compute win — same as the reference's dense-mask design).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..convert import like_value
from ..core.async_exec import to_numpy
from ..core.framework import Program
from ..core.ir import OpDesc, VarDesc


class Pruner:
    """Unstructured (ratio) or structured (filter-L1) magnitude pruning."""

    def __init__(self, mode: str = "ratio"):
        assert mode in ("ratio", "filter_l1")
        self.mode = mode

    def prune(self, scope, params: Sequence[str],
              ratios: Dict[str, float]) -> Dict[str, np.ndarray]:
        """Zero weights in-place; returns the binary keep-masks."""
        masks = {}
        for name in params:
            val = scope.find_var(name)
            if val is None:
                continue
            w = to_numpy(val)
            ratio = float(ratios.get(name, ratios.get("*", 0.0)))
            if ratio <= 0:
                masks[name] = np.ones_like(w)
                continue
            if self.mode == "filter_l1" and w.ndim >= 2:
                # structured: prune whole output filters by L1 norm.
                # Output axis: 0 for conv [O,I,H,W], last for fc [In,Out]
                # (same convention as qat.py channel-wise quantization)
                out_axis = 0 if w.ndim == 4 else w.ndim - 1
                axes = tuple(i for i in range(w.ndim) if i != out_axis)
                norms = np.abs(w).sum(axis=axes)
                k = int(len(norms) * ratio)
                mask = np.ones_like(w)
                if k > 0:
                    drop = np.argsort(norms)[:k]
                    idx = [slice(None)] * w.ndim
                    idx[out_axis] = drop
                    mask[tuple(idx)] = 0.0
            else:
                flat = np.abs(w).ravel()
                k = int(flat.size * ratio)
                mask = np.ones(flat.size, w.dtype)
                if k > 0:
                    thresh_idx = np.argsort(flat)[:k]
                    mask[thresh_idx] = 0.0
                mask = mask.reshape(w.shape)
            scope.set_var(name, like_value(val, (w * mask).astype(w.dtype)))
            masks[name] = mask
        return masks

    def apply_masks(self, program: Program, scope,
                    masks: Dict[str, np.ndarray]):
        """Register masks as persistable vars and append `p = p * mask`
        after the optimizer ops, keeping pruned entries at zero during
        continued training."""
        block = program.global_block()
        desc = block.desc
        for name, mask in masks.items():
            mname = f"{name}.prune_mask"
            desc.vars[mname] = VarDesc(name=mname, shape=tuple(mask.shape),
                                       dtype="float32", persistable=True,
                                       stop_gradient=True)
            scope.set_var(mname, like_value(scope.find_var(name),
                                            mask.astype("float32")))
            desc.ops.append(OpDesc(
                type="elementwise_mul",
                inputs={"X": [name], "Y": [mname]},
                outputs={"Out": [name]},
                attrs={"axis": -1}))
        program._rebuild_from_desc()
        return program


class SensitivePruneStrategy:
    """Measure sensitivity: eval-metric vs prune ratio per parameter
    (reference: prune_strategy.py SensitivePruneStrategy.metric drop).
    `eval_fn()` returns the current metric (higher = better)."""

    def __init__(self, pruner: Optional[Pruner] = None,
                 ratios: Sequence[float] = (0.1, 0.3, 0.5, 0.7)):
        self.pruner = pruner or Pruner()
        self.ratios = list(ratios)

    def sensitivity(self, scope, params: Sequence[str],
                    eval_fn: Callable[[], float]) -> Dict[str, Dict[float, float]]:
        base = eval_fn()
        result: Dict[str, Dict[float, float]] = {}
        for name in params:
            if scope.find_var(name) is None:
                continue
            val = scope.find_var(name)
            keep = like_value(val, to_numpy(val).copy())
            result[name] = {}
            for r in self.ratios:
                self.pruner.prune(scope, [name], {name: r})
                result[name][r] = base - eval_fn()   # metric drop
                scope.set_var(name, keep)
        return result

    def pick_ratios(self, sensitivities: Dict[str, Dict[float, float]],
                    max_drop: float) -> Dict[str, float]:
        """Largest per-param ratio whose measured drop stays under
        max_drop."""
        out = {}
        for name, curve in sensitivities.items():
            best = 0.0
            for r, drop in sorted(curve.items()):
                if drop <= max_drop:
                    best = r
            out[name] = best
        return out
