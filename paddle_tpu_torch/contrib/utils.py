"""Program analysis helpers.

Reference: contrib/memory_usage_calc.py:46 `memory_usage` (estimate a
program's memory band for a batch size), contrib/op_frequence.py:23
`op_freq_statistic` (single-op and adjacent-pair frequencies),
contrib/model_stat.py:40 `summary` (per-layer PARAMs/FLOPs table).
Reimplemented against this framework's Program IR, as the JAX
package's `contrib/utils.py` is, with the same numbers for the same
program. The memory band's lower bound assumes the CUDA caching
allocator reuses the blocks of transient (non-persistable) vars, so
that only the largest one is live beside the persistables at any time;
the upper bound holds every var live at once.
"""

from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from ..core.framework import Program
from ..core.ir import normalize_dtype

_DTYPE_BYTES = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
                "int8": 1, "uint8": 1, "int16": 2, "int32": 4, "int64": 8,
                "bool": 1}


def _var_bytes(var, batch_size: int) -> int:
    shape = var.shape or ()
    numel = 1
    for s in shape:
        numel *= batch_size if s in (-1, None) else int(s)
    return numel * _DTYPE_BYTES.get(normalize_dtype(var.dtype), 4)


def memory_usage(program: Program, batch_size: int
                 ) -> Tuple[float, float, str]:
    """Estimate the program's device-memory band at `batch_size`.

    Returns (lower, upper, unit): lower = parameters/persistables plus
    the single largest transient var (the caching allocator reuses
    transient blocks);
    upper = every var in the program live simultaneously (no reuse —
    the worst case a pathological schedule could need).
    """
    if not isinstance(program, Program):
        raise TypeError(f"memory_usage expects a Program, got "
                        f"{type(program).__name__}")
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    persist = transient = largest_transient = 0
    for block in program.blocks:
        for var in block.vars.values():
            b = _var_bytes(var.desc, batch_size)
            if var.desc.persistable:
                persist += b
            else:
                transient += b
                largest_transient = max(largest_transient, b)
    lower, upper = persist + largest_transient, persist + transient
    for unit, scale in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10)):
        if upper >= scale:
            return lower / scale, upper / scale, unit
    return float(lower), float(upper), "B"


def op_freq_statistic(program: Program
                      ) -> Tuple[List[Tuple[str, int]],
                                 List[Tuple[str, int]]]:
    """Single-op and adjacent-pair frequencies, most-frequent first
    (reference: op_frequence.py:23; adjacency = an op consuming another
    op's output, the producer->consumer edges of the graph)."""
    if not isinstance(program, Program):
        raise TypeError(f"op_freq_statistic expects a Program, got "
                        f"{type(program).__name__}")
    uni: Counter = Counter()
    adj: Counter = Counter()
    for block in program.blocks:
        producer: Dict[str, str] = {}
        for op in block.desc.ops:
            uni[op.type] += 1
            for name in op.input_names():
                if name in producer:
                    adj[f"{producer[name]},{op.type}"] += 1
            for name in op.output_names():
                producer[name] = op.type
    return (sorted(uni.items(), key=lambda kv: -kv[1]),
            sorted(adj.items(), key=lambda kv: -kv[1]))


_SUMMARY_OPS = {"conv2d", "depthwise_conv2d", "conv2d_transpose", "mul",
                "matmul", "fc", "pool2d", "batch_norm", "layer_norm",
                "lookup_table", "lookup_table_v2", "softmax", "relu"}


def _op_stat(op, vars_, batch_size):
    """(params, flops) for one op from its var descs (MACs x2 = FLOPs)."""

    def shape_of(slot):
        names = op.inputs.get(slot) or op.outputs.get(slot) or []
        if not names or names[0] not in vars_:
            return None
        s = vars_[names[0]].shape or ()
        return tuple(batch_size if d in (-1, None) else int(d) for d in s)

    def numel(s):
        n = 1
        for d in s:
            n *= d
        return n

    t = op.type
    if t in ("conv2d", "depthwise_conv2d", "conv2d_transpose"):
        w = shape_of("Filter")
        out = shape_of("Output")
        if w is None or out is None:
            return 0, 0
        params = numel(w)
        # out numel x (cin/groups x kh x kw) MACs x2; the filter's dim 1
        # is ALREADY cin/groups (layers/nn.py builds
        # [num_filters, num_channels // groups, kh, kw])
        if t != "conv2d_transpose":
            flops = 2 * numel(out) * w[1] * w[2] * w[3]
        else:
            flops = 2 * numel(shape_of("Input") or out) * w[1] * w[2] * w[3]
        return params, flops
    if t in ("mul", "matmul", "fc"):
        wslot = "Y" if (op.inputs.get("Y") or [None])[0] else "W"
        w = shape_of(wslot)
        out = shape_of("Out")
        if w is None or out is None or len(w) < 2:
            return 0, 0
        # reduction dim: last two dims of Y, honoring transpose_Y
        k = w[-1] if op.attrs.get("transpose_Y") else w[-2]
        # PARAMs only for true parameters — attention-style matmuls
        # between activations must not count Y as weights
        wnames = op.inputs.get(wslot, [])
        wvar = vars_.get(wnames[0]) if wnames else None
        is_param = bool(wvar is not None and
                        (getattr(wvar, "is_parameter", False) or
                         wvar.persistable))
        return (numel(w) if is_param else 0), 2 * numel(out) * k
    if t in ("batch_norm", "layer_norm"):
        sc = shape_of("Scale")
        return (2 * numel(sc) if sc else 0), 0
    if t in ("lookup_table", "lookup_table_v2"):
        w = shape_of("W")
        return (numel(w) if w else 0), 0
    return 0, 0


def summary(main_prog: Program, batch_size: int = 1):
    """Per-op PARAMs/FLOPs table + totals (reference: model_stat.py:40).
    Prints the table; returns (total_params, total_flops)."""
    if not isinstance(main_prog, Program):
        raise TypeError(f"summary expects a Program, got "
                        f"{type(main_prog).__name__}")
    rows = []
    total_p = total_f = 0
    for block in main_prog.blocks:
        vars_ = block.desc.vars
        for op in block.desc.ops:
            if op.type not in _SUMMARY_OPS:
                continue
            p, f = _op_stat(op, vars_, batch_size)
            total_p += p
            total_f += f
            rows.append((op.type, p, f))
    print(f"{'No.':>4} {'TYPE':>18} {'PARAMs':>12} {'FLOPs':>14}")
    for i, (t, p, f) in enumerate(rows):
        print(f"{i:>4} {t:>18} {p:>12} {f:>14}")
    print(f"Total PARAMs: {total_p} ({total_p / 1e6:.4f}M)")
    print(f"Total FLOPs: {total_f} ({total_f / 1e9:.2f}G)")
    return total_p, total_f
