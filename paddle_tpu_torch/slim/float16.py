# Copied from the JAX package: paddle_tpu/slim/float16.py, with the changes
# tests/test_torch_imports.py declares (SLIM_COPY_CHANGES): scope values
# are tensors that may lie on the card, read to the host and written back
# where they lie.
"""Half-precision inference transpiler.

Reference: paddle/contrib/float16/float16_transpiler.py — rewrite a saved
inference program so weights and compute run in fp16, with boundary casts
at feeds and fetches (the reference's float16_benchmark.md numbers come
from this path).

TPU-native: bfloat16 is the hardware's half type (MXU-native, no loss
scaling needed), so the default target is bf16; fp16 remains available.
The rewrite is: cast persistable params in the scope, retag their
VarDescs, and insert boundary `cast` ops after each feed and before each
fetch target — everything between runs in half via JAX type promotion
inside the one compiled XLA computation.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..convert import cast_value
from ..core.framework import Program
from ..core.ir import OpDesc, VarDesc


def float16_transpile(program: Program, scope,
                      target_vars: Optional[Sequence[str]] = None,
                      dtype: str = "bfloat16") -> Program:
    """In-place: half-precision weights + boundary casts. `target_vars`
    are the fetch targets cast back to float32 (defaults to the program's
    recorded fetch_names)."""
    assert dtype in ("bfloat16", "float16")
    desc = program.global_block().desc
    fetches = list(target_vars or program._attrs.get("fetch_names", []))
    feeds = list(program._attrs.get("feed_names", []))

    # 1. cast persistable float32 params in the scope + retag descs
    for name, vd in desc.vars.items():
        if not vd.persistable or vd.dtype != "float32":
            continue
        val = scope.find_var(name)
        if val is not None:
            scope.set_var(name, cast_value(val, dtype))
        vd.dtype = dtype

    # 2. boundary casts: feed fp32 -> half at the top, fetch half -> fp32
    cast_in_ops = []
    rename = {}
    for fname in feeds:
        # integer feeds (token ids) must stay integer — only float inputs
        # are cast (the reference transpiler does the same)
        if fname not in desc.vars or desc.vars[fname].dtype != "float32":
            continue
        half = f"{fname}.cast_fp16"
        src = desc.vars[fname]
        desc.vars[half] = VarDesc(name=half, shape=src.shape, dtype=dtype,
                                  stop_gradient=True)
        cast_in_ops.append(OpDesc(
            type="cast", inputs={"X": [fname]}, outputs={"Out": [half]},
            attrs={"in_dtype": "float32", "out_dtype": dtype}))
        rename[fname] = half
    for op in desc.ops:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(n, n) for n in names]
    cast_out_ops = []
    for tname in fetches:
        if tname not in desc.vars or \
                desc.vars[tname].dtype not in ("float32", dtype):
            continue
        half = f"{tname}.fp16_out"
        # the producing ops now emit half values into a renamed var; the
        # original name becomes the cast-back output so fetch_names and
        # downstream consumers keep working
        desc.vars[half] = VarDesc(name=half,
                                  shape=desc.vars[tname].shape,
                                  dtype=dtype, stop_gradient=True)
        for op in desc.ops:
            for slot, names in op.outputs.items():
                op.outputs[slot] = [half if n == tname else n
                                    for n in names]
            for slot, names in op.inputs.items():
                op.inputs[slot] = [half if n == tname else n
                                   for n in names]
        cast_out_ops.append(OpDesc(
            type="cast", inputs={"X": [half]}, outputs={"Out": [tname]},
            attrs={"in_dtype": dtype, "out_dtype": "float32"}))
    desc.ops = cast_in_ops + desc.ops + cast_out_ops
    program._rebuild_from_desc()
    return program
