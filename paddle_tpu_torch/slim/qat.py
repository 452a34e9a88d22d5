# Copied from the JAX package: paddle_tpu/slim/qat.py, with the changes
# tests/test_torch_imports.py declares (SLIM_COPY_CHANGES): scope values
# are tensors that may lie on the card, read to the host and written back
# where they lie.
"""Quantization-aware training passes.

Reference: contrib/slim/quantization/quantization_pass.py —
QuantizationTransformPass (insert fake-quant ops on the weights and
activations of quantizable ops) and QuantizationFreezePass (convert the
trained program to an int8 inference model).

TPU-native: the transform is a Program rewrite (no ir::Graph needed — the
Program IR is the graph); fake quant ops simulate the int8 grid in fp32
with a straight-through estimator so the QAT step stays one XLA
computation. Freezing reuses the post-training weight quantizer on the
QAT-trained weights and strips the fake ops.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..convert import like_value
from ..core.async_exec import to_numpy
from ..core.framework import Program
from ..core.ir import OpDesc, VarDesc

# ops whose weight/activation inputs get quantized (reference
# quantization_pass.py _quantizable_op_type)
QUANTIZABLE_OPS: Dict[str, Dict[str, str]] = {
    # op type -> {weight slot: activation slot}
    "conv2d": {"weight": "Filter", "act": "Input"},
    "depthwise_conv2d": {"weight": "Filter", "act": "Input"},
    "mul": {"weight": "Y", "act": "X"},
    "matmul": {"weight": "Y", "act": "X"},
}


class QuantizationTransformPass:
    """Insert fake quant-dequant ops ahead of quantizable ops.

    weight_quantize_type: 'abs_max' | 'channel_wise_abs_max'
    activation_quantize_type: 'moving_average_abs_max' | 'abs_max'
    """

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 weight_quantize_type: str = "channel_wise_abs_max",
                 activation_quantize_type: str = "moving_average_abs_max",
                 moving_rate: float = 0.9,
                 quantizable_op_type: Optional[Sequence[str]] = None):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.weight_quantize_type = weight_quantize_type
        self.activation_quantize_type = activation_quantize_type
        self.moving_rate = moving_rate
        self.op_types = set(quantizable_op_type or QUANTIZABLE_OPS)

    def apply(self, program: Program,
              startup_program: Optional[Program] = None) -> Program:
        block = program.global_block()
        desc = block.desc
        quantized: Dict[str, str] = {}   # original var -> quantized var
        new_ops: List[OpDesc] = []
        params = {name for name, v in desc.vars.items() if v.is_parameter}

        for op in desc.ops:
            if op.type in self.op_types:
                spec = QUANTIZABLE_OPS.get(op.type)
                if spec:
                    for role in ("weight", "act"):
                        slot = spec[role]
                        names = op.inputs.get(slot, [])
                        if not names or not names[0]:
                            continue
                        name = names[0]
                        if name not in quantized:
                            qname = self._insert_quant(
                                desc, new_ops, name,
                                is_weight=name in params)
                            quantized[name] = qname
                        op.inputs[slot] = [quantized[name]]
            new_ops.append(op)
        desc.ops = new_ops
        program._rebuild_from_desc()
        if startup_program is not None:
            self.init_scales(program, startup_program)
        return program

    def _mkvar(self, desc, name, shape, persistable=False):
        desc.vars[name] = VarDesc(name=name, shape=tuple(shape),
                                  dtype="float32",
                                  persistable=persistable,
                                  stop_gradient=False)
        return name

    def _insert_quant(self, desc, new_ops, name, is_weight):
        src = desc.vars.get(name)
        shape = src.shape if src is not None and src.shape else (1,)
        qname = f"{name}.quantized"
        self._mkvar(desc, qname, shape)
        bits = self.weight_bits if is_weight else self.activation_bits
        if is_weight:
            if self.weight_quantize_type == "channel_wise_abs_max":
                op_type = "fake_channel_wise_quantize_dequantize_abs_max"
                # conv weights [O,I,H,W] quantize per O (axis 0); fc
                # weights [In, Out] per Out (last axis)
                axis = 0 if len(shape) == 4 else len(shape) - 1
                attrs = {"bit_length": bits, "quant_axis": axis}
                scale_shape = (shape[axis],)
            else:
                op_type = "fake_quantize_dequantize_abs_max"
                attrs = {"bit_length": bits}
                scale_shape = (1,)
            scale = self._mkvar(desc, f"{name}.quant_scale",
                                scale_shape, persistable=False)
            new_ops.append(OpDesc(type=op_type, inputs={"X": [name]},
                                  outputs={"Out": [qname],
                                           "OutScale": [scale]},
                                  attrs=attrs))
        else:
            if self.activation_quantize_type == "moving_average_abs_max":
                op_type = "fake_quantize_dequantize_moving_average_abs_max"
                in_scale = self._mkvar(desc, f"{name}.quant_in_scale", (1,),
                                       persistable=True)
                state = self._mkvar(desc, f"{name}.quant_state", (1,),
                                    persistable=True)
                accum = self._mkvar(desc, f"{name}.quant_accum", (1,),
                                    persistable=True)
                new_ops.append(OpDesc(
                    type=op_type,
                    inputs={"X": [name], "InScale": [in_scale],
                            "InState": [state], "InAccum": [accum]},
                    # state vars update in place (persistable round trip)
                    outputs={"Out": [qname], "OutScale": [in_scale],
                             "OutState": [state], "OutAccum": [accum]},
                    attrs={"bit_length": bits,
                           "moving_rate": self.moving_rate}))
            else:
                op_type = "fake_quantize_dequantize_abs_max"
                scale = self._mkvar(desc, f"{name}.quant_scale", (1,))
                new_ops.append(OpDesc(type=op_type, inputs={"X": [name]},
                                      outputs={"Out": [qname],
                                               "OutScale": [scale]},
                                      attrs={"bit_length": bits}))
        return qname

    def init_scales(self, program: Program, startup_program: Program):
        """Emit fill_constant init ops in the startup program for every
        quant state var the transform created."""
        desc = program.global_block().desc
        sdesc = startup_program.global_block().desc
        for name, var in desc.vars.items():
            if name.endswith((".quant_in_scale", ".quant_state",
                              ".quant_accum")):
                if name not in sdesc.vars:
                    sdesc.vars[name] = VarDesc(
                        name=name, shape=(1,), dtype="float32",
                        persistable=True)
                    val = 1.0 if not name.endswith(".quant_accum") else 0.001
                    if name.endswith(".quant_in_scale"):
                        val = 0.001
                    sdesc.ops.append(OpDesc(
                        type="fill_constant", inputs={},
                        outputs={"Out": [name]},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": val}))
        startup_program._rebuild_from_desc()


class QuantizationFreezePass:
    """Strip fake-quant ops and bake int8 weights for inference
    (reference: QuantizationFreezePass). Returns the frozen program; the
    scope's quantized weights are rounded to the int8 grid so inference
    matches QAT numerics."""

    def __init__(self, weight_bits: int = 8):
        self.weight_bits = weight_bits

    def apply(self, program: Program, scope) -> Program:
        from .quantization import _dequantize_array, _quantize_array

        block = program.global_block()
        desc = block.desc
        new_ops = []
        rewrites: Dict[str, str] = {}
        params = {n for n, v in desc.vars.items() if v.is_parameter}
        for op in desc.ops:
            if op.type.startswith("fake_") and "quantize" in op.type:
                x = op.inputs["X"][0]
                out = op.outputs["Out"][0]
                rewrites[out] = x
                if x in params:
                    val = scope.find_var(x)
                    if val is not None:
                        w = to_numpy(val)
                        # one quantization grid for the whole toolkit:
                        # reuse the post-training quantizer round trip
                        if op.type.startswith("fake_channel_wise"):
                            axis = int(op.attrs.get("quant_axis", 0))
                            q, sc = _quantize_array(w, axis=axis)
                            dq = _dequantize_array(q, sc)
                        else:  # per-tensor: flatten → one channel
                            q, sc = _quantize_array(w.reshape(1, -1),
                                                    axis=0)
                            dq = _dequantize_array(q, sc).reshape(w.shape)
                        scope.set_var(x, like_value(
                            val, dq.astype(w.dtype)))
                continue
            # rewire any input that referenced a fake-quant output
            for slot, names in op.inputs.items():
                op.inputs[slot] = [rewrites.get(n, n) for n in names]
            new_ops.append(op)
        desc.ops = new_ops
        program._rebuild_from_desc()
        return program
