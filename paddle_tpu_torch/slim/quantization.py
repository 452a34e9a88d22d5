# Copied from the JAX package: paddle_tpu/slim/quantization.py (numpy and
# stdlib only), with declared changes: calibrate_and_quantize takes
# `place` and calibrates on the card by default, where the source
# calibrates on the CPU, and two comments are reworded. Keep the rest in
# step with the source.
"""Post-training quantization.

Reference: contrib/slim/quantization (QuantizationTranspiler / post-training
INT8, cpu_quantize_pass.cc). TPU-native round-1 scope: weight-only INT8 —
matmul/conv weights are stored as int8 with per-output-channel scales and
dequantized on load. This quarters checkpoint size and HBM weight traffic;
activations stay bf16/fp32 (TPU matmuls are bf16-native, so weight-only is
the usual win; int8 activation quant needs calibration and is round-2).

The quantized model keeps the SAME program: `<w>` is replaced on disk by
`<w>@INT8` + `<w>@SCALE`, and load_quantized_vars rebuilds the float weight.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..observability import events as _events
from ..observability import metrics as _m

QUANT_META_FILE = "__quant_meta__.json"

# Calibration/quantization visibility: the passes
# used to run silently — a degenerate scale (a dead activation, a
# near-zero weight channel) was invisible until accuracy fell over.
# Every computed scale now lands in a histogram, per-var counts in a
# counter, and each pass appends a `quantize` event to the JSONL log.
QUANT_SCALE = _m.histogram(
    "paddle_tpu_quant_scale",
    "Quantization scales computed by slim passes (kind=weight is one "
    "sample per output channel, kind=activation one per calibrated "
    "tensor); a spike at the 1.0 fallback bucket means all-zero "
    "tensors were calibrated",
    labelnames=("kind",),
    buckets=_m.exponential_buckets(1e-8, 10.0, 12))
QUANT_VARS = _m.counter(
    "paddle_tpu_quant_vars_total",
    "Tensors quantized/calibrated by slim passes",
    labelnames=("kind",))
QUANT_BYTES_SAVED = _m.counter(
    "paddle_tpu_quant_bytes_saved_total",
    "fp32 bytes minus int8+scale bytes across quantized weights")
QUANT_OPS = {"mul": "Y", "matmul": "Y", "matmul_v2": "Y",
             "conv2d": "Filter", "depthwise_conv2d": "Filter",
             "conv3d": "Filter", "lookup_table": "W"}


def _fname(name: str, suffix: str = "") -> str:
    # io.save_vars mangles '/' the same way
    from ..io import var_filename

    return var_filename(name) + suffix + ".npy"


def _quantize_array(w: np.ndarray, axis: int = -1):
    """Symmetric per-channel int8 quant along `axis` (output channels)."""
    w = np.asarray(w, np.float32)
    red = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    amax = np.abs(w).max(axis=red, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _dequantize_array(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale


class PostTrainingQuantization:
    """reference: contrib/slim post-training quantizer. Weight-only:
    `quantize()` rewrites the saved inference model in place (or to
    `save_model_path`)."""

    def __init__(self, model_dir: str, save_model_path: Optional[str] = None,
                 quantizable_op_type: Optional[Sequence[str]] = None,
                 quantizable_var_names: Optional[Sequence[str]] = None):
        """quantizable_var_names: when given, quantize ONLY these weight
        vars (callers that rewrite a subset of ops — calibrate_and_
        quantize — must restrict the pass to the weights they rewrite;
        quantizing a weight a skipped op still reads deletes the fp32
        .npy that op needs in the native predictor)."""
        self.model_dir = model_dir
        self.save_path = save_model_path or model_dir
        self.op_types = set(quantizable_op_type or QUANT_OPS)
        self.var_names = (None if quantizable_var_names is None
                          else set(quantizable_var_names))

    def quantize(self) -> Dict[str, float]:
        """Returns {var_name: compression_ratio}."""
        from ..core.ir import ProgramDesc

        with open(os.path.join(self.model_dir, "__model__")) as f:
            payload = json.load(f)
        desc = ProgramDesc.from_dict(payload["program"])

        # weight vars = persistable inputs of quantizable ops
        targets: Dict[str, str] = {}
        for b in desc.blocks:
            for op in b.ops:
                slot = QUANT_OPS.get(op.type)
                if op.type not in self.op_types or slot is None:
                    continue
                for n in op.inputs.get(slot, []):
                    if self.var_names is not None and n not in self.var_names:
                        continue
                    v = b.vars.get(n)
                    if v is not None and v.persistable:
                        targets[n] = op.type

        os.makedirs(self.save_path, exist_ok=True)
        if os.path.abspath(self.save_path) != os.path.abspath(self.model_dir):
            from ..resilience.atomic import write_bytes

            # atomic copy (was shutil.copy): a crash mid-copy must not
            # leave a half-written __model__/weight file that a later
            # boot would happily load
            for fn in os.listdir(self.model_dir):
                with open(os.path.join(self.model_dir, fn), "rb") as f:
                    write_bytes(os.path.join(self.save_path, fn),
                                f.read())

        # merge with any existing meta (re-quantizing an already-quantized
        # model must not clobber it)
        meta_path = os.path.join(self.save_path, QUANT_META_FILE)
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)

        ratios = {}
        missing = []
        for name, op_type in targets.items():
            if name in meta:
                continue  # already quantized
            path = os.path.join(self.save_path, _fname(name))
            if not os.path.exists(path):
                missing.append(name)
                continue
            w = np.load(path)
            # per-output-channel: conv filters quantize along dim 0
            axis = 0 if "conv" in op_type else -1
            q, scale = _quantize_array(w, axis=axis)
            from ..resilience import atomic as _atomic

            _atomic.np_save(
                os.path.join(self.save_path, _fname(name, "@INT8")), q)
            _atomic.np_save(
                os.path.join(self.save_path, _fname(name, "@SCALE")), scale)
            os.remove(path)
            meta[name] = {"axis": axis, "dtype": str(w.dtype)}
            ratios[name] = float(w.nbytes) / (q.nbytes + scale.nbytes)
            for s in np.asarray(scale, np.float32).ravel():
                QUANT_SCALE.observe(float(s), kind="weight")
            QUANT_VARS.inc(kind="weight")
            QUANT_BYTES_SAVED.inc(
                max(0, int(w.nbytes) - int(q.nbytes + scale.nbytes)))
        if missing and not ratios and not meta:
            raise ValueError(
                f"no per-var .npy weight files found for {missing} — models "
                f"saved with a combined params_filename are not supported; "
                f"re-save without params_filename")
        if meta:
            from ..resilience.atomic import json_dump

            json_dump(meta, meta_path)
        if ratios:
            _events.emit(
                "quantize", action="weights", dir=self.save_path,
                vars=len(ratios),
                mean_compression=round(
                    sum(ratios.values()) / len(ratios), 3))
        return ratios


def load_quantized_vars(dirname: str,
                        names: Optional[Sequence[str]] = None
                        ) -> Dict[str, np.ndarray]:
    """Dequantize `<w>@INT8` + `<w>@SCALE` pairs back to float weights
    (called by io.load_* when __quant_meta__.json is present); `names`
    restricts dequantization to the requested vars."""
    meta_path = os.path.join(dirname, QUANT_META_FILE)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        meta = json.load(f)
    out = {}
    for name, info in meta.items():
        if names is not None and name not in names:
            continue
        q = np.load(os.path.join(dirname, _fname(name, "@INT8")))
        scale = np.load(os.path.join(dirname, _fname(name, "@SCALE")))
        out[name] = _dequantize_array(q, scale).astype(info.get("dtype",
                                                               "float32"))
    return out


def quantize_inference_model(model_dir: str,
                             save_model_path: Optional[str] = None):
    """One-call weight-only INT8 quantization of a saved inference model."""
    return PostTrainingQuantization(model_dir, save_model_path).quantize()


# ---------------------------------------------------------------------------
# Calibration-based INT8 runtime (reference: inference/api/
# mkldnn_quantizer.cc — run calibration batches, collect per-activation
# scales, rewrite the graph to INT8 kernels via cpu_quantize_pass.cc)
# ---------------------------------------------------------------------------

_INT8_REWRITE = {"mul": ("quantized_mul", "Y", "X"),
                 "matmul": ("quantized_matmul", "Y", "X"),
                 "conv2d": ("quantized_conv2d", "Filter", "Input")}


def calibrate_and_quantize(model_dir: str, calibration_reader,
                           save_model_path: Optional[str] = None,
                           quantizable_op_type: Optional[Sequence[str]] = None,
                           place=None) -> Dict[str, float]:
    """Full INT8 pipeline over a saved fp32 inference model:

    1. run `calibration_reader` batches (iterable of feed dicts) through
       the fp32 model, recording each quantizable op's activation-input
       abs-max -> per-tensor activation scale (amax / 127);
    2. quantize the weights (per-output-channel int8, existing PTQ);
    3. REWRITE the saved program: mul/matmul/conv2d become
       quantized_mul/quantized_matmul/quantized_conv2d consuming the int8
       weight + scale vars with the calibrated x_scale attr.

    The result is a model dir that both engines execute with true int8
    matmul/conv compute (int32 accumulation): the XLA Predictor via
    ops/quant.py's quantized_* kernels, the native C++ predictor via its
    int8 gemm/conv kernels. Returns {activation_var: scale}.

    Calibration runs on `place`, CUDAPlace(0) when None."""
    from ..core.executor import Executor, Scope, scope_guard
    from ..core.ir import ProgramDesc, VarDesc
    from ..core.places import default_place
    from .. import io as pt_io

    op_types = set(quantizable_op_type or _INT8_REWRITE)
    save_path = save_model_path or model_dir

    # -- 1. calibration on the fp32 model ----------------------------------
    exe = Executor(place if place is not None else default_place())
    scope = Scope()
    with scope_guard(scope):
        program, feed_names, _ = pt_io.load_inference_model(model_dir, exe)
        targets = []          # (op_idx, act_var, weight_var, op_type)
        desc0 = program.desc.blocks[0]
        for i, op in enumerate(desc0.ops):
            if op.type not in op_types or op.type not in _INT8_REWRITE:
                continue
            _, wslot, xslot = _INT8_REWRITE[op.type]
            wnames = op.inputs.get(wslot, [])
            xnames = op.inputs.get(xslot, [])
            if not wnames or not xnames:
                continue
            wv = desc0.vars.get(wnames[0])
            if wv is None or not wv.persistable:
                continue
            if op.type == "matmul":
                # quantized_matmul handles plain 2-D X @ W only — leave
                # transposed/scaled/batched matmuls in fp32
                xv = desc0.vars.get(xnames[0])
                if (op.attrs.get("transpose_X") or
                        op.attrs.get("transpose_Y") or
                        float(op.attrs.get("alpha", 1.0)) != 1.0 or
                        (xv is not None and xv.shape is not None
                         and len(xv.shape) != 2)):
                    continue
            if op.type == "conv2d":
                # quantized_conv2d covers the vanilla case both engines
                # execute identically; grouped/dilated/auto-padded convs
                # stay fp32 (the native int8 kernel rejects them)
                pads = [int(p) for p in op.attrs.get("paddings", [0, 0])]
                if (int(op.attrs.get("groups", 1) or 1) > 1 or
                        any(int(d) != 1
                            for d in op.attrs.get("dilations", [1, 1])) or
                        op.attrs.get("padding_algorithm",
                                     "EXPLICIT") != "EXPLICIT" or
                        (len(pads) == 4 and (pads[0] != pads[1]
                                             or pads[2] != pads[3]))):
                    continue
            targets.append((i, xnames[0], wnames[0], op.type))
        act_names = sorted({t[1] for t in targets})
        amax = {n: 0.0 for n in act_names}
        n_batches = 0
        for feed in calibration_reader():
            outs = exe.run(program, feed=feed, fetch_list=act_names)
            for n, v in zip(act_names, outs):
                amax[n] = max(amax[n], float(np.abs(np.asarray(v)).max()))
            n_batches += 1
        if n_batches == 0:
            raise ValueError("calibration reader yielded no batches")
    act_scales = {n: (m / 127.0 if m > 0 else 1.0)
                  for n, m in amax.items()}
    for s in act_scales.values():
        QUANT_SCALE.observe(float(s), kind="activation")
        QUANT_VARS.inc(kind="activation")
    _events.emit("quantize", action="calibrate", dir=save_path,
                 activations=len(act_scales), batches=n_batches)

    # -- 2. weight quantization --------------------------------------------
    # A weight read by any op OUTSIDE the rewrite set (a skipped
    # quantizable op — grouped/dilated conv, transposed/non-2D matmul —
    # or a non-quantizable consumer) must stay fp32 end to end: the
    # native predictor loads persistables strictly from '<name>.npy',
    # so quantizing it would delete the file that op still needs.
    rewrite_idx = {t[0] for t in targets}
    weight_of = {t[0]: t[2] for t in targets}
    fp32_needed = set()
    # scan ALL blocks: the rewrite touches block 0 only, so an op in a
    # control-flow sub-block reading a shared weight also pins it fp32
    for bi, blk in enumerate(program.desc.blocks):
        for j, op in enumerate(blk.ops):
            rewritten = bi == 0 and j in rewrite_idx
            for slot, ns in op.inputs.items():
                for n in ns:
                    if not rewritten or n != weight_of.get(j):
                        fp32_needed.add(n)
    targets = [t for t in targets if t[2] not in fp32_needed]
    PostTrainingQuantization(
        model_dir, save_path,
        quantizable_op_type=[t for t in op_types],
        quantizable_var_names=[t[2] for t in targets]).quantize()

    # -- 3. program rewrite -------------------------------------------------
    model_path = os.path.join(save_path, "__model__")
    with open(model_path) as f:
        payload = json.load(f)
    desc = ProgramDesc.from_dict(payload["program"])
    meta_path = os.path.join(save_path, QUANT_META_FILE)
    with open(meta_path) as f:
        meta = json.load(f)
    b0 = desc.blocks[0]
    for i, xname, wname, op_type in targets:
        if wname not in meta:
            continue
        op = b0.ops[i]
        new_type, wslot, _ = _INT8_REWRITE[op_type]
        q = np.load(os.path.join(save_path, _fname(wname, "@INT8")))
        s = np.load(os.path.join(save_path, _fname(wname, "@SCALE")))
        b0.vars[wname + "@INT8"] = VarDesc(
            name=wname + "@INT8", shape=tuple(q.shape), dtype="int8",
            persistable=True, stop_gradient=True)
        b0.vars[wname + "@SCALE"] = VarDesc(
            name=wname + "@SCALE", shape=tuple(s.shape), dtype="float32",
            persistable=True, stop_gradient=True)
        op.type = new_type
        op.inputs[wslot] = [wname + "@INT8"]
        op.inputs["Scale"] = [wname + "@SCALE"]
        op.attrs["x_scale"] = float(act_scales[xname])
        # drop the fp32 weight desc ONLY if no remaining (skipped/fp32)
        # op still reads it — a shared weight with a non-rewritten
        # consumer must keep loading the float values
        still_used = any(n == wname for o2 in b0.ops
                         for ns in o2.inputs.values() for n in ns)
        if not still_used:
            b0.vars.pop(wname, None)
    payload["program"] = desc.to_dict()
    payload["act_scales"] = act_scales
    from ..resilience.atomic import json_dump

    json_dump(payload, model_path)
    return act_scales
