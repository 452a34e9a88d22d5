#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: the card's name and power limit, and the build of every
   kernel from the sources in this checkout (one nvcc per source, all
   started together);
2. kernels: each kernel against its plain PyTorch version on the card,
   with its time beside the plain version's, one PyTorch library
   call's and the card's bound: K1-fwd at the serving path's shapes,
   K1-fwd with its LSE output and K1-bwd (at bf16 and f16 two launches,
   dq computing delta in its prologue from the output, then dkv; the
   external-delta dq launch and the standalone delta launch beside them)
   at the training phases' own shapes (BERT-base 256 x 128 and
   32 x 512, full; GPT-2-small 8 x 1024, causal) and at batch 32 and 1
   of the same models, all bf16, plus f32 and f16 at one shape each,
   head_dim 128 (causal) and a ragged T at f16; K1-fwd with its LSE
   alone at phase 17's no-mesh call (8 x 4096, timed), at head_dim 128,
   on the views of one fused [B, T, 3, N, H] projection and at a ragged
   T; K1-bwd at that call's T 4096, held at batch 1 and timed at batch 8
   beside SDPA's backward; every output is held per element against the
   plain version's, at a limit relative to its own RMS (`ELEM_TOL`;
   K1-bwd's ragged f16 gradients and K2's f16 causal case at
   `ATTN_F16_TOL`). bf16 and f16 run
   the Hopper kernels (wgmma, TMA), f32 the FMA ones;
3. slice: GPT-2-small (random weights from a seed) served at bf16 by
   DecodeEngine behind the HTTP Server, which warms the engine's phase
   grid before it binds (every prefill bucket run once, each decode
   slot count's step captured as a CUDA graph); /v1/healthz 200
   "serving", /v1/load and /v1/models checked; 8 concurrent streamed
   /v1/generate requests whose prompts fill every prefill bucket up to
   1024, then the same 8 again; every decode step a graph replay; the
   kernels' launch counts are read around the first round alone;
4. profile: the slice's requests straight into a fresh engine never
   warmed (every decode step eager), twice, then under torch.profiler
   (device busy share, largest kernels); then the same into a warmed
   engine (warmup seconds, the graphs' memory, the decode step's host
   and device time at 4 and 8 slots, eager against replay), whose
   tokens must equal the unwarmed engine's;
5. greedy: a 2-layer, full-width f32 engine's greedy tokens against the
   step-by-step full forward on the card;
6. train-parity: one `make_train_step` step of a 2-layer, full-width
   BERT at f32 (TF32 off) on the card (kernels) and on the CPU (plain
   versions) from the same params and batch: loss, every gradient and
   the updated params;
7. train: BERT-base under mixed_bf16 with dropout on, at 256 x 128 and
   32 x 512 (3 warm-up and 20 timed steps each): step time, samples/s,
   MFU, a finite and falling loss, kernel launches per step, and one
   step under torch.profiler (device idle share);
8. gpt-train: GPT-2-small `lm_loss` under mixed_bf16 at 8 x 1024
   (2 warm-up and 10 timed steps): the causal backward kernel;
9. nmt-parity: a 2 + 2-layer Transformer at Transformer-big's widths,
   f32 (TF32 off), 4 x 128 with ragged source and target lengths:
   `nmt_loss`, every gradient and one Adam step on the card (K1 and the
   padding-masked K2) against the CPU (plain versions), and
   `beam_search`'s tokens and scores;
10. nmt-train: Transformer-big (`TransformerConfig.big()`, 6 + 6 layers)
   as bench.py's bench_transformer_big runs its first rung: 128 pairs of
   128 x 128 tokens from `make_batch`, Adam(1e-4), f32 params with bf16
   compute (3 warm-up and 20 timed steps): K2 fwd, dkv and dq 12 times
   a step (encoder self- and cross-attention), each on its Hopper kernel
   in the traced step (K2-bwd's device ms reported), K1 6 times;
11. nmt-beam: Transformer-big `beam_search` under inference_mode, 8
   sources of 128 tokens with ragged lengths, beam 4, 32 steps;
12. bert-padded: BERT-base at 32 x 512 with an attention_mask (lengths
   uniform in [256, 512]) under mixed_bf16: every layer's attention on
   K2's Hopper kernels, forward and backward (checked in the traced
   step, K2-bwd's device ms reported);
13. bottleneck: the fused bottleneck slice at ResNet-50's widths (M
   50176, C 1024 -> 256 -> 1024, f32, TF32 off), matmul_stats (K4) ->
   fold_bn -> bn_act_matmul (K5), against the unfused plain composition,
   values and gradients: K5's path;
14. resnet-parity: full-width ResNet-50 at f64 activations, 4 x 64 x 64,
   `fused_1x1`: on the card fused (K4, K6) against unfused (cuDNN), at
   the JAX package's limits for that comparison; the card against the
   CPU (plain versions), loss, BN updates, gradients and one
   SGD-momentum step;
15. resnet-train: ResNet-50 as bench.py's bench_resnet50 runs its first
   rung (bs 256 at 224 x 224, NHWC, bf16 activations, f32 params,
   SGD(0.1, momentum 0.9), 3 warm-up and 20 timed steps), unfused, then
   `fused_1x1` with K4 and K6 16 times a step each;
16. ring-parity: an in-process sp=4 ring on the card (four virtual
   ranks, what one card can show of the sp axis) at f32, TF32 off:
   ring_splash (K3 blocks) against its plain version and against
   single-device K1, causal ring_attention against K1 causal, out and
   gradients; then one step of a 2-layer, full-width BERT-base at
   2 x 1024 under MeshConfig(sp=4) against no mesh (K1) on the card and
   against the CPU: loss, every gradient and one AdamW step;
17. bert-long-sp: BERT-base at T 4096 as bench.py's bench_bert_long
   builds it (`BertConfig(max_len=4096, dropout=0.0)`), mixed_bf16,
   under MeshConfig(sp=4) on the in-process ring at the first rung of
   [8, 4, 2, 1] that fits (2 warm-up and 10 timed steps, K3 192 times
   a step), then the same step with no mesh (K1 at T 4096);
18. head-dim-gate: two mixed_bf16 train steps of `BertConfig.tiny()`
   (head dim 16) on the card, every attention call on mha's "xla"
   route, no attention kernel launched.

Phase 2 also holds K2 (forward, dkv, dq) per element against its plain
versions at those paths' shapes (Transformer-big's encoder and cross
attention, the beam search's 32 x 128, padded BERT-base 32 x 512),
causal with full biases at f32 and f16, a ragged pair, the bias
gradient at f32 and bf16 and head_dim 128 with 300 keys (bf16 and f16
on the Hopper kernels, f32 on the FMA ones); and K4, K5 and K6 (the fused matmul+BN
kernels) at one ResNet-50 bs-256 shape of each stage group (bf16, timed
beside cuBLAS's bare product), at f32, f16 and f64, at a ragged (1000, 72, 40),
with the ReLU off and at (1000, 70, 36), whose K and N TMA cannot read
in place (the padded route); and K3 (the ring's block, K1-fwd with its LSE
at scale 1 on a pre-scaled q) at phase 17's block (8 x 1024 x 12 heads,
bf16), at f32 and at f16.

The kernels' launch counts are set to 0 just before each path's run and
read just after (phase 3 for serving, phases 7, 8, 10, 12, 15 and 17
for training, phase 11 for beam search, phase 13 for the bottleneck).
The last line is {"ok": true, "device": {...}}; the line before it
lists every kernel with its numbers. Exits non-zero without a CUDA
device, and when the package is not beside this script.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps=30):
    """Median over `reps` warm calls, each timed with CUDA events."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, flops, peak):
    """Least time for `nbytes` of memory traffic and `flops` operations
    at `peak` FLOP/s: (ms, "bytes" or "operations")."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


def attention_bound_ms(q, k, causal=True, products=2, tensors=4,
                       row_floats=0):
    """Least time for attention work on these inputs: `tensors` tensors
    of q's size read or written once, plus `row_floats` f32 rows of
    [B, N, T] (LSE, delta), over the memory rate, against `products`
    matrix products of 2 * pairs * H per (batch, head) over the peak
    rate of q's dtype, pairs being the (query, key) pairs the mask
    leaves. The forward is 2 products over q, k, v and o; the backward
    5 products over q, k, v, o, dO, dq, dk and dv."""
    import torch

    B, T, N, H = q.shape
    Tk = k.shape[1]
    pairs = sum(min(t + 1, Tk) for t in range(T)) if causal else T * Tk
    nbytes = tensors * q.numel() * q.element_size() + row_floats * B * N * T * 4
    flops = products * 2 * B * N * H * pairs
    peak = F32_FLOPS_PER_S if q.dtype == torch.float32 else BF16_FLOPS_PER_S
    return bound_ms(nbytes, flops, peak)


def phase_environment():
    import torch

    from paddle_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    took = _build.build()
    print(json.dumps({"phase": "environment",
                      "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "build_s": round(time.perf_counter() - t0, 3),
                      "built": sorted(took)}))


def _serving_kernel_row():
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    B, N, H = 1, 12, 64
    scale = 1.0 / H ** 0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    timing = None
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for T in (8, 100, 128, 1024):
            # q/k/v as the serving path hands them over: strided views
            # of one fused qkv projection
            qkv = torch.randn(B, T, 3 * N * H, generator=gen,
                              device="cuda").to(dtype)
            q, k, v = (t.view(B, T, N, H)
                       for t in qkv.split(N * H, dim=-1))
            out = fa.flash_attention(q, k, v, scale, causal=True)
            torch.cuda.synchronize()
            ref = fa.flash_attention_ref(q, k, v, scale, causal=True)
            err = (out.float() - ref.float()).abs().max().item()
            dname = str(dtype).replace("torch.", "")
            elem = held(out, ref, dname)
            checks.append({"dtype": dname, "T": T, "max_abs_err": err,
                           "tol": tol, "held": elem})
            check(err <= tol, f"flash_attention T={T} {dtype}: max abs "
                              f"err {err} > {tol}")
            check(elem["ratio"] <= 1.0, f"flash_attention T={T} {dtype}: "
                                        f"per element {elem}")
            if dtype == torch.bfloat16 and T == 1024:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                bound, bound_by = attention_bound_ms(q, k)
                timing = {
                    "shape": [B, T, N, H], "dtype": "bfloat16",
                    "kernel_ms": time_ms(
                        lambda: fa.flash_attention(q, k, v, scale)),
                    "plain_ms": time_ms(
                        lambda: fa.flash_attention_ref(q, k, v, scale)),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, scale=scale)),
                    "bound_ms": bound, "bound_by": bound_by}
    # the serving path runs bf16: its error is the worst bf16 check
    timing["max_abs_err"] = max(c["max_abs_err"] for c in checks
                                if c["dtype"] == "bfloat16")
    return {"name": "flash_attention_fwd",
            "replaces": "K1 attention.py:_splash_mha (causal fwd)",
            "tol": 2e-2, "checks": checks, **timing}


# Limits of a kernel's result against its plain version, per element:
# |got - want| <= rtol |want| + atol rms(want). rtol is one rounding
# step of the dtype (both round the same f32 sums to it, so a sum taken
# in another order may move one rounding). atol, a share of the
# tensor's own RMS, covers a rounding of P or dS to the dtype that falls
# the other way after f32 sums in another order: one step of a large dS
# times a q or k element, landing on a dq or dk element of any size.
# The largest such reading on an H100 was 1.07e-2 of RMS at bf16,
# 1.9e-4 at f16 and 2.8e-6 at f32 (PERF.md); the limits are 2-5 times
# those. Each gradient is held to its own scale, so a result wrong on
# some rows fails, however large the largest value is.
ELEM_TOL = {"bfloat16": (2 ** -7, 2e-2), "float16": (2 ** -10, 1e-3),
            "float32": (1e-5, 1e-5), "float64": (1e-12, 1e-12)}
# The f16 attention limit, where ELEM_TOL's f16 atol lies below the
# plain version's own f32 noise: K1-bwd's f16 gradients at the ragged
# f16 case below and in tests/test_torch_cuda.py's Hopper backward cases,
# and K2's f16 causal case (its output and gradients). On the tensor
# cores S (and dP) are summed in another order than the plain version's
# f32 GEMM, so a rounding of P or dS to f16 falls the other way here and
# there. An f64 evaluation of the same arithmetic, P and dS rounded to
# f16, reads up to 1.09 (K1-bwd) and 1.38 (K2's causal case) of
# ELEM_TOL's f16 limit against the f32 plain version
# (`kernels/probe_sm90.py` on the card, "k1_bwd_f16_floor" and
# "k2_seeds"; tests/test_torch_hopper_numerics.py on the CPU; PERF.md): at those shapes 1e-3 lies below that noise. Every other f16
# case stays under ELEM_TOL. This limit is about twice the largest
# kernel reading, as bf16's atol is to its own, and it still fails an
# evaluation that rounds P and dS to bf16 at f16 inputs, on every output
# (the probe's "bf16_*" readings; the tests assert it).
ATTN_F16_TOL = (2 ** -10, 3e-3)

# K1 at the training path's shapes: (label, B, T, N, H, causal, dtype
# name, timed, the gradients' limit), q, k and v the strided views of
# one fused qkv projection. The first three are the main path's own
# calls (phase 7's BERT-base at 256 x 128 and 32 x 512, phase 8's
# GPT-2-small at 8 x 1024), then BERT-base and GPT-2-small at batch 32
# and 1 (causal T 1024 at B 1), then f32 and f16 at one shape each, 16
# heads of 128 (causal) and a ragged T at f16. The gradients are held
# under ELEM_TOL, or under the limit the case names.
TRAIN_KERNEL_CASES = (
    ("bert", 256, 128, 12, 64, False, "bfloat16", True, None),
    ("bert512", 32, 512, 12, 64, False, "bfloat16", True, None),
    ("gpt", 8, 1024, 12, 64, True, "bfloat16", True, None),
    ("bert32", 32, 128, 12, 64, False, "bfloat16", True, None),
    ("gpt1", 1, 1024, 12, 64, True, "bfloat16", True, None),
    ("f32", 2, 256, 12, 64, True, "float32", False, None),
    ("f16", 4, 128, 12, 64, False, "float16", False, None),
    ("h128", 2, 1024, 16, 128, True, "bfloat16", False, None),
    ("ragged_f16", 2, 300, 12, 64, False, "float16", False, ATTN_F16_TOL))


def held(got, want, dname, tol=None):
    """`got` against `want` under ELEM_TOL[dname] (or `tol`, an (rtol,
    atol) pair): the max abs error,
    the reference's RMS (its typical value) and largest value, `ratio`
    (the worst element's error over its limit; at most 1 passes) and
    `atol_rms` (the least atol, in RMS, that would pass at this
    rtol)."""
    import torch

    rtol, atol = tol or ELEM_TOL[dname]
    want = want.float()
    err = (got.float() - want).abs()
    rms = want.square().mean().sqrt().clamp(min=torch.finfo().tiny)
    return {"max_abs_err": err.max().item(), "rms": rms.item(),
            "max_ref": want.abs().max().item(),
            "ratio": (err / (rtol * want.abs() + atol * rms)).max().item(),
            "atol_rms": ((err - rtol * want.abs()).clamp(min=0).max()
                         / rms).item()}


def _sdpa_bwd_ms(q, k, v, do, causal, scale, reps=30):
    """The backward of F.scaled_dot_product_attention at the same shape,
    timed through torch.autograd.grad: the library yardstick."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         scale=scale)
    dot = do.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True), reps)


def _training_kernel_case(fa, B, T, causal, dname, gen, N=12, H=64,
                          grad_tol=None):
    """One case: K1-fwd with LSE and K1-bwd's launches against their
    plain versions: dq given the output (at bf16 and f16 its kernel
    computes delta in its prologue), dkv from that delta, the
    external-delta dq launch given the same delta (bit for bit the
    folded one's dq: "equal_to_folded") and the standalone delta launch;
    and the whole backward (from the plain forward's residuals) against
    its plain version; the gradients under `grad_tol` where given, else
    ELEM_TOL, each delta under f32's."""
    import torch

    scale = 1.0 / H ** 0.5
    dtype = getattr(torch, dname)
    qkv = torch.randn(B, T, 3 * N * H, generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (t.view(B, T, N, H) for t in qkv.split(N * H, dim=-1))
    do = torch.randn(B, T, N, H, generator=gen, device="cuda").to(dtype)
    out, lse = fa.flash_attention_with_lse(q, k, v, scale, causal)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, do, lse, None, scale,
                                          causal, o=out)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                        causal)
    dq_external = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                            causal)
    standalone = fa.attention_delta(out, do)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, scale, causal,
                                              with_lse=True)
    # each launch's plain version from the kernels' own residuals
    ref = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_ref(
        q, k, v, out, lse, do, scale, causal)))
    ref_delta = fa.attention_delta_ref(out, do)
    errs = {"out": held(out, ref_out, dname),
            "delta": held(delta, ref_delta, "float32"),
            "delta_standalone": held(standalone, ref_delta, "float32"),
            "dq": held(dq, ref["dq"], dname, grad_tol),
            "dq_external": {**held(dq_external, ref["dq"], dname, grad_tol),
                            "equal_to_folded": torch.equal(dq_external, dq)},
            "dk": held(dk, ref["dk"], dname, grad_tol),
            "dv": held(dv, ref["dv"], dname, grad_tol)}
    whole = fa.flash_attention_bwd(q, k, v, ref_out, ref_lse, do, scale,
                                   causal)
    whole_ref = fa.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, do,
                                           scale, causal)
    for name, a, b in zip(("bwd_dq", "bwd_dk", "bwd_dv"), whole, whole_ref):
        errs[name] = held(a, b, dname, grad_tol)
    lse_err = (lse - ref_lse).abs().max().item()
    return (q, k, v, do, out, lse, delta, scale), errs, lse_err


def failed_checks(prefix, errs):
    """The readings of `errs` ({name: held(...)}) that fail: a ratio over
    1, or an external-delta result that is not the folded one's bit for
    bit."""
    return [f"{prefix} {name}: {e}" for name, e in errs.items()
            if not e["ratio"] <= 1.0 or e.get("equal_to_folded") is False]


def _training_kernel_timings(fa, case, causal):
    """ms, plain_ms, library_ms and the bound of K1-fwd-LSE, the whole
    K1-bwd (two launches; the three-launch form with the standalone delta
    beside it) and its dkv and dq launches and the delta pass folded into
    dq, at one case's inputs."""
    import torch.nn.functional as F

    q, k, v, do, out, lse, delta, scale = case
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    B, T, N, _ = q.shape
    t = {"fwd_lse": {
        "ms": time_ms(lambda: fa.flash_attention_with_lse(
            q, k, v, scale, causal)),
        "plain_ms": time_ms(lambda: fa.flash_attention_ref(
            q, k, v, scale, causal, with_lse=True)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale)),
        "bound": attention_bound_ms(q, k, causal, 2, 4, 1)}}
    # the whole backward (dq with the delta pass, then dkv) is no kernel
    # row of its own: its launches are the dq and dkv rows'
    t["bwd_whole"] = {
        "ms": time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, scale, causal)),
        "three_launch_ms": time_ms(lambda: _k1_bwd_three_launches(
            fa, q, k, v, out, lse, do, scale, causal)),
        "plain_ms": time_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, out, lse, do, scale, causal)),
        "library_ms": _sdpa_bwd_ms(q, k, v, do, causal, scale),
        "bound": attention_bound_ms(q, k, causal, 5, 8, 2)}
    dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, None, scale, causal, o=out))
    dq_external_ms = time_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, scale, causal))
    # the delta pass folded into dq: the folded launch's time less the
    # external-delta launch's, against one read of o and the delta rows'
    # write (dq reads dO anyway)
    t["delta"] = {
        "ms": dq_ms - dq_external_ms,
        "standalone_ms": time_ms(lambda: fa.attention_delta(out, do)),
        "plain_ms": time_ms(lambda: fa.attention_delta_ref(out, do)),
        "library_ms": None,
        "bound": bound_ms(out.numel() * out.element_size() + B * N * T * 4,
                          2 * out.numel(), F32_FLOPS_PER_S)}
    t["dkv"] = {
        "ms": time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, scale, causal)),
        "plain_ms": time_ms(lambda: fa.flash_attention_bwd_dkv_ref(
            q, k, v, do, lse, delta, scale, causal)),
        "library_ms": None,
        "bound": attention_bound_ms(q, k, causal, 4, 6, 2)}
    # dq as the main path runs it, folding the delta pass in: q, k, v,
    # dO and o read, dq written, lse read and delta written
    t["dq"] = {
        "ms": dq_ms, "external_ms": dq_external_ms,
        "plain_ms": time_ms(lambda: fa.flash_attention_bwd_dq_ref(
            q, k, v, do, lse, None, scale, causal, o=out)),
        "library_ms": None,
        "bound": attention_bound_ms(q, k, causal, 3, 6, 2)}
    return t


def _k1_bwd_three_launches(fa, q, k, v, out, lse, do, scale, causal):
    """K1-bwd as it ran before the fold: the standalone delta launch, then
    dkv and the external-delta dq."""
    delta = fa.attention_delta(out, do)
    return (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                      causal),
            *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                        causal))


def _training_kernel_rows():
    """K1-fwd with LSE and K1-bwd's launches against their plain versions
    at every case, and their times at the bf16 cases. Returns the kernel
    rows, every case's readings and the failed checks."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    checks, timings, failed = [], {}, []
    for (label, B, T, N, H, causal, dname, timed,
         grad_tol) in TRAIN_KERNEL_CASES:
        case, errs, lse_err = _training_kernel_case(fa, B, T, causal, dname,
                                                    gen, N, H, grad_tol)
        checks.append({"case": label, "shape": [B, T, N, H],
                       "causal": causal, "dtype": dname,
                       "tol": ELEM_TOL[dname],
                       "grad_tol": grad_tol or ELEM_TOL[dname],
                       "lse_max_abs_err": lse_err, "held": errs})
        failed += failed_checks(f"K1 {label}", errs)
        if not lse_err <= 1e-4:
            failed.append(f"K1 {label} lse: max abs error {lse_err} > 1e-4")
        if timed:
            timings[label] = {"shape": [B, T, N, H], "causal": causal,
                              **_training_kernel_timings(fa, case, causal)}
        del case
    # the training path runs bf16: a row's error is its worst bf16 one
    bf16 = [c for c in checks if c["dtype"] == "bfloat16"]

    def worst(*names):
        return max(c["held"][n]["max_abs_err"] for c in bf16 for n in names)

    rows = []
    for name, key, err, replaces in (
            ("flash_attention_fwd_lse", "fwd_lse", worst("out"),
             "K1 attention.py:_splash_mha fwd with LSE (under grad)"),
            (DELTA, "delta", worst("delta"),
             "K1-bwd splash vjp di = rowsum(o*do), folded into the dq "
             "kernels at bf16 and f16"),
            ("flash_attention_bwd_dkv", "dkv", worst("dk", "dv"),
             "K1-bwd splash dkv kernel"),
            ("flash_attention_bwd_dq", "dq", worst("dq"),
             "K1-bwd splash dq kernel")):
        rows.append({"name": name, "replaces": replaces, "max_abs_err": err,
                     "timings": {label: t[key]
                                 for label, t in timings.items()}})
    whole = {label: t["bwd_whole"] for label, t in timings.items()}
    return rows, checks, whole, failed


# K1-fwd with its LSE beyond the training cases, forward only (the plain
# backward at T 4096 would take tens of GB): (label, B, T, N, H, causal,
# dtype, layout). "long" is phase 17's no-mesh call (BERT-base at
# 8 x 4096), timed; then H 128, the strided views of one fused
# [B, T, 3, N, H] projection, and a ragged T at f16.
K1_FWD_CASES = (("long", 8, 4096, 12, 64, False, "bfloat16", "plain"),
                ("h128", 2, 1024, 16, 128, True, "bfloat16", "plain"),
                ("fused3", 4, 512, 12, 64, False, "bfloat16", "fused"),
                ("ragged_f16", 2, 300, 12, 64, True, "float16", "fused"))


def _k1_fwd_rows():
    """K1-fwd with its LSE at K1_FWD_CASES against its plain version, per
    element under ELEM_TOL and the LSE within 1e-4; times at "long"."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    checks, failed, timing = [], [], None
    for label, B, T, N, H, causal, dname, layout in K1_FWD_CASES:
        dtype = getattr(torch, dname)
        if layout == "fused":
            qkv = torch.randn(B, T, 3, N, H, generator=gen,
                              device="cuda").to(dtype)
            q, k, v = qkv.unbind(2)
        else:
            q, k, v = (torch.randn(B, T, N, H, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
        scale = 1.0 / H ** 0.5
        out, lse = fa.flash_attention_with_lse(q, k, v, scale, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_ref(q, k, v, scale, causal,
                                                  with_lse=True)
        err = held(out, ref_out, dname)
        lse_err = (lse - ref_lse).abs().max().item()
        del ref_out, ref_lse
        checks.append({"case": label, "shape": [B, T, N, H], "causal": causal,
                       "dtype": dname, "layout": layout,
                       "tol": ELEM_TOL[dname], "lse_max_abs_err": lse_err,
                       "held": {"out": err}})
        if not err["ratio"] <= 1.0:
            failed.append(f"K1 {label} out: {err}")
        if not lse_err <= 1e-4:
            failed.append(f"K1 {label} lse: max abs error {lse_err} > 1e-4")
        if label == "long":
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bound, bound_by = attention_bound_ms(q, k, causal, 2, 4, 1)
            timing = {
                "shape": [B, T, N, H], "dtype": dname,
                "ms": time_ms(lambda: fa.flash_attention_with_lse(
                    q, k, v, scale, causal), reps=10),
                "plain_ms": time_ms(lambda: fa.flash_attention_ref(
                    q, k, v, scale, causal, with_lse=True), reps=3),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale), reps=10),
                "bound_ms": bound, "bound_by": bound_by}
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return {"checks": checks, "long": timing}, failed


# K1-bwd at phase 17's no-mesh call (BERT-base at 8 x 4096, bf16, full
# mask): held at batch 1 (the plain backward at batch 8 takes tens of
# GB), timed at batch 8 beside SDPA's backward
K1_BWD_LONG = (8, 4096, 12, 64)


def _k1_bwd_long():
    """K1-bwd's launches at T 4096 against their plain versions at B 1
    (per element under ELEM_TOL), then the whole backward (two launches,
    and the three-launch form) and its dkv and dq launches (dq folding
    the delta pass in, and given delta) timed at B 8 beside SDPA's
    backward."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    B, T, N, H = K1_BWD_LONG
    gen = torch.Generator(device="cuda").manual_seed(7)
    failed = []
    case, errs, lse_err = _training_kernel_case(fa, 1, T, False, "bfloat16",
                                                gen, N, H)
    del case
    torch.cuda.empty_cache()
    failed += failed_checks("K1 long", errs)
    if not lse_err <= 1e-4:
        failed.append(f"K1 long lse: max abs error {lse_err} > 1e-4")
    scale = 1.0 / H ** 0.5
    q, k, v, do = (torch.randn(B, T, N, H, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_with_lse(q, k, v, scale, False)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, do, lse, None, scale,
                                         False, o=out)
    timing = {
        "shape": [B, T, N, H], "dtype": "bfloat16",
        "ms": time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, scale, False), reps=10),
        "three_launch_ms": time_ms(lambda: _k1_bwd_three_launches(
            fa, q, k, v, out, lse, do, scale, False), reps=10),
        "dkv_ms": time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, scale, False), reps=10),
        "dq_ms": time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, None, scale, False, o=out), reps=10),
        "dq_external_ms": time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, scale, False), reps=10),
        "library_ms": _sdpa_bwd_ms(q, k, v, do, False, scale, reps=10),
        "bound": attention_bound_ms(q, k, False, 5, 8, 2)}
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return {"checks": {"shape": [1, T, N, H], "lse_max_abs_err": lse_err,
                       "held": errs}, "timing": timing}, failed


# K2 at the main paths' shapes: (label, B, Tq, Tk, N, H, causal, dtype,
# bias, limit). "nmt" is Transformer-big's encoder self- and
# cross-attention (key padding from make_batch's src_len), "beam" the
# beam search's cross-attention (8 sources x 4 beams, 32 target positions
# against 128 source keys), "bert512" padded BERT-base (lengths uniform
# in [256, 512], BERT's bf16 fill of -3e4); then causal with a full
# [B, N, T, T] bias at f32 and f16, a ragged pair, the bias gradient at
# f32, head_dim 128 with 300 keys, and the bias gradient at bf16 (the
# Hopper dq writes it). The first three are
# timed. Outputs and gradients are held under ELEM_TOL, or under the
# limit the case names (ROADMAP F4: K2's f16 causal case).
K2_KERNEL_CASES = (
    ("nmt", 128, 128, 128, 16, 64, False, "bfloat16", "src_len", None),
    ("beam", 32, 32, 128, 16, 64, False, "bfloat16", "src_len", None),
    ("bert512", 32, 512, 512, 12, 64, False, "bfloat16", "bert", None),
    ("causal_f32", 2, 256, 256, 12, 64, True, "float32", "full", None),
    ("causal_f16", 4, 128, 128, 12, 64, True, "float16", "full",
     ATTN_F16_TOL),
    ("ragged", 2, 100, 164, 12, 64, False, "bfloat16", "src_len", None),
    ("dbias", 2, 128, 128, 4, 64, False, "float32", "full", None),
    ("h128_ragged", 4, 256, 300, 8, 128, False, "bfloat16", "src_len",
     None),
    ("dbias_bf16", 2, 128, 128, 4, 64, False, "bfloat16", "full", None))
K2_TIMED = ("nmt", "beam", "bert512")
# traced steps a K2 phase may take to see every K2 launch (`_train_run`)
TRACE_TRIES = 3
# each K2 launch's kernels by the name the profiler shows: the Hopper one
# (bf16, f16) and the FMA one (f32)
K2_ROUTES = {
    "flash_attention_bias_fwd": {"sm90": "flash_bias_fwd_sm90_kernel",
                                 "fma": "flash_bias_fwd_kernel"},
    "flash_attention_bias_bwd_dkv": {"sm90": "flash_bias_bwd_dkv_sm90_kernel",
                                     "fma": "flash_bias_bwd_dkv_kernel"},
    "flash_attention_bias_bwd_dq": {"sm90": "flash_bias_bwd_dq_sm90_kernel",
                                    "fma": "flash_bias_bwd_dq_kernel"}}


def k2_bound_ms(q, k, bias, causal, products, q_tensors, k_tensors, rows,
                extra_bytes=0):
    """Least time for K2 work on these inputs: `q_tensors` tensors of
    q's size and `k_tensors` of k's read or written once, the bias as
    the kernel reads it (its own elements, not the broadcast), `rows`
    f32 rows of [B, N, Tq] (l, m, delta) and `extra_bytes`, over the
    memory rate, against `products` matrix products of 2 * pairs * H
    per (batch, head) over the peak rate of q's dtype."""
    import torch

    B, Tq, N, H = q.shape
    Tk = k.shape[1]
    pairs = sum(min(t + 1, Tk) for t in range(Tq)) if causal else Tq * Tk
    nbytes = ((q_tensors * q.numel() + k_tensors * k.numel()) *
              q.element_size() + bias.numel() * 4 + rows * B * N * Tq * 4 +
              extra_bytes)
    flops = products * 2 * B * N * H * pairs
    peak = F32_FLOPS_PER_S if q.dtype == torch.float32 else BF16_FLOPS_PER_S
    return bound_ms(nbytes, flops, peak)


def _k2_inputs(B, Tq, Tk, N, dname, kind, gen, H=64):
    """q, k, v, do [B, T, N, H] and the bias: a [B, 1, 1, Tk] key mask
    (-1e9 past make_batch-style lengths, or BERT's -3e4 past lengths in
    [256, 512]) or a full [B, N, Tq, Tk] f32 bias."""
    import torch

    from paddle_tpu_torch.models import transformer

    dtype = getattr(torch, dname)
    q, k, v = (torch.randn(B, t, N, H, generator=gen, device="cuda")
               .to(dtype) for t in (Tq, Tk, Tk))
    do = torch.randn(B, Tq, N, H, generator=gen, device="cuda").to(dtype)
    if kind == "full":
        return q, k, v, do, torch.randn(B, N, Tq, Tk, generator=gen,
                                        device="cuda")
    if kind == "bert":
        lens, fill = torch.randint(256, 513, (B,), generator=gen,
                                   device="cuda"), -3e4
    else:   # the beam search repeats each source's length per beam
        beams = 4 if B == 32 and Tq == 32 else 1
        cfg = transformer.TransformerConfig(src_vocab=8, tgt_vocab=8)
        lens = transformer.make_batch(gen, cfg, B // beams, src_T=Tk,
                                      tgt_T=Tq)["src_len"] \
            .repeat_interleave(beams)
        fill = -1e9
    keep = torch.arange(Tk, device="cuda")[None] < lens[:, None]
    return q, k, v, do, torch.where(keep, 0.0, fill)[:, None, None, :]


def _k2_timings(fa, fb, case):
    """ms, plain_ms, library_ms and the bound of K2-fwd, its dkv and dq
    launches (dq folding the delta pass in; given delta beside it) and
    the whole backward (two launches: dq, then dkv; the three-launch form
    with the standalone delta beside it) at one case."""
    import torch
    import torch.nn.functional as F

    q, k, v, do, bias, out, l, m, delta, scale = case
    args = (q, k, v, bias, do, l, m, delta, scale, False)
    qt, kt, vt = (t.detach().transpose(1, 2) for t in (q, k, v))
    # SDPA adds its mask after the scale, K2 its bias before
    amask = (bias * scale).to(q.dtype)

    def folded_dq():
        return fb.flash_attention_bias_bwd_dq(q, k, v, bias, do, l, m, None,
                                              scale, False, o=out)

    def whole():
        dq, d = folded_dq()
        return dq, fb.flash_attention_bias_bwd_dkv(q, k, v, bias, do, l, m, d,
                                                   scale, False)

    def whole_three():
        d = fa.attention_delta(out, do)
        a = (q, k, v, bias, do, l, m, d, scale, False)
        return fb.flash_attention_bias_bwd_dq(*a), \
            fb.flash_attention_bias_bwd_dkv(*a)

    def whole_ref():
        dq, d = fb.flash_attention_bias_bwd_dq_ref(q, k, v, bias, do, l, m,
                                                   None, scale, False, o=out)
        return dq, fb.flash_attention_bias_bwd_dkv_ref(q, k, v, bias, do, l,
                                                       m, d, scale, False)

    qg, kg, vg = (t.clone().requires_grad_() for t in (qt, kt, vt))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=amask,
                                              scale=scale)
    dot = do.transpose(1, 2)
    return {
        "fwd": {"ms": time_ms(lambda: fb.flash_attention_bias_fwd(
                    q, k, v, bias, scale)),
                "plain_ms": time_ms(lambda: fb.flash_attention_bias_ref(
                    q, k, v, bias, scale)),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=amask, scale=scale)),
                "bound": k2_bound_ms(q, k, bias, False, 2, 2, 2, 2)},
        "dkv": {"ms": time_ms(lambda: fb.flash_attention_bias_bwd_dkv(*args)),
                "plain_ms": time_ms(
                    lambda: fb.flash_attention_bias_bwd_dkv_ref(*args)),
                "library_ms": None,
                "bound": k2_bound_ms(q, k, bias, False, 4, 2, 4, 3)},
        # dq as the main path runs it, folding the delta pass in: q, dO
        # and o read and dq written, k and v read, l and m read and
        # delta written
        "dq": {"ms": time_ms(folded_dq),
               "external_ms": time_ms(
                   lambda: fb.flash_attention_bias_bwd_dq(*args)),
               "plain_ms": time_ms(
                   lambda: fb.flash_attention_bias_bwd_dq_ref(
                       q, k, v, bias, do, l, m, None, scale, False, o=out)),
               "library_ms": None,
               "bound": k2_bound_ms(q, k, bias, False, 3, 4, 2, 3)},
        "bwd_whole": {
            "ms": time_ms(whole), "three_launch_ms": time_ms(whole_three),
            "plain_ms": time_ms(whole_ref),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qg, kg, vg), dot, retain_graph=True)),
            "bound": k2_bound_ms(q, k, bias, False, 5, 4, 4, 2)}}


def k2_case(B, Tq, Tk, N, H, causal, dname, kind, gen, tol=None,
            with_dbias=False, scale=0.125):
    """One K2 case: K2-fwd and K2-bwd's launches (dq with the bias
    gradient when asked) against their plain versions, per element under
    ELEM_TOL (or `tol`; the bias gradient under f32's): dq given the
    output (at bf16 and f16 its kernel computes delta in its prologue),
    dkv from that delta, the external-delta dq launch given the same
    delta (bit for bit the folded one's dq and dbias:
    "equal_to_folded"), each delta (folded, and the standalone launch)
    under f32's; l and m as the same f32 sums in another order. Returns
    the inputs and outputs (q, k, v, do, bias, out, l, m, delta, scale),
    the readings by output and {l_rel_err, m_max_abs_err}."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import flash_attention_bias as fb

    q, k, v, do, bias = _k2_inputs(B, Tq, Tk, N, dname, kind, gen, H)
    out, l, m = fb.flash_attention_bias_fwd(q, k, v, bias, scale, causal)
    *dq, delta = fb.flash_attention_bias_bwd_dq(
        q, k, v, bias, do, l, m, None, scale, causal, with_dbias=with_dbias,
        o=out)
    args = (q, k, v, bias, do, l, m, delta, scale, causal)
    dk, dv = fb.flash_attention_bias_bwd_dkv(*args)
    external = fb.flash_attention_bias_bwd_dq(*args, with_dbias=with_dbias)
    external = external if with_dbias else (external,)
    standalone = fa.attention_delta(out, do)
    torch.cuda.synchronize()
    ref_out, ref_l, ref_m = fb.flash_attention_bias_ref(
        q, k, v, bias, scale, causal)
    ref_dk, ref_dv = fb.flash_attention_bias_bwd_dkv_ref(*args)
    ref_dq = fb.flash_attention_bias_bwd_dq_ref(*args, with_dbias=with_dbias)
    ref_dq = ref_dq if with_dbias else (ref_dq,)
    ref_delta = fa.attention_delta_ref(out, do)
    errs = {"out": held(out, ref_out, dname, tol),
            "delta": held(delta, ref_delta, "float32"),
            "delta_standalone": held(standalone, ref_delta, "float32"),
            "dk": held(dk, ref_dk, dname, tol),
            "dv": held(dv, ref_dv, dname, tol),
            "dq": held(dq[0], ref_dq[0], dname, tol),
            "dq_external": {**held(external[0], ref_dq[0], dname, tol),
                            "equal_to_folded": all(
                                torch.equal(a, b)
                                for a, b in zip(external, dq))}}
    if with_dbias:
        errs["dbias"] = held(dq[1], ref_dq[1], "float32")
    # l and m: the same f32 sums and maxima in another order
    lm = {"l_rel_err": ((l - ref_l).abs() / ref_l).max().item(),
          "m_max_abs_err": (m - ref_m).abs().max().item()}
    return (q, k, v, do, bias, out, l, m, delta, scale), errs, lm


def _k2_kernel_rows():
    """K2-fwd and K2-bwd's dkv and dq launches against their plain
    versions at every case (`k2_case`), and their times at the timed
    cases. Returns the kernel rows, every case's readings, the whole
    backward's times and the failed checks."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import flash_attention_bias as fb

    gen = torch.Generator(device="cuda").manual_seed(5)
    checks, timings, failed = [], {}, []
    for label, B, Tq, Tk, N, H, causal, dname, kind, tol in K2_KERNEL_CASES:
        case, errs, lm = k2_case(B, Tq, Tk, N, H, causal, dname, kind, gen,
                                 tol, with_dbias=label.startswith("dbias"))
        checks.append({"case": label, "shape": [B, Tq, Tk, N, H],
                       "causal": causal, "dtype": dname, "bias": kind,
                       "tol": tol or ELEM_TOL[dname], **lm, "held": errs})
        failed += failed_checks(f"K2 {label}", errs)
        if not (lm["l_rel_err"] <= 1e-5 and lm["m_max_abs_err"] <= 1e-4):
            failed.append(f"K2 {label} l/m: {lm}")
        if label in K2_TIMED:
            timings[label] = {"shape": [B, Tq, Tk, N, H],
                              **_k2_timings(fa, fb, case)}
    bf16 = [c for c in checks if c["dtype"] == "bfloat16"]

    def worst(*names):
        return max(c["held"][n]["max_abs_err"] for c in bf16 for n in names)

    rows = []
    for name, key, err, replaces in (
            ("flash_attention_bias_fwd", "fwd", worst("out"),
             "K2 attention.py:_pallas_mha flash_attention fwd"),
            ("flash_attention_bias_bwd_dkv", "dkv", worst("dk", "dv"),
             "K2 flash_attention _flash_attention_bwd_dkv"),
            ("flash_attention_bias_bwd_dq", "dq", worst("dq"),
             "K2 flash_attention _flash_attention_bwd_dq")):
        rows.append({"name": name, "replaces": replaces, "max_abs_err": err,
                     "kernels": K2_ROUTES[name],
                     "timings": {label: t[key]
                                 for label, t in timings.items()}})
    whole = {label: t["bwd_whole"] for label, t in timings.items()}
    return rows, checks, whole, failed


# K3 (the ring's block, `splash_block_with_lse`): (label, B, T, dtype).
# "ring" is phase 17's block, BERT-base at T 4096 over an sp=4 ring
# (1024 queries against 1024 keys, bf16, q pre-scaled); then one f32
# and one f16 shape. The first is timed.
K3_KERNEL_CASES = (("ring", 8, 1024, "bfloat16"), ("f32", 2, 512, "float32"),
                   ("f16", 4, 1024, "float16"))


def _k3_kernel_row():
    """K3 against its plain version per element (`ELEM_TOL`) at every
    case, its LSE within 1e-4, and its times at the ring's block."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(17)
    checks, failed, timing = [], [], None
    for label, B, T, dname in K3_KERNEL_CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(B, T, 12, 64, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        q = q * torch.tensor(0.125, dtype=dtype)   # pre-scaled, as the ring
        out, lse = fa.splash_block_with_lse(q, k, v)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.splash_block_with_lse_ref(q, k, v)
        err = held(out, ref_out, dname)
        lse_err = (lse - ref_lse).abs().max().item()
        checks.append({"case": label, "shape": [B, T, 12, 64],
                       "dtype": dname, "tol": ELEM_TOL[dname],
                       "lse_max_abs_err": lse_err, "held": {"out": err}})
        if not err["ratio"] <= 1.0:
            failed.append(f"K3 {label} out: {err}")
        if not lse_err <= 1e-4:
            failed.append(f"K3 {label} lse: max abs error {lse_err} > 1e-4")
        if label == "ring":
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bound, bound_by = attention_bound_ms(q, k, False, 2, 4, 1)
            timing = {
                "shape": [B, T, 12, 64], "dtype": dname,
                "ms": time_ms(lambda: fa.splash_block_with_lse(q, k, v)),
                "plain_ms": time_ms(
                    lambda: fa.splash_block_with_lse_ref(q, k, v)),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, scale=1.0)),
                "bound_ms": bound, "bound_by": bound_by,
                "max_abs_err": err["max_abs_err"]}
    return {"name": "splash_block_with_lse",
            "replaces": "K3 attention.py:_splash_block_with_lse (ring block)",
            "checks": checks, **timing}, failed


# K4-K6 (the fused matmul+BN kernels): (kernel, label, M, K, N, dtype,
# relu). K4 is conv1 and K6 conv3 of a ResNet-50 bottleneck at bs 256,
# 224 x 224 (M = B*H*W), one shape of each stage group g0-g3; K5 is
# phase 13's second product (M 50176, C 256 -> 1024) and runs at K6's
# shapes too. Then f32, f16 and f64 at one shape, a ragged shape at
# every dtype, the ReLU off, and a shape whose K and N are not multiples
# of 8 ("unaligned": TMA cannot read it in place, so it takes the padded
# route, `fused_dense_bn.kernel_route`). The bf16 main-path shapes are
# timed.
FDB_GROUPS = {"k4": ((802816, 256, 64), (200704, 512, 128),
                     (50176, 1024, 256), (12544, 2048, 512)),
              "k6": ((802816, 64, 256), (200704, 128, 512),
                     (50176, 256, 1024), (12544, 512, 2048))}
FDB_GROUPS["k5"] = FDB_GROUPS["k6"]
FDB_KERNEL_CASES = tuple(
    [(k, f"g{i}", *shape, "bfloat16", True)
     for k in ("k4", "k5", "k6") for i, shape in enumerate(FDB_GROUPS[k])] +
    [(k, dt, 12544, 256, 256, dt, True) for k in ("k4", "k5", "k6")
     for dt in ("float32", "float16", "float64")] +
    [(k, f"ragged_{dt}", 1000, 72, 40, dt, True) for k in ("k4", "k5", "k6")
     for dt in ("bfloat16", "float32", "float16", "float64")] +
    [(k, "norelu", 12544, 256, 256, "bfloat16", False) for k in ("k5", "k6")] +
    [(k, "ragged_norelu", 1000, 72, 40, "bfloat16", False)
     for k in ("k5", "k6")] +
    [(k, "unaligned", 1000, 70, 36, "bfloat16", True)
     for k in ("k4", "k5", "k6")])
# the row of the kernels line: the mid stage's shape (g2), K5 at phase
# 13's product
FDB_LINE_SHAPE = "g2"
FDB_NAMES = {"k4": "matmul_stats_fwd", "k5": "bn_act_matmul_fwd",
             "k6": "bn_act_matmul_stats_fwd"}
FDB_REPLACES = {"k4": "paddle_tpu/ops/pallas/fused_dense_bn.py:80",
                "k5": "paddle_tpu/ops/pallas/fused_dense_bn.py:152",
                "k6": "paddle_tpu/ops/pallas/fused_dense_bn.py:254"}
# mean and var against the scale of the summed values, E[y^2]: the
# kernel sums the same accumulator in another order, which moves a sum
# of M terms by a few steps of that scale whatever the mean's own size
STATS_TOL = {"float32": 1e-5, "float64": 1e-12}


def fdb_bound_ms(M, K, N, dtype, prologue, stats):
    """Least time for one K4-K6 call: x, w and y read or written once,
    scale and shift (f32 or f64 [K]) and the partial sums ([M / BM, N],
    two rows of the accumulator's dtype) over the memory rate, against
    the product's 2 M K N operations over the dtype's peak (the
    prologue's 3 M K are not counted)."""
    import torch

    from paddle_tpu_torch.kernels import fused_dense_bn as fdb

    es = torch.tensor([], dtype=dtype).element_size()
    acc = 8 if dtype == torch.float64 else 4
    nbytes = (M * K + K * N + M * N) * es
    if prologue:
        nbytes += 2 * K * acc
    if stats:
        nbytes += 2 * -(-M // fdb.block_m(dtype)) * N * acc
    peak = BF16_FLOPS_PER_S if dtype in (torch.bfloat16, torch.float16) \
        else F32_FLOPS_PER_S
    return bound_ms(nbytes, 2 * M * K * N, peak)


def _fdb_case(fdb, kernel, M, K, N, dname, relu, gen):
    """Inputs of one case and its readings: y per element under
    ELEM_TOL, mean and var under STATS_TOL."""
    import torch

    dtype = getattr(torch, dname)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5) \
        .to(dtype)
    args = (x, w)
    if kernel != "k4":
        scale = torch.rand(K, generator=gen, device="cuda", dtype=acc) + 0.5
        shift = torch.randn(K, generator=gen, device="cuda", dtype=acc) * 0.5
        args = (x, scale, shift, w)
    kw = {} if kernel == "k4" else {"relu": relu}
    fn = getattr(fdb, FDB_NAMES[kernel])
    ref = {"k4": fdb.mm_stats_ref, "k5": fdb.bn_mm_ref,
           "k6": fdb.bn_mm_stats_ref}[kernel]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = ref(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = {"y": held(got[0], want[0], dname)}
    if len(got) == 3:
        tol = STATS_TOL["float64" if dtype == torch.float64 else "float32"]
        mean, var = want[1].double(), want[2].double()
        ey2 = var + mean * mean
        errs["mean_ratio"] = ((got[1].double() - mean).abs() /
                              (tol * (mean.abs() + ey2.sqrt()))).max().item()
        errs["var_ratio"] = ((got[2].double() - var).abs() /
                             (tol * (var.abs() + ey2))).max().item()
    return (fn, ref, args, kw), errs


def _fdb_kernel_rows():
    """K4, K5 and K6 against their plain versions at every case, and
    their times at the timed ones. Returns the kernel rows, every case's
    readings and the failed checks."""
    import torch

    from paddle_tpu_torch.kernels import fused_dense_bn as fdb

    gen = torch.Generator(device="cuda").manual_seed(12)
    checks, timings, failed = [], {"k4": {}, "k5": {}, "k6": {}}, []
    for kernel, label, M, K, N, dname, relu in FDB_KERNEL_CASES:
        (fn, ref, args, kw), errs = _fdb_case(fdb, kernel, M, K, N, dname,
                                              relu, gen)
        x, w = args[0], args[-1]
        checks.append({"kernel": kernel, "case": label, "shape": [M, K, N],
                       "dtype": dname, "relu": relu, "tol": ELEM_TOL[dname],
                       "route": fdb.kernel_route(K, N, x.dtype, x.data_ptr(),
                                                 w.data_ptr()),
                       "held": errs})
        ratios = [errs["y"]["ratio"]] + [errs[k] for k in
                                         ("mean_ratio", "var_ratio")
                                         if k in errs]
        if not all(r <= 1.0 for r in ratios):
            failed.append(f"{kernel} {label}: {errs}")
        if dname == "bfloat16" and label.startswith("g"):
            bound = fdb_bound_ms(M, K, N, x.dtype, kernel != "k4",
                                 kernel != "k5")
            timings[kernel][label] = {
                "shape": [M, K, N], "ms": time_ms(lambda: fn(*args, **kw)),
                "plain_ms": time_ms(lambda: ref(*args, **kw)),
                # cuBLAS's bf16 product alone: no one PyTorch call
                # computes the fused function, and the product is its floor
                "library_ms": time_ms(lambda: torch.matmul(x, w)),
                "bound": bound}
        del args, x, w
    check(all(c["route"] == "padded" for c in checks
              if c["case"] == "unaligned"),
          "K4-K6: a shape TMA cannot read did not take the padded route")
    rows = []
    for kernel in ("k4", "k5", "k6"):
        bf16 = [c for c in checks if c["kernel"] == kernel and
                c["dtype"] == "bfloat16"]
        rows.append({"name": FDB_NAMES[kernel], "kernel": kernel.upper(),
                     "replaces": FDB_REPLACES[kernel],
                     "max_abs_err": max(c["held"]["y"]["max_abs_err"]
                                        for c in bf16),
                     "library": "torch.matmul (cuBLAS product only)",
                     "timings": timings[kernel]})
    return rows, checks, failed


def phase_kernels():
    serving = _serving_kernel_row()
    training, checks, whole, failed = _training_kernel_rows()
    k2_rows, k2_checks, k2_whole, k2_failed = _k2_kernel_rows()
    k3_row, k3_failed = _k3_kernel_row()
    k1_fwd, k1_fwd_failed = _k1_fwd_rows()
    k1_bwd_long, k1_bwd_long_failed = _k1_bwd_long()
    t0 = time.perf_counter()
    fdb_rows, fdb_checks, fdb_failed = _fdb_kernel_rows()
    print(json.dumps({"phase": "kernels",
                      "kernels": [serving] + training + k2_rows + [k3_row] +
                      fdb_rows,
                      "bwd_whole": whole, "training_checks": checks,
                      "k1_fwd": k1_fwd, "k1_bwd_long": k1_bwd_long,
                      "k2_bwd_whole": k2_whole, "k2_checks": k2_checks,
                      "fdb_checks": fdb_checks,
                      "fdb_s": time.perf_counter() - t0}))
    failed += (k2_failed + k3_failed + k1_fwd_failed + k1_bwd_long_failed +
               fdb_failed)
    check(not failed, "kernel against its plain version: " +
          "; ".join(failed))
    return serving, training, k2_rows, k3_row, fdb_rows


def _generate(port, ids, max_new, out):
    """One streamed /v1/generate; fills `out` with the token lines, the
    done record and the client-side time to the first token."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps({"ids": [int(i) for i in ids],
                         "max_new_tokens": max_new}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    toks, done = [], None
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            for line in r:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if "token" in rec:
                    if not toks:
                        out["ttft_s"] = time.perf_counter() - t0
                    toks.append(rec["token"])
                else:
                    done = rec
    except Exception as e:  # reported and checked by the caller
        out["error"] = f"{type(e).__name__}: {e}"
    out["tokens"], out["done"] = toks, done


SLICE_LENGTHS = (5, 17, 60, 130, 300, 513, 900, 1000)
SLICE_NEW_TOKENS = 24


def _slice_setup():
    """GPT-2-small (seeded random weights) in a bf16 engine, and the
    slice's prompts: one per prefill bucket from 8 to 1024."""
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = gpt.GPTConfig()                       # GPT-2-small, bf16
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(0),
                         cfg, device="cuda")
    engine = DecodeEngine(params, cfg, DecodeConfig(
        block_size=16, num_blocks=512, decode_slots=(4, 8)), device="cuda")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, size=n) for n in SLICE_LENGTHS]
    return cfg, engine, prompts


def phase_slice():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.serving import Server, ServingConfig

    cfg, engine, prompts = _slice_setup()
    lengths, max_new = list(SLICE_LENGTHS), SLICE_NEW_TOKENS
    server = Server(ServingConfig(), decode=engine)
    t0 = time.perf_counter()
    port = server.start(0)                      # warms, then binds
    start_s = time.perf_counter() - t0
    try:
        ops = _serving_routes(port, engine)

        def http_round():
            results = [{} for _ in prompts]
            threads = [threading.Thread(target=_generate, daemon=True,
                                        args=(port, p, max_new, out))
                       for p, out in zip(prompts, results)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            return results, time.perf_counter() - t0

        fa.flash_attention.launches = 0
        attn.GATE_COUNTS.clear()
        results, wall = http_round()
        launches = fa.flash_attention.launches
        gates = dict(attn.GATE_COUNTS)
        # the same requests again: every shape is now warm in-process
        repeat, repeat_wall = http_round()
        status = engine.status()
    finally:
        server.stop()
    for n, out in zip(lengths + lengths, results + repeat):
        check("error" not in out, f"prompt {n}: {out.get('error')}")
        toks = out["tokens"]
        check(len(toks) == max_new, f"prompt {n}: {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"prompt {n}: token out of range")
        check(out["done"] and out["done"].get("done")
              and out["done"].get("finish_reason") == "length",
              f"prompt {n}: done record {out['done']}")
    check(launches >= cfg.layers * len(lengths),
          f"{launches} kernel launches < {cfg.layers} x {len(lengths)}")
    check(gates.get("plain", 0) == 0, f"plain attention ran: {gates}")
    steps = status["decode_steps"]
    check(steps["eager"] == 0 and steps["replayed"] > 0,
          f"slice: decode steps of the warmed engine {steps}")

    def summary(res, secs):
        ttft = sorted(out["ttft_s"] * 1e3 for out in res)
        n_tok = sum(len(out["tokens"]) for out in res)
        return {"tokens": n_tok, "wall_s": secs,
                "tokens_per_s": n_tok / secs,
                "ttft_p50_ms": statistics.median(ttft),
                "ttft_max_ms": ttft[-1]}

    row = {"phase": "slice", "model": "GPT-2-small (GPTConfig())",
           "precision": "bf16", "requests": len(lengths),
           "prompt_lengths": lengths, **summary(results, wall),
           "repeat": summary(repeat, repeat_wall),
           "launches": {"flash_attention_fwd": launches},
           "gate_counts": gates,
           "preempted": status["requests"]["preempted"],
           "start_s": start_s, "decode_steps": steps, "routes": ops}
    print(json.dumps(row))
    return launches


def _get_json(port, path):
    """(status, JSON body, headers) of one GET on the serving port."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _serving_routes(port, engine):
    """The warmed server's operations surface: /v1/healthz 200
    "serving", /v1/load and /v1/models with the JAX server's keys, each
    reply with its request id and traceparent."""
    code, health, hdrs = _get_json(port, "/v1/healthz")
    check(code == 200 and health.get("state") == "serving",
          f"/v1/healthz: {code} {health}")
    check(len(hdrs.get("X-Request-Id", "")) == 32 and
          hdrs.get("traceparent", "").startswith("00-"),
          f"/v1/healthz headers: {dict(hdrs)}")
    code, load, _ = _get_json(port, "/v1/load")
    check(code == 200 and set(load) == {"load", "inflight", "queue_depth",
                                        "state", "models"}
          and load["state"] == "serving" and load["models"] == ["default"],
          f"/v1/load: {code} {load}")
    t0 = time.perf_counter()
    code, models, _ = _get_json(port, "/v1/models")
    models_s = time.perf_counter() - t0
    rows = models.get("models") or [{}]
    check(code == 200 and len(rows) == 1 and rows[0].get("id") == "default"
          and rows[0].get("decode", {}).get("warmed") is True
          and len(rows[0]["decode"].get("digest", "")) == 64,
          f"/v1/models: {code} {models}")
    status = engine.status()
    check(status["warmed"] and status["analysis"]["errors"] == 0,
          f"engine status: {status}")
    return {"healthz": health, "load": load, "models": rows,
            "models_s": models_s, "analysis": status["analysis"]}


def _fdb_kernel(name):
    """"k4", "k5" or "k6" for a fused matmul+BN kernel's profiler name
    (its template flags: prologue, stats), else None."""
    if "fused_mm_bn" not in name:
        return None
    flags = ("true, true", "true, false", "false, true")
    mangled = ("Lb1ELb1E", "Lb1ELb0E", "Lb0ELb1E")
    for kern, f, m in zip(("k6", "k5", "k4"), flags, mangled):
        if f in name or m in name:
            return kern
    return None


def _device_time(prof, wall_s):
    """From a torch.profiler run over `wall_s` seconds: the device's
    busy time (the union of its kernel intervals), idle share, K1's,
    K2's and K4-K6's kernel time by kernel and the ten largest kernels
    by name."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        tot = by_name.setdefault(e.name, [0, 0.0])
        tot[0] += 1
        tot[1] += (e.time_range.end - e.time_range.start) / 1e3
    busy_us, last = 0.0, None
    for a, b in sorted(spans):          # union of the device intervals
        if last is None or a > last:
            busy_us += b - a
            last = b
        elif b > last:
            busy_us += b - last
            last = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    busy_ms = busy_us / 1e3 if spans else None
    # the FMA kernels (f32) and the Hopper ones (bf16, f16): device ms,
    # and K2's launches, by kernel
    k1, k2 = ({kern: sum(t[1] for n, t in by_name.items() if kern in n)
               for kern in kerns} for kerns in (
        ("flash_fwd_kernel", "flash_fwd_sm90_kernel", "delta_kernel",
         "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
         "flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel"),
        [kern for r in K2_ROUTES.values() for kern in r.values()]))
    k2_n = {kern: sum(t[0] for n, t in by_name.items() if kern in n)
            for kern in k2}
    delta_n = sum(t[0] for n, t in by_name.items() if "delta_kernel" in n)
    fdb = {"k4": 0.0, "k5": 0.0, "k6": 0.0}
    for n, t in by_name.items():
        kern = _fdb_kernel(n)
        if kern:
            fdb[kern] += t[1]
    return {"device_events": len(spans), "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / (wall_s * 1e3))
            if spans else None,
            "flash_attention_ms": k1["flash_fwd_kernel"] +
            k1["flash_fwd_sm90_kernel"],
            "k1_kernel_ms": k1, "k2_kernel_ms": k2, "k2_kernel_launches": k2_n,
            "delta_kernel_records": delta_n,
            "k4_k6_kernel_ms": fdb,
            "top_kernels": [{"name": n[:90], "count": c, "ms": ms}
                            for n, (c, ms) in top]}


def _decode_step_times(engine, reps=20):
    """The decode step at each slot count of a warmed engine, eager
    against its graph's replay, on all-zero inputs (every write lands in
    the null block; the step gathers every slot's full table either
    way): the host's time to issue one step, and the time between CUDA
    events around it. A replay issues its kernels back to back, so its
    event time is the step's device time; the eager step's span also
    holds the host's gaps."""
    import torch

    out = {}
    with torch.inference_mode():
        for S in engine.decode_slots:
            ids, positions, tables = engine._step_buffers(S)
            row = {}
            for kind, fn in (
                    ("eager", lambda: engine._decode_step(ids, positions,
                                                          tables)),
                    ("replay", engine._graphs[S].graph.replay)):
                for _ in range(3):
                    fn()
                host, device = [], []
                for _ in range(reps):
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    t0 = time.perf_counter()
                    fn()
                    host.append((time.perf_counter() - t0) * 1e3)
                    end.record()
                    end.synchronize()
                    device.append(start.elapsed_time(end))
                row[kind] = {"host_ms": statistics.median(host),
                             "event_ms": statistics.median(device)}
            out[f"S{S}"] = row
    return out


def _graph_pool_bytes(pool):
    """Bytes of the caching allocator's segments in the graphs' private
    pool (torch.cuda.memory_snapshot), or None when the snapshot does
    not name segment pools."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def phase_profile():
    """The slice's requests straight into fresh engines (no HTTP, in a
    process whose kernels phase 3 already loaded): first one never
    warmed (every decode step eager), then one warmed (every decode
    step a CUDA graph replay). Each takes two rounds timed on the host
    clock, then one under torch.profiler for the device's busy time and
    its largest kernels; the two engines' tokens must be equal
    (ROADMAP item 2's gate). The warmed engine also reports its
    warmup's seconds, the graphs' memory and the decode step's host
    and device time at each slot count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rows, tokens, extra = {}, {}, {}
    for label in ("eager", "graphs"):
        _, engine, prompts = _slice_setup()
        got = []

        def run_round():
            t0 = time.perf_counter()
            handles = [engine.submit(p, max_new_tokens=SLICE_NEW_TOKENS)
                       for p in prompts]
            toks = [h.result(timeout_s=600) for h in handles]
            wall = time.perf_counter() - t0
            check(all(len(t) == SLICE_NEW_TOKENS for t in toks),
                  "profile round: short generation")
            got.append(toks)
            ttft = sorted(h.info["ttft_s"] * 1e3 for h in handles)
            n = sum(len(t) for t in toks)
            return {"wall_s": wall, "tokens_per_s": n / wall,
                    "ttft_p50_ms": statistics.median(ttft),
                    "ttft_max_ms": ttft[-1]}

        try:
            if label == "graphs":
                torch.cuda.synchronize()
                reserved = torch.cuda.memory_stats()[
                    "reserved_bytes.all.current"]
                t0 = time.perf_counter()
                ready = engine.warmup()
                extra["warmup_s"] = time.perf_counter() - t0
                check(ready == len(engine.prefill_buckets) +
                      len(engine.decode_slots), f"warmup: {ready} phases")
                extra["warmup_reserved_bytes"] = torch.cuda.memory_stats()[
                    "reserved_bytes.all.current"] - reserved
                extra["graph_pool_bytes"] = _graph_pool_bytes(
                    engine._graph_pool)
                extra["decode_step"] = _decode_step_times(engine)
            first = run_round()
            second = run_round()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                profiled = run_round()
            steps = engine.status()["decode_steps"]
        finally:
            engine.stop()
        profiled.update(_device_time(prof, profiled["wall_s"]))
        rows[label] = {"first": first, "second": second,
                       "profiled": profiled, "decode_steps": steps}
        tokens[label] = got
        del engine, prof
        torch.cuda.empty_cache()
    check(rows["eager"]["decode_steps"]["replayed"] == 0 and
          rows["graphs"]["decode_steps"]["eager"] == 0 and
          rows["graphs"]["decode_steps"]["replayed"] > 0,
          f"profile: decode steps {rows['eager']['decode_steps']} (eager), "
          f"{rows['graphs']['decode_steps']} (graphs)")
    check(tokens["graphs"] == tokens["eager"],
          "profile: the warmed engine's tokens differ from the unwarmed "
          "engine's")
    print(json.dumps({"phase": "profile", "requests": len(SLICE_LENGTHS),
                      "tokens_equal": True, **rows, **extra}))


def phase_greedy():
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = gpt.GPTConfig(layers=2, dtype="float32")
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(1), cfg,
                         device="cuda")
    engine = DecodeEngine(params, cfg, DecodeConfig(
        block_size=16, num_blocks=256, decode_slots=(4,), precision="f32"),
        device="cuda")
    rs = np.random.RandomState(1)
    prompts = [list(rs.randint(0, cfg.vocab_size, size=n)) for n in (7, 40)]
    max_new = 16
    try:
        handles = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
        got = [h.result(timeout_s=600) for h in handles]
    finally:
        engine.stop()
    report = []
    with torch.inference_mode():
        for prompt, toks in zip(prompts, got):
            check(len(toks) == max_new, f"greedy: {len(toks)} tokens")
            seq = [int(t) for t in prompt]
            equal, margin_at_split = 0, None
            for tok in toks:
                logits = gpt.apply(params, cfg, torch.tensor(
                    [seq], device="cuda"))[0, -1].double()
                want = int(logits.argmax())
                if want != tok:
                    top2 = torch.topk(logits, 2).values
                    margin_at_split = float(top2[0] - top2[1])
                    # only a near-tie may flip; later tokens then follow
                    # different prefixes and are not compared
                    check(margin_at_split < 1e-4,
                          f"greedy token {equal} differs ({tok} vs {want}) "
                          f"at top-2 margin {margin_at_split}")
                    break
                equal += 1
                seq.append(want)
            report.append({"prompt_len": len(prompt), "equal": equal,
                           "margin_at_split": margin_at_split})
    print(json.dumps({"phase": "greedy", "model": "GPTConfig(layers=2), f32",
                      "tokens_per_prompt": max_new, "prompts": report}))


LR = 1e-4


def _adamw(params):
    """The counterpart of optax.adamw(1e-4), bench.py's optimizer: b1
    0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every param."""
    import torch

    return torch.optim.AdamW(params, lr=LR, weight_decay=1e-4)


K1_TRAIN = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq")
K2_NAMES = ("flash_attention_bias_fwd", "flash_attention_bias_bwd_dkv",
            "flash_attention_bias_bwd_dq")
# the standalone delta launch, and the dq launches of K1 and K2 that
# folded the delta pass into their prologue (bf16 and f16)
DELTA = "flash_attention_bwd_delta"
K1_FOLD = "flash_attention_bwd_dq.delta_folds"
K2_FOLD = "flash_attention_bias_bwd_dq.delta_folds"


def k1_per_step(layers):
    """K1's launches a bf16 training step of `layers` attention layers:
    the forward with its LSE, and dq, folding the delta pass in, then
    dkv."""
    return {**dict.fromkeys(K1_TRAIN, layers), K1_FOLD: layers}


def _kernel_counts(reset=False):
    """Every kernel wrapper's launch count and the dq wrappers' delta
    folds, set to 0 first with reset."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import flash_attention_bias as fb
    from paddle_tpu_torch.kernels import fused_dense_bn as fdb

    fns = {name: getattr(fdb, name) for name in FDB_NAMES.values()}
    fns.update({"flash_attention_fwd": fa.flash_attention,
           "flash_attention_fwd_lse": fa.flash_attention_with_lse,
           "splash_block_with_lse": fa.splash_block_with_lse,
           DELTA: fa.attention_delta,
           "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
           "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
           "flash_attention_bias_fwd": fb.flash_attention_bias_fwd,
           "flash_attention_bias_bwd_dkv": fb.flash_attention_bias_bwd_dkv,
           "flash_attention_bias_bwd_dq": fb.flash_attention_bias_bwd_dq})
    folds = {K1_FOLD: fa.flash_attention_bwd_dq,
             K2_FOLD: fb.flash_attention_bias_bwd_dq}
    if reset:
        for fn in fns.values():
            fn.launches = 0
        for fn in folds.values():
            fn.delta_folds = 0
    return {**{name: fn.launches for name, fn in fns.items()},
            **{name: fn.delta_folds for name, fn in folds.items()}}


def phase_train_parity():
    """One f32 train step of a 2-layer, full-width BERT on the card and
    on the CPU from the same params and batch, at `_hold_train_step`'s
    tolerances (the card's loss, gradients and updated params against
    the CPU's)."""
    import torch

    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(layers=2, dtype="float32")
    params, _ = bert.init(torch.Generator().manual_seed(2), cfg,
                          device="cpu")
    batch = bert.make_batch(np.random.RandomState(2), cfg, 4, seq_len=128,
                            device="cpu")

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=True)

    cuda = _one_train_step(loss_fn, params, batch, "cuda")
    cpu = _one_train_step(loss_fn, params, batch, "cpu")
    kc = cuda["counts"]
    # f32: K1's FMA dq takes delta from the standalone launch
    want = {**dict.fromkeys(K1_TRAIN, cfg.layers), DELTA: cfg.layers}
    check(all(n == want.get(name, 0) for name, n in kc.items()),
          f"train-parity: the CUDA step ran {kc} launches")
    print(json.dumps({"phase": "train-parity",
                      "model": "BertConfig(layers=2), f32, 4 x 128",
                      **_hold_train_step("train-parity", cuda, cpu, params),
                      "launches": kc}))


def _one_train_step(loss_fn, params, batch, dev):
    """On `dev`: the loss and every gradient at `params`, then one
    AdamW `make_train_step` step (f32) from them, with the kernels'
    launches over that step."""
    import torch

    from paddle_tpu_torch.parallel.train import make_train_step

    p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
    b = {k: v.to(dev) for k, v in batch.items()}
    loss = loss_fn(p, b, None)
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    grads = {k: (torch.zeros_like(v) if g is None else g).cpu()
             for (k, v), g in zip(p.items(), grads)}
    _kernel_counts(reset=True)
    init, step = make_train_step(loss_fn, _adamw, device=dev,
                                 precision="f32")
    state, step_loss = step(init(params), b, 0)
    return {"loss": loss.item(), "grads": grads,
            "params": {k: v.detach().cpu() for k, v in state.params.items()},
            "step_loss": step_loss.item(), "counts": _kernel_counts()}


def _hold_train_step(label, got, want, params):
    """`got` against `want` (two `_one_train_step` results) at f32:
    loss within 1e-5 relative; each gradient within 2e-4 of its tensor's
    largest `want` value plus 1e-7 (f32 sums in other orders through two
    layers; the floor is for the key biases, whose exact gradient is 0,
    since a shift of every key adds a constant to a row's logits, and
    whose computed one is rounding noise of about 1e-9 on both sides);
    the updated params: every update within 2 lr of `want`'s (AdamW's
    first step moves each element by about lr times the sign of its
    gradient, so a gradient near zero may move the other way), and at
    most 0.1% of the elements more than 1e-6 apart."""
    lc, lp = got["loss"], want["loss"]
    slc, slp = got["step_loss"], want["step_loss"]
    check(abs(lc - lp) <= 1e-5 * abs(lp) and abs(slc - slp) <= 1e-5 * abs(slp),
          f"{label} loss {lc} vs {lp}")
    gc, gp = got["grads"], want["grads"]
    grad_err = sorted((((gc[k] - gp[k]).abs().max() /
                        (2e-4 * gp[k].abs().max() + 1e-7)).item(), k,
                       gp[k].abs().max().item()) for k in gp)[::-1]
    check(grad_err[0][0] <= 1.0,
          f"{label} grads: worst (error / tolerance, name, largest "
          f"reference value) {grad_err[:3]}")
    upd_err, n_far, n_all = 0.0, 0, 0
    for k, p0 in params.items():
        d = ((got["params"][k] - p0) - (want["params"][k] - p0)).abs()
        upd_err = max(upd_err, d.max().item())
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    check(upd_err <= 2 * LR and n_far <= 1e-3 * n_all,
          f"{label} params: max update difference {upd_err}, "
          f"{n_far} of {n_all} elements more than 1e-6 apart")
    return {"loss_got": lc, "loss_want": lp,
            "grad_err_over_tol_worst3": grad_err[:3],
            "param_update_max_abs_err": upd_err,
            "param_elements_apart": n_far, "param_elements": n_all}


def _train_run(label, loss_fn, params, batch, flops_per_sample, warmup,
               steps, per_step, optimizer=None, precision="mixed_bf16",
               has_aux=False, trace_ok=None):
    """`warmup` + `steps` steps on one fixed batch (AdamW and mixed_bf16
    unless given; `has_aux` for a loss_fn that also returns state
    updates); the kernels' counts are set to 0 just before the
    timed steps and read just after, and each must equal `per_step`
    ({name: launches a step}, 0 for every kernel it does not name)
    times the steps; then one step is traced under torch.profiler for
    the device's busy time against that step's wall time. With
    `trace_ok` (a check of the traced step's summary that raises on a
    wrong kernel and returns False on a short count), a trace it
    returns False on is taken again, up to TRACE_TRIES times: the
    profiler can drop a kernel's record (one K2-fwd record of 12 once
    on an H100), while the counts above are the wrappers' own. Where
    `per_step` names no standalone delta launch (the bf16 paths, whose
    dq kernels fold the delta pass in), a traced step that shows a
    `delta_kernel` record fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from paddle_tpu_torch.parallel.train import make_train_step

    init, step = make_train_step(loss_fn, optimizer or _adamw,
                                 device="cuda", precision=precision,
                                 has_aux=has_aux)
    state = init(params)
    del params
    n = next(iter(batch.values())).shape[0]
    losses = []
    for i in range(warmup):
        state, loss = step(state, batch, i)
        losses.append(loss.item())
    torch.cuda.synchronize()
    counts = _kernel_counts(reset=True)
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, batch, warmup + i)
        losses.append(loss.item())      # also waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _kernel_counts()
    # two more steps under the profiler (device activity only, one
    # cycle): the first absorbs the tracer's start-up, the second is
    # recorded
    traces, i = [], warmup + steps
    while True:
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, batch, i)
                i += 1
                loss.item()
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                prof.step()
        profiled = _device_time(prof, wall_s)
        profiled["wall_ms"] = wall_s * 1e3
        traces.append(profiled)
        if (trace_ok is None or trace_ok(profiled)
                or len(traces) == TRACE_TRIES):
            break
    check(trace_ok is None or trace_ok(profiled),
          f"{label}: {len(traces)} traced steps each short of a kernel: "
          f"{[t['k2_kernel_launches'] for t in traces]}")
    check(per_step.get(DELTA, 0) or
          not any(t["delta_kernel_records"] for t in traces),
          f"{label}: a traced step ran the standalone delta_kernel: "
          f"{[t['delta_kernel_records'] for t in traces]}")
    ms = statistics.median(times)
    samples_s = n / (ms / 1e3)
    row = {"run": label, "batch": n, "warmup": warmup, "steps": steps,
           "step_ms_median": ms, "step_ms_min": min(times),
           "step_ms_max": max(times), "samples_per_s": samples_s,
           "flops_per_sample": flops_per_sample,
           "mfu": flops_per_sample * samples_s / BF16_FLOPS_PER_S,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "launches": counts,
           "launches_per_step": {k: v / steps for k, v in counts.items()},
           "loss_scale": state.loss_scale, "precision": precision,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profiled_step": profiled, "traces": len(traces),
           "k2_launches_per_trace": [t["k2_kernel_launches"]
                                     for t in traces]}
    check(all(np.isfinite(losses)), f"{label}: nonfinite loss {losses}")
    check(losses[-1] < losses[0],
          f"{label}: loss did not fall ({losses[0]} -> {losses[-1]})")
    for name, n in counts.items():
        want = per_step.get(name, 0)
        check(n == want * steps,
              f"{label}: {name} launched {n} times in {steps} steps, not "
              f"{want} a step")
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return row


def phase_train():
    """BERT-base pretraining (bench.py bench_bert's model and optimizer,
    dropout on as there) under mixed_bf16, at the first rung of its
    ladder (256 x 128) and at 32 x 512."""
    import torch

    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=False)

    rows, counts = [], {}
    for B, T in ((256, 128), (32, 512)):
        params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
        batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(1),
                                cfg, B, seq_len=T)
        P = batch["masked_positions"].shape[1]
        row = _train_run(f"bert-base {B}x{T}", loss_fn, params, batch,
                         cfg.train_flops_per_seq(T, P), 3, 20,
                         k1_per_step(cfg.layers))
        row["masked_per_seq"] = P
        rows.append(row)
        for k, v in row["launches"].items():
            counts[k] = counts.get(k, 0) + v
    print(json.dumps({"phase": "train", "model": "BERT-base "
                      "(BertConfig.base()), mixed_bf16, dropout 0.1",
                      "optimizer": "AdamW lr 1e-4 wd 1e-4",
                      "runs": rows}))
    return counts, rows[1]


def gpt_train_flops_per_seq(cfg, T):
    """Training FLOPs per sequence of the dense GPT: 3x forward; forward
    = 2*T*(per-layer matmul params + tied vocab head) + the causal
    attention products (QK^T and PV over T(T+1)/2 pairs)."""
    H, L = cfg.hidden, cfg.layers
    matmul = L * (4 * H * H + 2 * H * cfg.mlp_dim) + H * cfg.vocab_size
    fwd = 2 * T * matmul + L * 4 * H * T * (T + 1) / 2
    return 3 * fwd


def phase_gpt_train():
    """GPT-2-small `lm_loss` under mixed_bf16 at 8 x 1024: the causal
    backward kernel on a real path."""
    import torch

    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig()
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(3), cfg,
                         device="cuda")
    batch = gpt.make_batch(torch.Generator(device="cuda").manual_seed(4),
                           cfg, 8)

    def loss_fn(p, b, g):
        return gpt.lm_loss(p, cfg, b, rng=g)

    row = _train_run("gpt-2-small 8x1024", loss_fn, params, batch,
                     gpt_train_flops_per_seq(cfg, cfg.max_len), 2, 10,
                     k1_per_step(cfg.layers))
    print(json.dumps({"phase": "gpt-train", "model": "GPT-2-small "
                      "(GPTConfig()), mixed_bf16", "run": row}))
    return row["launches"]


def _adam(params):
    """The counterpart of optax.adam(1e-4), bench.py's Transformer
    optimizer: b1 0.9, b2 0.999, eps 1e-8, no weight decay."""
    import torch

    return torch.optim.Adam(params, lr=LR)


# per training step of Transformer-big: K2 in the 6 encoder self- and 6
# cross-attention calls, K1 in the 6 causal decoder self-attention
# calls; the delta pass of all 18 backwards folded into their dq
# kernels at bf16, K1's standalone delta launch at f32
def nmt_per_step(cfg):
    k2 = cfg.enc_layers + cfg.dec_layers
    n = {**dict.fromkeys(K2_NAMES, k2),
         **dict.fromkeys(K1_TRAIN, cfg.dec_layers)}
    if cfg.dtype == "float32":
        return {**n, DELTA: k2 + cfg.dec_layers}
    return {**n, K1_FOLD: cfg.dec_layers, K2_FOLD: k2}


def _k2_trace_ok(label, per_step):
    """A `trace_ok` for `_train_run`: in a traced step, each K2 launch of
    `per_step` ({name: launches a step}) never ran on its FMA kernel
    (raises), and ran on its Hopper kernel that many times (else False:
    the profiler may have dropped a record)."""
    def ok(profiled):
        n = profiled["k2_kernel_launches"]
        check(not any(n[kern["fma"]] for kern in K2_ROUTES.values()),
              f"{label}: the traced step ran a K2 FMA kernel: {n}")
        return all(n[kern["sm90"]] == per_step.get(name, 0)
                   for name, kern in K2_ROUTES.items())
    return ok


def _k2_bwd_ms(row):
    """K2-bwd's device ms (dkv, dq) in `row`'s traced step."""
    ms = row["profiled_step"]["k2_kernel_ms"]
    return {"dkv": ms[K2_ROUTES["flash_attention_bias_bwd_dkv"]["sm90"]],
            "dq": ms[K2_ROUTES["flash_attention_bias_bwd_dq"]["sm90"]]}


def phase_nmt_parity():
    """A 2 + 2-layer Transformer at Transformer-big's widths, f32 (TF32
    off), on the card (K1 and K2) and on the CPU (plain versions) from
    the same params and a ragged batch: the loss within 1e-5 relative,
    each gradient within 2e-4 of its tensor's largest CPU value plus
    1e-7 (phase 6's rule: f32 sums in other orders through four
    layers), and one Adam step's params within 2 lr (Adam's first step
    moves each element by about lr times the sign of its gradient, so a
    gradient near zero may move the other way). Then `beam_search` on 2
    sources, beam 4, 16 steps: the same tokens, scores within 1e-5
    relative, from the step's starting params."""
    import torch

    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parallel.train import make_train_step

    cfg = transformer.TransformerConfig.big()
    cfg.enc_layers = cfg.dec_layers = 2
    cfg.dtype = "float32"
    params, _ = transformer.init(torch.Generator().manual_seed(6), cfg,
                                 device="cpu")
    batch = transformer.make_batch(np.random.RandomState(6), cfg, 4, 128,
                                   128, device="cpu")

    def loss_fn(p, b, g):
        return transformer.nmt_loss(p, cfg, b, rng=g)

    result = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        b = {k: v.to(dev) for k, v in batch.items()}
        loss = loss_fn(p, b, None)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g).cpu()
                 for (k, v), g in zip(p.items(), grads)}
        _kernel_counts(reset=True)
        init, step = make_train_step(loss_fn, _adam, device=dev,
                                     precision="f32")
        state, step_loss = step(init(params), b, 0)
        counts = _kernel_counts()
        with torch.inference_mode():     # from the shared params
            toks, scores = transformer.beam_search(
                p, cfg, b["src_ids"][:2], b["src_len"][:2], beam_size=4,
                max_len=16)
        result[dev] = (loss.item(), grads,
                       {k: v.detach().cpu() for k, v in state.params.items()},
                       counts, toks.cpu(), scores.cpu())
    (lc, gc, pc, kc, tc, sc), (lp, gp, pp, _, tp, sp) = \
        result["cuda"], result["cpu"]
    want = nmt_per_step(cfg)
    check(all(kc[name] == want.get(name, 0) for name in kc),
          f"nmt-parity: the CUDA step ran {kc} launches, not {want}")
    check(abs(lc - lp) <= 1e-5 * abs(lp), f"nmt-parity loss {lc} vs {lp}")
    grad_err = sorted((((gc[k] - gp[k]).abs().max() /
                        (2e-4 * gp[k].abs().max() + 1e-7)).item(), k,
                       gp[k].abs().max().item()) for k in gp)[::-1]
    check(grad_err[0][0] <= 1.0,
          f"nmt-parity grads: worst (error / tolerance, name, largest CPU "
          f"value) {grad_err[:3]}")
    upd_err, n_far, n_all = 0.0, 0, 0
    for k, p0 in params.items():
        d = ((pc[k] - p0) - (pp[k] - p0)).abs()
        upd_err = max(upd_err, d.max().item())
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    check(upd_err <= 2 * LR, f"nmt-parity params: max update difference "
                             f"{upd_err}")
    check(torch.equal(tc, tp), f"nmt-parity beam tokens differ: {tc} vs {tp}")
    score_err = ((sc - sp).abs() / sp.abs()).max().item()
    check(score_err <= 1e-5, f"nmt-parity beam scores: {sc} vs {sp}")
    print(json.dumps({"phase": "nmt-parity",
                      "model": "TransformerConfig.big() widths, 2 + 2 "
                               "layers, f32, 4 x (128, 128)",
                      "src_len": batch["src_len"].tolist(),
                      "tgt_len": batch["tgt_len"].tolist(),
                      "loss_cuda": lc, "loss_cpu": lp,
                      "grad_err_over_tol_worst3": grad_err[:3],
                      "param_update_max_abs_err": upd_err,
                      "param_elements_apart": n_far, "param_elements": n_all,
                      "beam_scores_cuda": sc.tolist(),
                      "beam_score_max_rel_err": score_err,
                      "launches": kc}))


def phase_nmt_train():
    """Transformer-big (bench.py bench_transformer_big's model, optimizer
    and first rung: 128 pairs of 128 x 128 tokens, Adam(1e-4), policy
    f32 with bf16 compute) on one `make_batch` batch."""
    import torch

    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig.big()
    params, _ = transformer.init(
        torch.Generator(device="cuda").manual_seed(7), cfg, device="cuda")
    batch = transformer.make_batch(
        torch.Generator(device="cuda").manual_seed(8), cfg, 128, 128, 128)

    def loss_fn(p, b, g):
        return transformer.nmt_loss(p, cfg, b, rng=g)

    n_params = sum(v.numel() for v in params.values())
    per_step = nmt_per_step(cfg)
    row = _train_run("transformer-big 128x(128,128)", loss_fn, params, batch,
                     cfg.train_flops_per_seq(128, 128), 3, 20, per_step,
                     optimizer=_adam, precision="f32",
                     trace_ok=_k2_trace_ok("nmt-train", per_step))
    row["k2_bwd_device_ms"] = _k2_bwd_ms(row)
    print(json.dumps({"phase": "nmt-train",
                      "model": "Transformer-big (TransformerConfig.big()), "
                               "f32 params, bf16 compute",
                      "optimizer": "Adam lr 1e-4", "params": n_params,
                      "src_len_mean": batch["src_len"].float().mean().item(),
                      "tgt_len_mean": batch["tgt_len"].float().mean().item(),
                      "run": row}))
    return row["launches"]


def phase_nmt_beam():
    """Transformer-big `beam_search` under inference_mode: 8 sources of
    128 tokens with ragged lengths, beam 4, 32 steps, run twice (the
    launch counts are read around the first)."""
    import torch

    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig.big()
    params, _ = transformer.init(
        torch.Generator(device="cuda").manual_seed(9), cfg, device="cuda")
    batch = transformer.make_batch(
        torch.Generator(device="cuda").manual_seed(10), cfg, 8, 128, 32)
    K, L = 4, 32
    walls = []
    with torch.inference_mode():
        for i in range(2):
            if i == 0:
                _kernel_counts(reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, scores = transformer.beam_search(
                params, cfg, batch["src_ids"], batch["src_len"],
                beam_size=K, max_len=L)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                counts = _kernel_counts()
    want = {"flash_attention_bias_fwd": cfg.enc_layers + cfg.dec_layers * L,
            "flash_attention_fwd": cfg.dec_layers * L}
    check(all(n == want.get(name, 0) for name, n in counts.items()),
          f"nmt-beam: launches {counts}, not {want}")
    check(toks.shape == (8, K, L), f"nmt-beam: tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.tgt_vocab)).all()),
          "nmt-beam: token out of range")
    check(bool(torch.isfinite(scores).all()) and
          bool((scores[:, :-1] >= scores[:, 1:]).all()),
          f"nmt-beam: scores not finite and sorted: {scores}")
    print(json.dumps({"phase": "nmt-beam",
                      "model": "Transformer-big, bf16 compute",
                      "sources": 8, "beam": K, "max_len": L,
                      "src_len": batch["src_len"].tolist(),
                      "wall_ms": walls, "best_scores": scores[:, 0].tolist(),
                      "launches": counts}))
    return counts


def phase_bert_padded(unpadded):
    """BERT-base at 32 x 512 with an attention_mask (lengths uniform in
    [256, 512] from a seed) under mixed_bf16, dropout on, as phase 7's
    unpadded 32 x 512 (`unpadded`, its run row)."""
    import torch

    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    B, T = 32, 512

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=False)

    params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                          device="cuda")
    batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(1),
                            cfg, B, seq_len=T)
    lens = torch.randint(256, T + 1, (B,), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(11))
    batch["attention_mask"] = (torch.arange(T, device="cuda")[None]
                               < lens[:, None]).long()
    P = batch["masked_positions"].shape[1]
    per_step = {**dict.fromkeys(K2_NAMES, cfg.layers), K2_FOLD: cfg.layers}
    row = _train_run(f"bert-base {B}x{T} padded", loss_fn, params, batch,
                     cfg.train_flops_per_seq(T, P), 3, 20, per_step,
                     trace_ok=_k2_trace_ok("bert-padded", per_step))
    row["mean_length"] = lens.float().mean().item()
    row["k2_bwd_device_ms"] = _k2_bwd_ms(row)
    print(json.dumps({"phase": "bert-padded", "model": "BERT-base, "
                      "mixed_bf16, dropout 0.1, attention_mask",
                      "run": row,
                      "unpadded_step_ms_median": unpadded["step_ms_median"]}))
    return row["launches"]


def phase_bottleneck():
    """The fused bottleneck slice at ResNet-50's g2 widths, f32 (TF32
    off): matmul_stats (K4) -> fold_bn -> bn_act_matmul (K5), against
    the plain unfused composition (x @ w1, one-pass BN, ReLU, @ w2),
    values within 2e-4 and the gradients of all five inputs within 2e-3
    (|got - want| <= tol (1 + |want|), the limits of the JAX package's
    tests/test_fused_dense_bn.py). K5's main path: its launch count is
    read around the fused forward."""
    import torch

    from paddle_tpu_torch.kernels import fused_dense_bn as fdb

    t0 = time.perf_counter()
    M, C1, C2, C3 = 50176, 1024, 256, 1024
    gen = torch.Generator(device="cuda").manual_seed(13)
    ins = [torch.randn(M, C1, generator=gen, device="cuda"),
           torch.randn(C1, C2, generator=gen, device="cuda") * 0.1,
           torch.rand(C2, generator=gen, device="cuda") + 0.5,
           torch.randn(C2, generator=gen, device="cuda") * 0.1,
           torch.randn(C2, C3, generator=gen, device="cuda") * 0.1]
    ct = torch.randn(M, C3, generator=gen, device="cuda")

    def fused(x, w1, gamma, beta, w2):
        y, mean, var = fdb.matmul_stats(x, w1)
        scale, shift = fdb.fold_bn(mean, var, gamma, beta)
        return fdb.bn_act_matmul(y, scale, shift, w2, relu=True)

    def unfused(x, w1, gamma, beta, w2):
        y = x @ w1
        mean = y.mean(0)
        var = torch.clamp_min((y * y).mean(0) - mean * mean, 0.0)
        yn = (y - mean) * torch.rsqrt(var + 1e-5) * gamma + beta
        return torch.relu(yn) @ w2

    out = {}
    for name, fn in (("fused", fused), ("unfused", unfused)):
        leaves = [t.clone().requires_grad_() for t in ins]
        counts = _kernel_counts(reset=True)
        y = fn(*leaves)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        grads = torch.autograd.grad((y * ct).sum(), leaves)
        out[name] = (y.detach(), [g.detach() for g in grads], counts)
    (yf, gf, kc), (yu, gu, _) = out["fused"], out["unfused"]
    check(kc["matmul_stats_fwd"] == 1 and kc["bn_act_matmul_fwd"] == 1 and
          sum(kc.values()) == 2, f"bottleneck: the fused forward ran {kc}")

    def ratio(a, b, tol):
        return ((a - b).abs() / (tol * (1 + b.abs()))).max().item()

    val = ratio(yf, yu, 2e-4)
    grad = [ratio(a, b, 2e-3) for a, b in zip(gf, gu)]
    check(val <= 1.0 and max(grad) <= 1.0,
          f"bottleneck: values {val}, gradients {grad} of their limits")
    with torch.no_grad():
        times = {"fused_fwd_ms": time_ms(lambda: fused(*ins), reps=10),
                 "unfused_fwd_ms": time_ms(lambda: unfused(*ins), reps=10)}
    print(json.dumps({"phase": "bottleneck",
                      "shape": {"M": M, "C": [C1, C2, C3]}, "dtype": "float32",
                      "launches": kc, "value_ratio": val,
                      "grad_ratios": grad, **times,
                      "seconds": time.perf_counter() - t0}))
    return kc


def _sgd(params):
    """The counterpart of optax.sgd(0.1, momentum=0.9), bench.py
    bench_resnet50's optimizer: both set the first trace to g, then
    g + 0.9 trace."""
    import torch

    return torch.optim.SGD(params, lr=0.1, momentum=0.9)


def _resnet_grads(params, cfg, batch, dev):
    """(loss, {name: BN update}, {name: grad}, launches) of one forward
    and backward of `resnet.loss_fn` on `dev`, on the CPU."""
    import torch

    from paddle_tpu_torch.models import resnet

    p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
    b = {k: v.to(dev) for k, v in batch.items()}
    _kernel_counts(reset=True)
    loss, upd = resnet.loss_fn(p, cfg, b, data_format="NHWC")
    counts = _kernel_counts()
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    return (loss.item(), {k: v.detach().cpu() for k, v in upd.items()},
            {k: (torch.zeros_like(v) if g is None else g).cpu()
             for (k, v), g in zip(p.items(), grads)}, counts)


def phase_resnet_parity():
    """Full-width ResNet-50 (1000 classes) at f64 activations, 4 images of
    64 x 64 (the spatial size cut for the CPU's sake; widths and depth
    full), `fused_1x1` on. Two gates:

    - on the card, fused (K4, K6) against unfused (cuDNN convs), the JAX
      package's own limits for that comparison
      (test_resnet_fused_1x1_matches_unfused): loss within 1e-9
      relative, every BN update within rtol 1e-8 (atol 1e-10), every
      gradient within rtol 1e-6 (atol 1e-8);
    - the card's fused run against the CPU's (plain versions): BN
      updates within rtol 1e-8 (f64 end to end); the loss within 1e-6
      relative and each gradient within 1e-5 of its tensor's largest
      value, because the head and the log-softmax compute in f32 by
      design and cuBLAS and the CPU sum them in other orders (the same
      limits tests/test_torch_resnet.py sets against the JAX package,
      which measured 1.0e-7 and 2.0e-6 there); and one SGD(0.1,
      momentum 0.9) step through make_train_step: each trainable param
      within 1e-4 of its largest update plus one f32 step of its
      largest value, the BN statistics it writes within 1e-6 relative
      (f64 updates stored in f32)."""
    import dataclasses

    import torch

    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.parallel.train import make_train_step

    t0 = time.perf_counter()
    cfg = dataclasses.replace(resnet.ResNetConfig.resnet50(),
                              dtype="float64", fused_1x1=True)
    params, _ = resnet.init(torch.Generator().manual_seed(14), cfg,
                            device="cpu")
    batch = resnet.make_batch(np.random.RandomState(14), cfg, 4, hw=64,
                              data_format="NHWC", device="cpu")
    card = _resnet_grads(params, cfg, batch, "cuda")
    unfused = _resnet_grads(params, dataclasses.replace(cfg, fused_1x1=False),
                            batch, "cuda")
    cpu = _resnet_grads(params, cfg, batch, "cpu")
    want = {"matmul_stats_fwd": 16, "bn_act_matmul_stats_fwd": 16}
    check(all(n == want.get(k, 0) for k, n in card[3].items()),
          f"resnet-parity: the fused forward ran {card[3]}")
    check(all(n == 0 for n in unfused[3].values()),
          f"resnet-parity: the unfused forward ran {unfused[3]}")

    def upd_ratio(a, b):
        return max(((a[k] - b[k]).abs() / (1e-8 * b[k].abs() + 1e-10))
                   .max().item() for k in b)

    def tight_grad_ratio(a, b):
        return max(((a[k].double() - b[k].double()).abs() /
                    (1e-6 * b[k].double().abs() + 1e-8)).max().item()
                   for k in b)

    def grad_ratio(a, b):
        worst = (0.0, None)
        for k in b:
            scale = b[k].double().abs().max().item()
            if scale:
                worst = max(worst, ((a[k].double() - b[k].double()).abs()
                                    .max().item() / (1e-5 * scale), k),
                            key=lambda t: t[0])
        return worst

    r = {"fused_vs_unfused": {
            "loss_rel": abs(card[0] - unfused[0]) / abs(unfused[0]),
            "upd_ratio": upd_ratio(card[1], unfused[1]),
            "grad_ratio": tight_grad_ratio(card[2], unfused[2])},
         "card_vs_cpu": {
            "loss_rel": abs(card[0] - cpu[0]) / abs(cpu[0]),
            "upd_ratio": upd_ratio(card[1], cpu[1]),
            "grad_ratio": grad_ratio(card[2], cpu[2])}}
    fu, cc = r["fused_vs_unfused"], r["card_vs_cpu"]
    check(fu["loss_rel"] <= 1e-9 and fu["upd_ratio"] <= 1.0 and
          fu["grad_ratio"] <= 1.0, f"resnet-parity fused vs unfused: {fu}")
    check(cc["loss_rel"] <= 1e-6 and cc["upd_ratio"] <= 1.0 and
          cc["grad_ratio"][0] <= 1.0, f"resnet-parity card vs cpu: {cc}")

    stepped = {}
    for dev in ("cuda", "cpu"):
        init, step = make_train_step(
            lambda p, b, g: resnet.loss_fn(p, cfg, b, g, data_format="NHWC"),
            _sgd, device=dev, has_aux=True)
        state, loss = step(init(params), batch, 0)
        stepped[dev] = (loss.item(), {k: v.detach().cpu()
                                      for k, v in state.params.items()})
    worst, worst_bn = (0.0, None), (0.0, None)
    for k, p0 in params.items():
        a, b = stepped["cuda"][1][k].double(), stepped["cpu"][1][k].double()
        err = (a - b).abs().max().item()
        if k.endswith((".mean", ".var")):
            worst_bn = max(worst_bn, (((a - b).abs() / (1e-6 * b.abs() +
                                                       1e-10)).max().item(),
                                      k), key=lambda t: t[0])
            continue
        lim = 1e-4 * (b - p0.double()).abs().max().item() + \
            float(np.spacing(np.float32(b.abs().max().item())))
        worst = max(worst, (err / lim, k), key=lambda t: t[0])
    r["sgd_step"] = {"loss_cuda": stepped["cuda"][0],
                     "loss_cpu": stepped["cpu"][0], "param_ratio": worst,
                     "bn_state_ratio": worst_bn}
    check(worst[0] <= 1.0 and worst_bn[0] <= 1.0,
          f"resnet-parity SGD step: {r['sgd_step']}")
    print(json.dumps({"phase": "resnet-parity",
                      "model": "ResNetConfig.resnet50(), f64 activations, "
                               "fused_1x1, 4 x 64 x 64",
                      "loss_cuda": card[0], "loss_cuda_unfused": unfused[0],
                      "loss_cpu": cpu[0], "launches": card[3], **r,
                      "seconds": time.perf_counter() - t0}))


def _resnet_grad_agreement(B=32, hw=224):
    """Cosine similarity of ResNet-50's whole gradient (and of its worst
    tensor) at bs `B`, fused and unfused, f32 and bf16 activations,
    against the unfused f32 gradient, from one set of params and one
    batch: how far the bf16 runs' steps follow the f32 direction, for
    each path. Reported, not gated (phase 14 gates the fused path)."""
    import dataclasses

    import torch

    from paddle_tpu_torch.models import resnet

    base = resnet.ResNetConfig.resnet50()
    params, _ = resnet.init(torch.Generator(device="cuda").manual_seed(0),
                            base, device="cuda")
    batch = resnet.make_batch(torch.Generator(device="cuda").manual_seed(1),
                              base, B, hw=hw, data_format="NHWC")
    grads = {}
    for fused in (False, True):
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, fused_1x1=fused, dtype=dt)
            p = {k: v.clone().requires_grad_() for k, v in params.items()}
            loss, _ = resnet.loss_fn(p, cfg, batch, data_format="NHWC")
            g = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            grads[(fused, dt)] = (loss.item(), {k: x.double() for k, x in
                                                zip(p, g) if x is not None})
    ref = grads[(False, "float32")][1]
    out = {}
    for (fused, dt), (loss, g) in grads.items():
        whole = torch.cat([g[k].flatten() for k in ref]), \
            torch.cat([ref[k].flatten() for k in ref])
        worst = min(((g[k].flatten() @ ref[k].flatten()) /
                     (g[k].norm() * ref[k].norm())).item() for k in ref)
        out[f"{'fused' if fused else 'unfused'} {dt}"] = {
            "loss": loss, "cos_whole": ((whole[0] @ whole[1]) /
                                        (whole[0].norm() * whole[1].norm()))
            .item(), "cos_worst_tensor": worst}
    return {"batch": B, "hw": hw, "against": "unfused float32", **out}


def phase_resnet_train():
    """ResNet-50 as bench.py bench_resnet50 runs its first rung: bs 256 at
    224 x 224, NHWC, bf16 activations, f32 params (policy f32),
    SGD(0.1, momentum 0.9), 3 warm-up and 20 timed steps, first unfused
    (cuDNN convs), then with `fused_1x1` (K4 and K6 16 times a step).
    Before them, the first step's gradient of each path at f32 and bf16
    against the unfused f32 one (`_resnet_grad_agreement`)."""
    import dataclasses

    import torch

    from paddle_tpu_torch.models import resnet

    t0 = time.perf_counter()
    agreement = _resnet_grad_agreement()
    runs, counts = [], {}
    B, hw = 256, 224
    for fused in (False, True):
        cfg = dataclasses.replace(resnet.ResNetConfig.resnet50(),
                                  fused_1x1=fused)
        params, _ = resnet.init(torch.Generator(device="cuda").manual_seed(0),
                                cfg, device="cuda")
        batch = resnet.make_batch(torch.Generator(device="cuda").manual_seed(1),
                                  cfg, B, hw=hw, data_format="NHWC")

        def loss_fn(p, b, g, cfg=cfg):
            return resnet.loss_fn(p, cfg, b, g, data_format="NHWC")

        per_step = {"matmul_stats_fwd": 16, "bn_act_matmul_stats_fwd": 16} \
            if fused else {}
        row = _train_run(f"resnet-50 {B}x{hw}^2 " +
                         ("fused_1x1" if fused else "unfused"), loss_fn,
                         params, batch, cfg.flops_per_image(hw), 3, 20,
                         per_step, optimizer=_sgd, precision="f32",
                         has_aux=True)
        del params, batch
        runs.append(row)
        for k, v in row["launches"].items():
            counts[k] = counts.get(k, 0) + v
    print(json.dumps({"phase": "resnet-train",
                      "model": "ResNet-50 (ResNetConfig.resnet50()), bf16 "
                               "activations, f32 params, NHWC",
                      "optimizer": "SGD lr 0.1 momentum 0.9",
                      "first_losses": {r["run"]: r["loss_first"]
                                       for r in runs},
                      "grad_agreement": agreement,
                      "runs": runs, "seconds": time.perf_counter() - t0}))
    return counts


SP = 4   # the ring of phases 16 and 17: MeshConfig(sp=4) on one card


def _sp_mesh():
    """An in-process sp=4 ring: four virtual ranks on the card, run in
    turn by this process (what one card can show of the sp axis)."""
    import torch

    from paddle_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig(sp=SP), devices=[torch.device("cuda", 0)] * SP)


# Causal ring_attention's gradients against K1's, per element: f32
# with ten times ELEM_TOL's atol. In the rows with few keys the exact dq
# is near 0 and ds = p (dp - delta) cancels, and the two sides round the
# logits at different points (q k^T, then the scale, as the JAX
# package's _block_attn; K1 scales q first), so their f32 noise there
# differs: measured 1.27e-5 of the RMS on an H100 at 2 x 2048 x 12 heads.
CAUSAL_RING_TOL = (1e-5, 1e-4)


def _ring_op_parity(mesh):
    """f32 on the card: ring_splash (K3 blocks) against its plain
    version (K3's plain version in every block) and against
    single-device K1, out and the q/k/v gradients; causal
    ring_attention against K1 causal. Every element under
    ELEM_TOL["float32"] (the same f32 attention, summed in other
    orders), causal ring_attention's gradients under CAUSAL_RING_TOL."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.ops import ring_attention as ra

    B, T, N, H = 2, 2048, 12, 64
    scale = 1.0 / H ** 0.5
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, ct = (torch.randn(B, T, N, H, generator=gen, device="cuda")
                   for _ in range(4))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad((out * ct).sum(),
                                                         leaves))

    before = fa.splash_block_with_lse.launches
    ring = run(lambda a, b, c: ra.ring_splash(a, b, c, mesh, scale=scale))
    launches = fa.splash_block_with_lse.launches - before
    check(launches == SP * SP,
          f"ring-parity: ring_splash launched K3 {launches} times, not "
          f"{SP * SP}")
    refs = {
        "ring_splash_vs_plain_ring": (ring, run(
            lambda a, b, c: ra.ring_splash_ref(a, b, c, mesh, scale=scale))),
        "ring_splash_vs_k1": (ring, run(
            lambda a, b, c: fa.flash_attention(a, b, c, scale, False))),
        "causal_ring_attention_vs_k1": (run(
            lambda a, b, c: ra.ring_attention(a, b, c, mesh, causal=True,
                                              scale=scale)),
            run(lambda a, b, c: fa.flash_attention(a, b, c, scale, True)))}
    report, failed = {}, []
    for label, (got, want) in refs.items():
        grad_tol = CAUSAL_RING_TOL if label.startswith("causal") else None
        report[label] = {name: held(a, b, "float32",
                                    None if name == "out" else grad_tol)
                         for name, a, b in zip(("out", "dq", "dk", "dv"),
                                               got, want)}
        failed += [f"{label} {n}: {e}" for n, e in report[label].items()
                   if not e["ratio"] <= 1.0]
    check(not failed, "ring-parity: " + "; ".join(failed))
    return {"shape": [B, T, N, H], "k3_launches": launches, **report}


def phase_ring_parity():
    """The sp=4 in-process ring on the card at f32 (TF32 off): the op
    level (`_ring_op_parity`), then one step of a 2-layer, full-width
    BERT-base at 2 x 1024 under MeshConfig(sp=4) (every attention on
    ring_splash, K3 blocks) against the same step with no mesh on the
    card (K1) and on the CPU (plain versions): loss, every gradient and
    one AdamW step, at `_hold_train_step`'s tolerances."""
    import torch

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.parallel.mesh import mesh_guard

    t0 = time.perf_counter()
    mesh = _sp_mesh()
    ops = _ring_op_parity(mesh)
    cfg = bert.BertConfig(layers=2, max_len=1024, dtype="float32")
    params, _ = bert.init(torch.Generator().manual_seed(16), cfg,
                          device="cpu")
    batch = bert.make_batch(np.random.RandomState(16), cfg, 2, seq_len=1024,
                            device="cpu")

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=True)

    attn.GATE_COUNTS.clear()
    with mesh_guard(mesh):
        sp = _one_train_step(loss_fn, params, batch, "cuda")
    gates = dict(attn.GATE_COUNTS)
    k3 = sp["counts"]["splash_block_with_lse"]
    # the model runs twice under the mesh (the grad call, then the step,
    # whose launches are counted): one ring call a layer, S blocks on
    # each of S ranks
    check(gates == {"ring_splash": 2 * cfg.layers} and
          k3 == cfg.layers * SP * SP and
          all(n == 0 for name, n in sp["counts"].items()
              if name != "splash_block_with_lse"),
          f"ring-parity: gates {gates}, launches of the step {sp['counts']}")
    k1 = _one_train_step(loss_fn, params, batch, "cuda")
    cpu = _one_train_step(loss_fn, params, batch, "cpu")
    print(json.dumps({
        "phase": "ring-parity", "ring": f"in-process sp={SP} on one card",
        "ops": ops,
        "model": "BertConfig(layers=2, max_len=1024), f32, 2 x 1024",
        "gate_counts": gates, "k3_launches_step": k3,
        "sp_vs_k1": _hold_train_step("ring-parity sp vs K1", sp, k1, params),
        "sp_vs_cpu": _hold_train_step("ring-parity sp vs CPU", sp, cpu,
                                      params),
        "seconds": time.perf_counter() - t0}))


def phase_bert_long_sp():
    """BERT-base at T 4096 as bench.py's bench_bert_long builds it
    (`BertConfig(max_len=4096, dropout=0.0)`, deterministic, AdamW),
    under mixed_bf16: first under MeshConfig(sp=4) on the in-process
    ring (every layer's attention on ring_splash, K3 16 times a call),
    at the first rung of bench_bert_long's ladder [8, 4, 2, 1] that
    fits, 2 warm-up and 10 timed steps; then the same step with no mesh
    (K1 at T 4096) on the same params and batch, so the ring's cost on
    one card is a number."""
    import torch

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.mesh import mesh_guard

    t0 = time.perf_counter()
    T = 4096
    cfg = bert.BertConfig(max_len=T, dropout=0.0)
    mesh = _sp_mesh()

    def loss_fn(p, b, g):
        return bert.pretrain_loss(p, cfg, b, rng=g, deterministic=True)

    def setup(B):
        params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
        batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(1),
                                cfg, B, seq_len=T)
        return params, batch, cfg.train_flops_per_seq(
            T, batch["masked_positions"].shape[1])

    torch.cuda.reset_peak_memory_stats()
    did_not_fit, sp_row = [], None
    for B in (8, 4, 2, 1):
        params, batch, flops = setup(B)
        try:
            with mesh_guard(mesh):
                sp_row = _train_run(
                    f"bert-base {B}x{T} sp={SP}", loss_fn, params, batch,
                    flops, 2, 10,
                    {"splash_block_with_lse": cfg.layers * SP * SP})
        except torch.cuda.OutOfMemoryError:
            did_not_fit.append(B)
        del params, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if sp_row is not None:
            break
    check(sp_row is not None, "bert-long-sp: no rung of [8, 4, 2, 1] fit")
    params, batch, flops = setup(B)
    k1_row = _train_run(f"bert-base {B}x{T} no mesh", loss_fn, params,
                        batch, flops, 2, 10, k1_per_step(cfg.layers))
    del params, batch
    print(json.dumps({
        "phase": "bert-long-sp",
        "model": f"BERT-base (BertConfig(max_len={T}, dropout=0.0)), "
                 f"mixed_bf16, deterministic",
        "optimizer": "AdamW lr 1e-4 wd 1e-4",
        "ring": f"in-process sp={SP} on one card", "batch": B,
        "rungs_that_did_not_fit": did_not_fit,
        "k3_launches_per_step": sp_row["launches_per_step"][
            "splash_block_with_lse"],
        "ring_cost_ms": sp_row["step_ms_median"] - k1_row["step_ms_median"],
        "runs": [sp_row, k1_row], "seconds": time.perf_counter() - t0}))
    return sp_row["launches"]


def phase_head_dim_gate():
    """BertConfig.tiny() (head dim 16, which the kernels do not take):
    one mixed_bf16 train step on the card, every attention call on
    mha's "xla" route (the JAX package's `_xla_mha` for hd % 64 != 0),
    decided by shape before any launch; no K1 or K2 kernel runs."""
    import torch

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import attention as ta
    from paddle_tpu_torch.parallel.train import make_train_step

    cfg = bert.BertConfig.tiny()
    params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                          device="cuda")
    batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(1),
                            cfg, 8, seq_len=64)
    init, step = make_train_step(
        lambda p, b, g: bert.pretrain_loss(p, cfg, b, rng=g,
                                           deterministic=True),
        _adamw, device="cuda", precision="mixed_bf16")
    state = init(params)
    xla = ta.GATE_COUNTS["xla"]
    _kernel_counts(reset=True)
    losses = []
    for i in range(2):
        state, loss = step(state, batch, i)
        losses.append(loss.item())
    counts, routed = _kernel_counts(), ta.GATE_COUNTS["xla"] - xla
    check(all(np.isfinite(losses)), f"head-dim-gate: loss {losses}")
    check(routed == 2 * cfg.layers,
          f"head-dim-gate: {routed} calls on the xla route, not "
          f"{2 * cfg.layers}")
    check(not any(counts.values()),
          f"head-dim-gate: kernels launched {counts}")
    print(json.dumps({"phase": "head-dim-gate",
                      "model": "BertConfig.tiny() (head dim 16), mixed_bf16",
                      "batch": [8, 64], "losses": losses,
                      "xla_calls": routed, "launches": counts}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  fails when run outside the repo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    serving_row, training_rows, k2_rows, k3_row, fdb_rows = phase_kernels()
    launches = collections.Counter({"flash_attention_fwd": phase_slice()})
    phase_profile()
    phase_greedy()
    phase_train_parity()
    bert_counts, bert512 = phase_train()
    gpt_counts = phase_gpt_train()
    phase_nmt_parity()
    nmt_counts = phase_nmt_train()
    beam_counts = phase_nmt_beam()
    padded_counts = phase_bert_padded(bert512)
    bottleneck_counts = phase_bottleneck()
    phase_resnet_parity()
    resnet_counts = phase_resnet_train()
    phase_ring_parity()
    sp_counts = phase_bert_long_sp()
    phase_head_dim_gate()
    for counts in (bert_counts, gpt_counts, nmt_counts, beam_counts,
                   padded_counts, bottleneck_counts, resnet_counts,
                   sp_counts):
        launches.update(counts)
    # every main path runs attention at bf16, where the dq kernels fold
    # the delta pass in: the delta row counts those folds, and the
    # standalone delta launch must not have run
    check(launches[DELTA] == 0,
          f"the standalone delta launch ran on a main path: {launches}")
    launches[DELTA] = launches[K1_FOLD] + launches[K2_FOLD]
    check(all(launches[row["name"]] > 0 for row in
              [serving_row] + training_rows + k2_rows + [k3_row] + fdb_rows),
          f"a kernel of the main paths was never launched: {launches}")
    src = "paddle_tpu_torch/kernels/csrc/"
    rows = [{
        "name": serving_row["name"], "route": "cuda",
        "source": src + "flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/attention.py:361",
        "launches": launches[serving_row["name"]],
        "max_abs_err": serving_row["max_abs_err"],
        "ms": serving_row["kernel_ms"], "plain_ms": serving_row["plain_ms"],
        "bound_ms": serving_row["bound_ms"],
        "bound_by": serving_row["bound_by"],
        "library_ms": serving_row["library_ms"]}]
    for row in training_rows:
        # the row's times at phase 7's first run (BERT-base 256 x 128)
        t = row["timings"]["bert"]
        fold = row["name"] == DELTA
        rows.append({
            "name": row["name"], "route": "cuda",
            "source": src + ("flash_attention.cu" if row["name"].endswith(
                "fwd_lse") else "sm90.cuh" if fold
                else "flash_attention_bwd.cu"),
            "replaces": "paddle_tpu/ops/pallas/attention.py:" + (
                "361" if row["name"].endswith("fwd_lse") else "356"),
            "launches": launches[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            # the delta pass runs as the prologue of K1's and K2's dq
            # kernels: its launches are their folds, its ms the folded dq
            # launch's time less the external-delta one's
            **({"folded_into": ["flash_attention_bwd_dq",
                                "flash_attention_bias_bwd_dq"]}
               if fold else {})})
    jax_fa = "jax/experimental/pallas/ops/tpu/flash_attention.py:"
    for row in k2_rows:
        # the row's times at phase 10's calls (Transformer-big 128 x 128)
        t = row["timings"]["nmt"]
        fwd = row["name"].endswith("fwd")
        rows.append({
            "name": row["name"], "route": "cuda",
            "source": src + ("flash_attention_bias.cu" if fwd
                             else "flash_attention_bias_bwd.cu"),
            "replaces": "paddle_tpu/ops/pallas/attention.py:393" if fwd
            else jax_fa + ("941" if row["name"].endswith("dkv") else "1287"),
            "launches": launches[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            # the kernel of each dtype: "sm90" bf16 and f16, "fma" f32
            "kernels": row["kernels"]})
    # K3's times at phase 17's block (8 x 1024 x 12 heads, bf16)
    rows.append({
        "name": k3_row["name"], "route": "cuda",
        "source": src + "flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/attention.py:374",
        "launches": launches[k3_row["name"]],
        **{key: k3_row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}})
    for row in fdb_rows:
        # the row's times at the g2 shape (K5 at phase 13's product)
        t = row["timings"][FDB_LINE_SHAPE]
        rows.append({
            "name": row["name"], "route": "cuda",
            "source": src + "fused_dense_bn.cu",
            "replaces": row["replaces"],
            "launches": launches[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
