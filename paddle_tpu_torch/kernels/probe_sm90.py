"""A short call of the Hopper kernels on the card.

    python -m paddle_tpu_torch.kernels.probe_sm90

Builds the five sources with Hopper kernels (`csrc/flash_attention.cu`,
`flash_attention_bias.cu`, `flash_attention_bwd.cu`,
`flash_attention_bias_bwd.cu` and `fused_dense_bn.cu`) with `-Xptxas -v`
(registers, shared memory and spills of every kernel, printed and
written into `chiprun_out/probe/`), then prints one JSON line a case,
each held against its plain version under `chip_smoke.py`'s limits:
K1-fwd (with its LSE; bf16 and f16, causal and not, H 64 and 128,
fused-qkv views, ragged T and Tk); K1-bwd, K2 (forward, dkv and dq) and
K4, K5 and K6 through chip_smoke.py's own case functions and inputs, at
a first small case, the padded route of a shape TMA cannot read and the
timed shapes of the main path. Timed cases carry `ms` (back-to-back
calls between two CUDA events), `dev_ms` (the kernels' device time a
call, torch.profiler) and the library call's `lib_ms` (SDPA's forward
or backward, cuBLAS's product); the timed backwards of K1 and K2 run
both ways in the same process: two launches, dq computing delta in its
prologue ("ms", "dev_ms"), and the three-launch form with the
standalone delta launch ("three_ms", "three_dev_ms"). Then K2's
per-element ratios over six
seeds at three shapes, with, at the f16 ones, an f64 evaluation of the
same arithmetic ("f64_*": the reading f32 noise alone gives against
the plain version) and that evaluation with p and ds rounded to
bf16 under ATTN_F16_TOL (a control: the limit must fail it); the same
for K1-bwd at f16 ("k1_bwd_f16_floor"); and the host's cost of one
forward call against its parts. It is a short call; the full check
of every kernel is `chip_smoke.py`, which this imports from the repo
root. Needs a CUDA device.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import torch

from . import _build
from . import flash_attention as fa
from . import flash_attention_bias as fb
from . import fused_dense_bn as fdb

_OUT = os.path.join("chiprun_out", "probe")
# the sources with Hopper kernels
_SOURCES = ("flash_attention", "flash_attention_bias", "flash_attention_bwd",
            "flash_attention_bias_bwd", "fused_dense_bn")


@functools.cache
def _chip_smoke():
    """The repo root's `chip_smoke.py`: its limits and case functions
    hold the kernels here too."""
    root = str(pathlib.Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def held(got, want, dtype, tol=None):
    """The worst element's error over its limit, chip_smoke.py's
    ELEM_TOL[dtype] or `tol` (at most 1 passes)."""
    return _chip_smoke().held(got, want, str(dtype).removeprefix("torch."),
                              tol)["ratio"]


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def dev_ms(fn, reps=20, names=("fwd",)):
    """Device time a call of the kernels fn launches whose names hold
    one of `names`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if any(n in e.key for n in names)) / reps / 1e3


def host_us(fn, n=300):
    """Host time a call, over n calls issued without a synchronise."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def build_verbose():
    """nvcc with -Xptxas -v for the Hopper sources, in parallel; the
    logs go to chiprun_out/probe/, the libraries into the build
    directory."""
    os.makedirs(_OUT, exist_ok=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(_build.BUILD_DIR / f"probe-{name}.so"),
         str(_build.CSRC / _build.SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in _SOURCES}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(_OUT, f"{name}_ptxas.log"), "w") as f:
            f.write(log)
        used = [ln.strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln or "Compiling" in ln
                or "erialized" in ln]
        print(json.dumps({"build": name, "rc": proc.returncode,
                          "ptxas": used}))
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
    _build.build(list(_SOURCES))


def k1_case(gen, B, T, N, H, causal, dtype, fused=False, Tk=None,
            scale=0.125, timed=False):
    Tk = Tk or T
    if fused:
        qkv = torch.randn(B, T, 3 * N * H, generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (t.view(B, T, N, H) for t in qkv.split(N * H, dim=-1))
    else:
        q = torch.randn(B, T, N, H, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, Tk, N, H, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
    out, lse = fa.flash_attention_with_lse(q, k, v, scale, causal)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_ref(q, k, v, scale, causal,
                                            with_lse=True)
    r = {"kernel": "K1", "shape": [B, T, Tk, N, H], "causal": causal,
         "dtype": str(dtype), "fused": fused, "ratio": held(out, want, dtype),
         "lse_err": (lse - want_lse).abs().max().item()}
    if timed:
        def call():
            return fa.flash_attention_with_lse(q, k, v, scale, causal)
        r["ms"], r["dev_ms"] = time_ms(call), dev_ms(call)
    return r


def bwd_f64(q, k, v, do, lse, delta, scale, causal, rounding=None):
    """The plain backward's arithmetic in f64, P and dS rounded to
    `rounding` (q's dtype unless given) before their products: (dq, dk,
    dv) in q's dtype."""
    dt, rt = q.dtype, rounding or q.dtype
    qs = fa._scaled(q, scale).double()
    s = torch.einsum("btnh,bsnh->bnts", qs, k.double())
    p = torch.exp(s - lse.double()[..., None])
    if causal:
        p = p.masked_fill(~fa._keep(q.shape[1], k.shape[1], q.device), 0.0)
    dp = torch.einsum("btnh,bsnh->bnts", do.double(), v.double())
    ds = ((dp - delta.double()[..., None]) * p).to(rt).double()
    dv = torch.einsum("bnts,btnh->bsnh", p.to(rt).double(), do.double())
    dk = torch.einsum("bnts,btnh->bsnh", ds, qs)
    dq = torch.einsum("bnts,bsnh->btnh", ds, k.double())
    return fa._scaled(dq.to(dt), scale), dk.to(dt), dv.to(dt)


def k1_bwd_case(gen, B, T, N, H, causal, dtype, timed=False, f64=False):
    """chip_smoke.py's K1 training case (q, k, v views of one fused
    projection; the kernels' dq, dk and dv against their plain versions
    under ELEM_TOL); timed: the whole backward's time and its kernels'
    device time a call, two launches (dq folding the delta pass in, then
    dkv) and three (the standalone delta launch first), beside SDPA's
    backward; f64: the f64
    evaluation of the same arithmetic against the plain versions at
    ELEM_TOL ("f64_dq" ...: the floor f32 noise sets) and its control,
    P and dS rounded to bf16, under ATTN_F16_TOL ("bf16_dq" ...)."""
    cs = _chip_smoke()
    dname = str(dtype).removeprefix("torch.")
    case, errs, _ = cs._training_kernel_case(fa, B, T, causal, dname, gen,
                                             N, H)
    q, k, v, do, out, lse, delta, scale = case
    r = {"kernel": "K1-bwd", "shape": [B, T, N, H], "causal": causal,
         "dtype": dname, **{n: errs[n]["ratio"] for n in ("dq", "dk", "dv")}}
    if f64:
        want_dk, want_dv = fa.flash_attention_bwd_dkv_ref(
            q, k, v, do, lse, delta, scale, causal)
        want = (fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, scale,
                                              causal), want_dk, want_dv)
        for tag, rounding, tol in (("f64", dtype, None),
                                   ("bf16", torch.bfloat16, cs.ATTN_F16_TOL)):
            got = bwd_f64(q, k, v, do, lse, delta, scale, causal, rounding)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                r[f"{tag}_{name}"] = held(a, b, dtype, tol)
    if timed:
        def call():
            return fa.flash_attention_bwd(q, k, v, out, lse, do, scale,
                                          causal)

        def three():
            return cs._k1_bwd_three_launches(fa, q, k, v, out, lse, do,
                                             scale, causal)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale)
        r["ms"], r["three_ms"] = time_ms(call), time_ms(three)
        r["dev_ms"] = {kern: dev_ms(call, names=(kern,))
                       for kern in ("delta_kernel", "bwd_dkv", "bwd_dq")}
        r["three_dev_ms"] = {kern: dev_ms(three, names=(kern,))
                             for kern in ("delta_kernel", "bwd_dkv",
                                          "bwd_dq")}
        r["lib_ms"] = time_ms(lambda: torch.autograd.grad(
            so, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    return r


def fdb_case(gen, kernel, M, K, N, dtype, timed=False):
    """chip_smoke.py's K4, K5 or K6 case (with the ReLU; y under
    ELEM_TOL, mean and var under STATS_TOL); timed: beside cuBLAS's bare
    product."""
    cs = _chip_smoke()
    dname = str(dtype).removeprefix("torch.")
    (fn, _, args, kw), errs = cs._fdb_case(fdb, kernel, M, K, N, dname, True,
                                           gen)
    x, w = args[0], args[-1]
    r = {"kernel": kernel, "shape": [M, K, N], "dtype": dname,
         "route": fdb.kernel_route(K, N, dtype, x.data_ptr(), w.data_ptr()),
         "y": errs["y"]["ratio"],
         **{k: errs[k] for k in ("mean_ratio", "var_ratio") if k in errs}}
    if timed:
        r["ms"] = time_ms(lambda: fn(*args, **kw))
        r["dev_ms"] = dev_ms(lambda: fn(*args, **kw), names=("fused_mm_bn",))
        r["lib_ms"] = time_ms(lambda: torch.matmul(x, w))
    return r


def _k2_scores_f64(q, k, bias, scale, causal):
    """K2's scores in f64: (q k^T + bias) * scale, + MASK_VALUE above the
    diagonal when causal."""
    s = (torch.einsum("btnh,bsnh->bnts", q.double(), k.double())
         + bias.double()) * scale
    if causal:
        keep = fa._keep(q.shape[1], k.shape[1], q.device)
        s = s + torch.where(keep, 0.0, fb.MASK_VALUE)
    return s


def k2_fwd_f64(q, k, v, bias, scale, causal, rounding=None):
    """K2-fwd's arithmetic where the keys fit one block (the reference's
    one-step softmax) in f64, p / l rounded to `rounding` (v's dtype
    unless given) before the product with v: out in q's dtype."""
    if k.shape[1] > fb.BLOCK_K:
        raise ValueError("k2_fwd_f64 takes the one-step form, Tk <= 128")
    s = _k2_scores_f64(q, k, bias, scale, causal)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(rounding or v.dtype).double()
    return torch.einsum("bnts,bsnh->btnh", p, v.double()).to(q.dtype)


def k2_bwd_f64(q, k, v, bias, do, l, m, delta, scale, causal,
               rounding=None):
    """K2-bwd's arithmetic in f64 from the forward's l and m and delta:
    p = exp(s - m) / l and ds = (dp - delta) p scale, each rounded to
    `rounding` (q's dtype unless given) before its products, the
    products summed in f64 (in place of the tensor cores' order): (dq,
    dk, dv) in q's dtype."""
    dt, rt = q.dtype, rounding or q.dtype
    s = _k2_scores_f64(q, k, bias, scale, causal)
    p = torch.exp(s - m.double()[..., None]) / l.double()[..., None]
    dp = torch.einsum("btnh,bsnh->bnts", do.double(), v.double())
    ds = ((dp - delta.double()[..., None]) * p * scale).to(rt).double()
    p = p.to(rt).double()
    dv = torch.einsum("bnts,btnh->bsnh", p, do.double())
    dk = torch.einsum("bnts,btnh->bsnh", ds, q.double())
    dq = torch.einsum("bnts,bsnh->btnh", ds, k.double())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def k2_case(gen, B, Tq, Tk, N, H, causal, dtype, kind, tol=None,
            timed=False, f64=False):
    """chip_smoke.py's K2 case (`k2_case`, its inputs: kind "src_len",
    "bert" or "full"): out, dq, dk and dv against their plain versions;
    timed: the forward and the whole backward (delta, dkv, dq) with
    their kernels' device time a call, beside SDPA's forward and
    backward with the bias as a float mask; f64: the f64 evaluation of
    the same arithmetic against the plain versions at ELEM_TOL ("f64_out"
    where the keys fit one block, "f64_dq" ...: the floor f32 noise
    sets) and its control, p and ds rounded to bf16, under ATTN_F16_TOL
    ("bf16_out", "bf16_dq" ...). The timed backward runs both ways, two
    launches (dq folding the delta pass in, then dkv: "bwd_ms",
    "bwd_dev_ms") and three (K1's delta launch first: "bwd_three_ms",
    "bwd_three_dev_ms")."""
    cs = _chip_smoke()
    dname = str(dtype).removeprefix("torch.")
    case, errs, lm = cs.k2_case(B, Tq, Tk, N, H, causal, dname, kind, gen,
                                tol)
    q, k, v, do, bias, out, l, m, delta, scale = case
    args = (q, k, v, bias, do, l, m, delta, scale, causal)
    r = {"kernel": "K2", "shape": [B, Tq, Tk, N, H], "causal": causal,
         "dtype": dname, "bias": kind, "tol": tol or cs.ELEM_TOL[dname],
         **{n: errs[n]["ratio"] for n in ("out", "dq", "dk", "dv")}, **lm}
    if f64:
        want_dk, want_dv = fb.flash_attention_bias_bwd_dkv_ref(*args)
        want = (fb.flash_attention_bias_bwd_dq_ref(*args), want_dk, want_dv)
        want_out = fb.flash_attention_bias_ref(q, k, v, bias, scale,
                                               causal)[0]
        for tag, rounding, t in (("f64", dtype, None),
                                 ("bf16", torch.bfloat16, cs.ATTN_F16_TOL)):
            if Tk <= fb.BLOCK_K:
                r[f"{tag}_out"] = held(k2_fwd_f64(q, k, v, bias, scale,
                                                  causal, rounding),
                                       want_out, dtype, t)
            got = k2_bwd_f64(*args, rounding)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                r[f"{tag}_{name}"] = held(a, b, dtype, t)
    if timed:
        def fwd():
            return fb.flash_attention_bias_fwd(q, k, v, bias, scale, causal)

        def bwd():
            dq, d = fb.flash_attention_bias_bwd_dq(
                q, k, v, bias, do, l, m, None, scale, causal, o=out)
            return dq, fb.flash_attention_bias_bwd_dkv(
                q, k, v, bias, do, l, m, d, scale, causal)

        def bwd_three():
            d = fa.attention_delta(out, do)
            a = (q, k, v, bias, do, l, m, d, scale, causal)
            return (fb.flash_attention_bias_bwd_dq(*a),
                    fb.flash_attention_bias_bwd_dkv(*a))
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        # SDPA adds its mask after the scale, K2 its bias before
        amask = (bias * scale).to(q.dtype)
        so = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask, scale=scale)
        r.update({
            "ms": time_ms(fwd), "dev_ms": dev_ms(fwd),
            "lib_ms": time_ms(lambda: torch.nn.functional
                              .scaled_dot_product_attention(
                                  qt, kt, vt, attn_mask=amask, scale=scale)),
            "bwd_ms": time_ms(bwd), "bwd_three_ms": time_ms(bwd_three),
            "bwd_dev_ms": {kern: dev_ms(bwd, names=(kern,))
                           for kern in ("delta_kernel", "bwd_dkv", "bwd_dq")},
            "bwd_three_dev_ms": {kern: dev_ms(bwd_three, names=(kern,))
                                 for kern in ("delta_kernel", "bwd_dkv",
                                              "bwd_dq")},
            "bwd_lib_ms": time_ms(lambda: torch.autograd.grad(
                so, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))})
    return r


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_sm90: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build_verbose()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f16 = torch.bfloat16, torch.float16
    cases = [
        lambda: k1_bwd_case(gen, 1, 128, 1, 64, False, bf16),
        lambda: k1_bwd_case(gen, 256, 128, 12, 64, False, bf16, timed=True),
        lambda: k1_bwd_case(gen, 8, 1024, 12, 64, True, bf16, timed=True),
        lambda: k1_bwd_case(gen, 1, 4096, 12, 64, False, bf16, timed=True),
        lambda: fdb_case(gen, "k6", 1000, 70, 36, bf16),
        lambda: fdb_case(gen, "k4", 802816, 256, 64, bf16, timed=True),
        lambda: fdb_case(gen, "k6", 802816, 64, 256, bf16, timed=True),
        lambda: fdb_case(gen, "k4", 50176, 1024, 256, bf16, timed=True),
        lambda: fdb_case(gen, "k5", 50176, 256, 1024, bf16, timed=True),
        lambda: fdb_case(gen, "k6", 50176, 256, 1024, bf16, timed=True),
        lambda: fdb_case(gen, "k6", 12544, 512, 2048, bf16, timed=True),
    ] + [
        lambda: k1_case(gen, 1, 128, 1, 64, False, bf16),
        lambda: k1_case(gen, 1, 8, 12, 64, True, bf16, fused=True),
        lambda: k1_case(gen, 1, 100, 12, 64, True, bf16, fused=True),
        lambda: k1_case(gen, 1, 1024, 12, 64, True, bf16, fused=True,
                        timed=True),
        lambda: k1_case(gen, 256, 128, 12, 64, False, bf16, fused=True,
                        timed=True),
        lambda: k1_case(gen, 8, 1024, 12, 64, False, bf16, scale=1.0,
                        timed=True),
        lambda: k1_case(gen, 4, 1024, 12, 64, False, f16, scale=1.0),
        lambda: k1_case(gen, 2, 300, 4, 128, True, bf16),
        lambda: k1_case(gen, 2, 300, 4, 128, False, bf16, Tk=200),
        lambda: k1_case(gen, 4, 128, 12, 64, False, f16),
        lambda: k2_case(gen, 1, 128, 128, 1, 64, False, bf16, "src_len"),
        lambda: k2_case(gen, 128, 128, 128, 16, 64, False, bf16, "src_len",
                        timed=True),
        lambda: k2_case(gen, 32, 512, 512, 12, 64, False, bf16, "bert",
                        timed=True),
        lambda: k2_case(gen, 2, 100, 164, 12, 64, False, bf16, "src_len"),
        lambda: k2_case(gen, 2, 128, 256, 4, 64, True, bf16, "src_len"),
        lambda: k2_case(gen, 2, 256, 300, 4, 128, True, bf16, "full"),
        lambda: k2_case(gen, 4, 256, 300, 8, 128, False, bf16, "src_len"),
        # tests/test_torch_cuda.py's f16 case with a full bias
        lambda: k2_case(gen, 2, 100, 164, 2, 64, False, f16, "full",
                        f64=True),
    ]
    for case in cases:
        print(json.dumps(case()), flush=True)

    # K2's per-element ratios over seeds: it rounds p (and ds) to the
    # dtype, so a score summed in another order can round a p the other
    # way. At f16, beside the kernel, the f64 evaluation of the same
    # arithmetic against the f32 plain version at ELEM_TOL ("f64_*": the
    # floor f32 noise alone sets) and, under ATTN_F16_TOL, with p and ds
    # rounded to bf16 ("bf16_*": a kernel of lower precision, which that
    # limit must fail): ROADMAP F4 at chip_smoke's causal_f16 shape
    for label, (B, T, N, dtype, kind, causal) in (
            ("causal_f16", (4, 128, 12, f16, "full", True)),
            ("nmt_bf16", (128, 128, 16, bf16, "src_len", False)),
            ("f16_512", (4, 512, 12, f16, "full", False))):
        rows = [k2_case(torch.Generator(device="cuda").manual_seed(s), B, T,
                        T, N, 64, causal, dtype, kind, f64=dtype == f16)
                for s in range(6)]
        print(json.dumps({"k2_seeds": label,
                          "ratios": {key: [r[key] for r in rows]
                                     for key in rows[0] if key in (
                                         "out", "dq", "dk", "dv") or
                                     key.startswith(("f64_", "bf16_"))}}))

    # K1-bwd at f16: a rounding of P or dS to f16 that falls the other
    # way after f32 sums in another order moves a gradient element by one
    # f16 step of a large dS times a q or k element. Beside the kernel,
    # an f64 evaluation of the same arithmetic (P and dS rounded to f16)
    # against the f32 plain version, at f16's ELEM_TOL: the floor that
    # f32 noise alone sets; and, under ATTN_F16_TOL, the same evaluation
    # with P and dS rounded to bf16: a kernel of lower precision, which
    # that limit must fail
    print(json.dumps({"k1_bwd_f16_floor": [
        k1_bwd_case(torch.Generator(device="cuda").manual_seed(s), B, T, N,
                    H, False, f16, f64=True)
        for s, (B, T, N, H) in enumerate(((2, 256, 4, 128), (2, 256, 4, 128),
                                          (4, 128, 12, 64), (2, 300, 12, 64),
                                          (2, 300, 12, 64)))]}))

    # the host's cost of one K1-fwd call at the serving shape, by part
    qkv = torch.randn(1, 1024, 3 * 768, device="cuda").to(bf16)
    q, k, v = (t.view(1, 1024, 12, 64) for t in qkv.split(768, -1))
    fa.flash_attention(q, k, v, 0.125, True)   # declares the argtypes
    fn = fa._fn("flash_attention", "paddle_flash_attention_fwd", None)
    out = torch.empty_like(q)
    raw = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 12,
           1024, 1024, 64, 1, *fa._strides(q, k, v), 0.125, 1, None,
           torch.cuda.current_stream().cuda_stream)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    print(json.dumps({"host_us": {
        "wrapper": host_us(lambda: fa.flash_attention(q, k, v, 0.125, True)),
        "with_lse": host_us(lambda: fa.flash_attention_with_lse(
            q, k, v, 0.125, True)),
        "raw_ctypes": host_us(lambda: fn(*raw)),
        "check": host_us(lambda: fa._check(q, k, v)),
        "check_tma": host_us(lambda: fa.check_tma(q, k, v)),
        "sdpa": host_us(lambda: torch.nn.functional
                        .scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True))}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
