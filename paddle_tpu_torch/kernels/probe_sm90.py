"""A short call of the Hopper kernels on the card.

    python -m paddle_tpu_torch.kernels.probe_sm90

Builds the four sources with Hopper kernels (`csrc/flash_attention.cu`,
`flash_attention_bias.cu`, `flash_attention_bwd.cu` and
`fused_dense_bn.cu`) with `-Xptxas -v` (registers, shared memory and
spills of every kernel, printed and written into
`chiprun_out/probe/`), then prints one JSON line a case, each held
against its plain version under `chip_smoke.py`'s limits: K1-fwd (with
its LSE) and K2-fwd (bf16 and f16, causal and not, H 64 and 128,
fused-qkv views, ragged T and Tk); K1-bwd's dkv and dq and K4, K5 and
K6 through chip_smoke.py's own case functions, at a first small case,
the padded route of a shape TMA cannot read and the timed shapes of
the main path. Timed cases carry `ms` (back-to-back calls between two
CUDA events), `dev_ms` (the kernels' device time a call,
torch.profiler) and the library call's `lib_ms` (SDPA's backward,
cuBLAS's product). Then K2's per-element ratio over six seeds at three
shapes; K1-bwd's f16 ratio over five seeds beside an f64 evaluation of
the same arithmetic ("k1_bwd_f16_floor": f32 noise's own reading
against the plain version) and that evaluation with P and dS rounded
to bf16 under BWD_F16_TOL (a control: the limit must fail it); and the
host's cost of one forward call against its parts. It takes about a
minute; the full check of every kernel is `chip_smoke.py`, which this
imports from the repo root. Needs a CUDA device.
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
            "fused_dense_bn")


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
    under ELEM_TOL); timed: the whole backward's time and its dkv and dq
    kernels' device time a call, beside SDPA's backward; f64: the f64
    evaluation of the same arithmetic against the plain versions at
    ELEM_TOL ("f64_dq" ...: the floor f32 noise sets) and its control,
    P and dS rounded to bf16, under BWD_F16_TOL ("bf16_dq" ...)."""
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
                                   ("bf16", torch.bfloat16, cs.BWD_F16_TOL)):
            got = bwd_f64(q, k, v, do, lse, delta, scale, causal, rounding)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                r[f"{tag}_{name}"] = held(a, b, dtype, tol)
    if timed:
        def call():
            return fa.flash_attention_bwd(q, k, v, out, lse, do, scale,
                                          causal)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale)
        r["ms"] = time_ms(call)
        r["dev_ms"] = dev_ms(call, names=("dkv", "dq"))
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


def k2_inputs(gen, B, Tq, Tk, N, H, dtype, kind):
    q = torch.randn(B, Tq, N, H, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(B, Tk, N, H, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    if kind == "full":
        bias = torch.randn(B, N, Tq, Tk, generator=gen, device="cuda")
    else:
        lens = torch.randint(Tk // 2, Tk + 1, (B,), generator=gen,
                             device="cuda")
        keep = torch.arange(Tk, device="cuda")[None] < lens[:, None]
        bias = torch.where(keep, 0.0, -1e9)[:, None, None, :]
    return q, k, v, bias


def k2_case(gen, B, Tq, Tk, N, H, causal, dtype, kind, timed=False):
    q, k, v, bias = k2_inputs(gen, B, Tq, Tk, N, H, dtype, kind)
    out, l, m = fb.flash_attention_bias_fwd(q, k, v, bias, 0.125, causal)
    torch.cuda.synchronize()
    want, want_l, want_m = fb.flash_attention_bias_ref(q, k, v, bias, 0.125,
                                                       causal)
    r = {"kernel": "K2", "shape": [B, Tq, Tk, N, H], "causal": causal,
         "dtype": str(dtype), "bias": kind, "ratio": held(out, want, dtype),
         "l_rel": ((l - want_l).abs() / want_l).max().item(),
         "m_err": (m - want_m).abs().max().item()}
    if timed:
        def call():
            return fb.flash_attention_bias_fwd(q, k, v, bias, 0.125, causal)
        r["ms"], r["dev_ms"] = time_ms(call), dev_ms(call)
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
        lambda: k2_case(gen, 1, 128, 128, 1, 64, False, bf16, "mask"),
        lambda: k2_case(gen, 128, 128, 128, 16, 64, False, bf16, "mask",
                        timed=True),
        lambda: k2_case(gen, 32, 512, 512, 12, 64, False, bf16, "mask",
                        timed=True),
        lambda: k2_case(gen, 2, 100, 164, 12, 64, False, bf16, "mask"),
        lambda: k2_case(gen, 4, 128, 128, 12, 64, True, f16, "full"),
        lambda: k2_case(gen, 2, 256, 300, 4, 128, True, bf16, "full"),
        lambda: k2_case(gen, 2, 100, 300, 4, 128, False, bf16, "mask"),
    ]
    for case in cases:
        print(json.dumps(case()), flush=True)

    # K2's per-element ratio over seeds: it rounds p to the dtype, so a
    # score summed in another order can round a p the other way
    for label, (B, T, N, dtype, kind, causal) in (
            ("causal_f16", (4, 128, 12, f16, "full", True)),
            ("nmt_bf16", (128, 128, 16, bf16, "mask", False)),
            ("f16_512", (4, 512, 12, f16, "full", False))):
        ratios = [k2_case(torch.Generator(device="cuda").manual_seed(s), B, T,
                          T, N, 64, causal, dtype, kind)["ratio"]
                  for s in range(6)]
        print(json.dumps({"k2_seeds": label, "ratios": ratios}))

    # K1-bwd at f16: a rounding of P or dS to f16 that falls the other
    # way after f32 sums in another order moves a gradient element by one
    # f16 step of a large dS times a q or k element. Beside the kernel,
    # an f64 evaluation of the same arithmetic (P and dS rounded to f16)
    # against the f32 plain version, at f16's ELEM_TOL: the floor that
    # f32 noise alone sets; and, under BWD_F16_TOL, the same evaluation
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
