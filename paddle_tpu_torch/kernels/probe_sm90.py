"""A short first call of the Hopper attention forwards on the card.

    python -m paddle_tpu_torch.kernels.probe_sm90

Builds `csrc/flash_attention.cu` and `csrc/flash_attention_bias.cu`
with `-Xptxas -v` (registers, shared memory and spills of every kernel
into `chiprun_out/probe/`), then holds K1-fwd (with its LSE) and K2-fwd
against their plain versions at a few shapes (bf16 and f16, causal and
not, H 64 and 128, fused-qkv views, ragged T and Tk), per element under
`chip_smoke.py`'s ELEM_TOL, and prints one JSON line a case. Timed
cases carry `ms` (back-to-back calls between two CUDA events) and
`dev_ms` (the kernels' device time a call, torch.profiler). Then K2's
per-element ratio over six seeds at three shapes, and the host's cost
of one forward call against its parts. It takes under a minute; the
full check of every kernel is `chip_smoke.py`. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from . import _build
from . import flash_attention as fa
from . import flash_attention_bias as fb

ELEM_TOL = {torch.bfloat16: (2 ** -7, 2e-2), torch.float16: (2 ** -10, 1e-3)}
_OUT = os.path.join("chiprun_out", "probe")


def held(got, want, dtype):
    """The worst element's error over its ELEM_TOL limit (<= 1 passes)."""
    rtol, atol = ELEM_TOL[dtype]
    want = want.float()
    err = (got.float() - want).abs()
    rms = want.square().mean().sqrt()
    return (err / (rtol * want.abs() + atol * rms)).max().item()


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


def dev_ms(fn, reps=20):
    """Device time a call of the attention forward kernels fn launches."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "fwd" in e.key) / reps / 1e3


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
    """nvcc with -Xptxas -v for both sources, in parallel; the logs go
    to chiprun_out/probe/, the libraries into the build directory."""
    os.makedirs(_OUT, exist_ok=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(_build.BUILD_DIR / f"probe-{name}.so"),
         str(_build.CSRC / _build.SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("flash_attention", "flash_attention_bias")}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(_OUT, f"{name}_ptxas.log"), "w") as f:
            f.write(log)
        used = [ln.strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        print(json.dumps({"build": name, "rc": proc.returncode,
                          "ptxas": used}))
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
    _build.build(["flash_attention", "flash_attention_bias"])


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
