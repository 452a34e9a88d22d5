#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: the card's name and power limit, and the build of every
   kernel of the serving path from the sources in this checkout;
2. kernels: each kernel against its plain PyTorch version on the card,
   at the serving path's shapes, with its time beside the plain
   version's, one PyTorch library call's and the card's bound;
3. slice: GPT-2-small (random weights from a seed) served at bf16 by
   DecodeEngine behind the HTTP Server; 8 concurrent streamed
   /v1/generate requests whose prompts fill every prefill bucket up to
   1024, then the same 8 again (every shape warm); the kernels' launch
   counts are read around the first round alone;
4. profile: the slice's requests straight into a fresh engine, twice,
   then under torch.profiler (device busy share, largest kernels);
5. greedy: a 2-layer, full-width f32 engine's greedy tokens against the
   step-by-step full forward on the card.

The last line is {"ok": true, "device": {...}}; the line before it
lists every kernel with its numbers. Exits non-zero without a CUDA
device, and when the package is not beside this script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
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


def attention_bound_ms(q, k, causal=True):
    """Least time for one attention call on these inputs: q, k, v read
    once and o written once over the memory rate, against the products
    the (causal) mask leaves over the peak rate of q's dtype."""
    import torch

    B, T, N, H = q.shape
    Tk = k.shape[1]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    pairs = sum(min(t + 1, Tk) for t in range(T)) if causal else T * Tk
    flops = 4 * B * N * H * pairs
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


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


def phase_kernels():
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
            checks.append({"dtype": str(dtype).replace("torch.", ""),
                           "T": T, "max_abs_err": err, "tol": tol})
            check(err <= tol, f"flash_attention T={T} {dtype}: max abs "
                              f"err {err} > {tol}")
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
    row = {"name": "flash_attention_fwd",
           "replaces": "K1 attention.py:_splash_mha (causal fwd)",
           "tol": 2e-2, "checks": checks, **timing,
           "launches": fa.flash_attention.launches}
    print(json.dumps({"phase": "kernels", "kernels": [row]}))
    return row


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
    port = server.start(0)
    try:
        warm = {}
        _generate(port, [1, 2, 3], 2, warm)     # first CUDA/cuBLAS use
        check(len(warm.get("tokens", [])) == 2, f"warm-up request: {warm}")

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
           "preempted": status["requests"]["preempted"]}
    print(json.dumps(row))
    return launches


def phase_profile():
    """The slice's requests again, straight into a fresh engine (no
    HTTP, in a process whose kernels phase 3 already loaded): two rounds
    timed on the host clock, then one under torch.profiler for the
    device's busy time and its largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, engine, prompts = _slice_setup()

    def run_round():
        t0 = time.perf_counter()
        handles = [engine.submit(p, max_new_tokens=SLICE_NEW_TOKENS)
                   for p in prompts]
        toks = [h.result(timeout_s=600) for h in handles]
        wall = time.perf_counter() - t0
        check(all(len(t) == SLICE_NEW_TOKENS for t in toks),
              "profile round: short generation")
        ttft = sorted(h.info["ttft_s"] * 1e3 for h in handles)
        n = sum(len(t) for t in toks)
        return {"wall_s": wall, "tokens_per_s": n / wall,
                "ttft_p50_ms": statistics.median(ttft),
                "ttft_max_ms": ttft[-1]}

    try:
        first = run_round()
        second = run_round()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled = run_round()
    finally:
        engine.stop()
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
    profiled.update({
        "device_events": len(spans),
        "device_busy_ms": busy_ms,
        "device_idle_share": (1 - busy_ms / (profiled["wall_s"] * 1e3))
        if spans else None,
        "flash_attention_ms": sum(t[1] for n, t in by_name.items()
                                  if "flash_fwd_kernel" in n),
        "top_kernels": [{"name": n[:90], "count": c, "ms": ms}
                        for n, (c, ms) in top]})
    print(json.dumps({"phase": "profile", "requests": len(prompts),
                      "first": first, "second": second,
                      "profiled": profiled}))


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
    row = phase_kernels()
    launches = phase_slice()
    phase_profile()
    phase_greedy()
    print(json.dumps({"kernels": [{
        "name": row["name"], "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/attention.py:361",
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
