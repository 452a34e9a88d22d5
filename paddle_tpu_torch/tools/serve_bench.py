"""Open-loop Poisson load generator for the serving subsystem.

Counterpart of the JAX package's tools/serve_bench.py, with its five
modes, flags, defaults, metric names, units and JSON lines:

    python -m paddle_tpu_torch.tools.serve_bench [--rate 200]
        [--duration 10] [--max-batch 16] [--max-wait-ms 5]
        [--max-queue 128] [--batch 1] [--tokens [--prefix-share]]
        [--slots 4,8] [--prefill-buckets 8,16,32] [--warmstart ART]
        [--tenants] [--fleet] [--replicas 2] [--fleet-max 3] [--smoke]

**Predict mode** (default): a `serving.Server` on a LeNet-sized MLP
(784 -> 128 -> 10, built with the fluid Executor and saved with
`io.save_inference_model`), fired at with exponential inter-arrival
times at a fixed offered rate (open loop: overload shows up as rejects
and latency, not as a throttled client); p50/p99 end-to-end latency,
achieved throughput and the reject rate.

**Token mode** (`--tokens`): the continuous-batching decode engine on a
GPT behind POST /v1/generate under open-loop Poisson prompt arrivals:
time to first token, per-token gap p50/p99 and tokens/s, then the same
arrival schedule against the static drain-between-batches baseline
(`DecodeConfig(static_batching=True)`) for the continuous-against-
static A/B, then the phase grid replayed on an engine booted from a
warmstart artifact: its tokens must equal the cold engine's. The JAX
tool's "zero fresh compiles" has no counterpart here (nothing is
compiled: a warmed phase is a CUDA graph, or on the CPU an eager call),
so it becomes two checks on the warm engine: `warmstart_adopted` equals
the grid's phase count, and on CUDA no decode step runs eagerly during
the replay. The JSON line keeps the JAX metric name
`decode_warm_replay_fresh_compiles`; its value is the eager decode
steps of the warm replay (on the CPU every step is eager).

**Prefix-share mode** (`--tokens --prefix-share`): one long shared
prefix plus short unique suffixes, in repeated waves, through the plain
engine and the KV-reuse engine (chunked prefill + prefix cache +
self-draft speculation): equal streams, prefix-cache hits and the
accept rate.

**Tenants mode** (`--tenants`): a bronze-tier closed-loop flood against
a gold-tier trickle on a small queue (every shed must land on bronze,
gold sees no failure), then a `ModelRegistry` hot swap under load with
no failed request; the JAX tool's "zero fresh XLA compiles on the
adopting slot" becomes the slot's `warmstart_adopted` equal to its
bucket count.

**Fleet mode** (`--fleet`): a ReplicaSupervisor fleet booted from a
warmstart artifact behind a Router, through five gates: a replica
SIGKILLed under load (no failed request, the slot respawns), a 2x
traffic step with the Autoscaler armed (a scale-out lands, booted from
the artifact), a graceful scale-in under an in-flight burst (no dropped
request), distributed tracing (one sampled generate through a decode
replica reassembles to one tree across processes), and the time-series
recorder with a latency SLO that a sleep shim breaches (`slo_alert`
fires, then clears; `obsdump slo` and `obsdump top` show both).

Every JSON line's `detail` names the device (`platform`: the card's
name, or "cpu") and carries the K1-fwd launches that the mode caused in
this process (`k1_fwd_launches`, the kernel wrapper's count) beside the
attention routes taken (`attention_routes`, ops.attention.GATE_COUNTS).

The exit code is 0 when the mode's correctness gates hold: no failed
or wrong request, equal tokens, adoption, sheds on the right tier. The
JAX tool's timing gates (continuous >= 2x static, p99 at most static's,
gold p99 under its bound, TTFT gain, scale-out p99 recovery, tracing
and recorder overhead) are computed and reported in the JSON lines
under their JAX names, and do not set the exit code: a time on a shared
host decides nothing about correctness.

The modes run on the card (`cuda`). `--smoke` is the short CPU run the
test suite invokes (short traffic, tiny model); without it the tool
raises when CUDA is absent. The fleet's replicas take the tool's
device. Each mode's function takes its device, and the GPT modes take
their `GPTConfig` (default `GPTConfig.tiny()`), as keywords.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _build_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="offered load, requests/second")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="seconds of traffic")
    ap.add_argument("--batch", type=int, default=1,
                    help="rows per request")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--max-queue", type=int, default=128)
    ap.add_argument("--timeout-s", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", action="store_true",
                    help="token-streaming mode: continuous-batching "
                    "decode A/B + warmstart grid replay")
    ap.add_argument("--slots", default="4,8",
                    help="decode slot configs (token mode)")
    ap.add_argument("--prefill-buckets", default="8,16,32",
                    help="prompt-length buckets (token mode)")
    ap.add_argument("--warmstart", default=None,
                    help="pre-baked decode warmstart artifact to boot "
                    "the warm-replay engine from (token mode; default: "
                    "bake in-process from the cold engine)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="with --tokens: shared-system-prompt A/B — "
                    "KV reuse (chunked prefill + prefix cache + "
                    "speculation) vs the plain engine on the same "
                    "prompts (SERVING.md §KV reuse)")
    ap.add_argument("--fleet", action="store_true",
                    help="fleet chaos mode: replica kill under load, "
                    "2x traffic step with autoscaling, graceful "
                    "scale-in, tracing and SLO burn gates")
    ap.add_argument("--tenants", action="store_true",
                    help="multi-tenant chaos mode: bronze-tier noisy-"
                    "neighbor flood vs a gold-tier trickle (sheds "
                    "must land on bronze only), then a registry "
                    "hot-swap under load with zero failed requests "
                    "and every bucket adopted from the artifact "
                    "(SERVING.md §Multi-tenancy gates)")
    ap.add_argument("--tenant-p99-factor", type=float, default=10.0,
                    help="noisy-neighbor report: gold p99 under the "
                    "bronze flood against this x its unloaded "
                    "baseline (plus a 100ms absolute allowance)")
    ap.add_argument("--flood-threads", type=int, default=8,
                    help="closed-loop bronze flood senders "
                    "(tenants mode)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="initial fleet size (fleet mode)")
    ap.add_argument("--fleet-max", type=int, default=3,
                    help="autoscaler max replicas (fleet mode)")
    ap.add_argument("--p99-recover-factor", type=float, default=1.0,
                    help="scale-out report: tail-third p99 against "
                    "this x the step phase's peak window p99")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CPU run for CI (overrides rate/duration)")
    return ap.parse_args(argv)


def smoke_settings(args):
    """The JAX tool's --smoke traffic and sizes, set on `args` (the
    device is the caller's choice: `main` runs a smoke on the CPU)."""
    args.rate, args.duration = 80.0, 1.5
    args.max_batch, args.max_queue = 8, 64
    if args.fleet:
        args.rate, args.duration = 60.0, 2.5
        args.max_wait_ms = 1.0
        args.timeout_s = 20.0
    if args.tokens:
        # saturating burst: the A/B measures service capacity, so
        # arrivals must not be the bottleneck in either phase
        args.rate, args.duration = 600.0, 0.08
        args.slots, args.prefill_buckets = "4", "8,16"
        args.timeout_s = 120.0
    if args.tenants:
        args.rate, args.duration = 40.0, 1.2
        args.max_batch, args.max_queue = 8, 64
        args.flood_threads = 4
        args.timeout_s = 30.0
        args.tenant_p99_factor = max(args.tenant_p99_factor, 15.0)
    return args


def _platform(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"


class _Launches:
    """K1-fwd launches (the kernel wrapper's count) and attention routes
    (`ops.attention.GATE_COUNTS`) in this process since construction."""

    def __init__(self):
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.ops import attention as attn

        self._fa, self._attn = fa, attn
        self._k1 = fa.flash_attention.launches
        self._routes = dict(attn.GATE_COUNTS)

    def read(self):
        now = dict(self._attn.GATE_COUNTS)
        return {"k1_fwd_launches":
                self._fa.flash_attention.launches - self._k1,
                "attention_routes": {
                    k: v - self._routes.get(k, 0) for k, v in now.items()
                    if v != self._routes.get(k, 0)}}


def _save_model(tmpdir: str, device):
    """LeNet-sized MLP (784→128→10) saved as an inference model, its
    startup run on `device`."""
    import numpy as np

    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[784], dtype="float32")
        h = pt.layers.fc(input=x, size=128, act="relu")
        pred = pt.layers.fc(input=h, size=10, act="softmax")
    place = pt.CUDAPlace(device.index or 0) if device.type == "cuda" \
        else pt.CPUPlace()
    exe = pt.Executor(place)
    exe.run(startup)
    pt.io.save_inference_model(tmpdir, ["x"], [pred], exe,
                               main_program=main)
    return np.random.RandomState(0).rand(64, 784).astype("float32")


def _percentile(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1))))
    return xs[i]


def run_bench(args, *, device) -> int:
    import random
    import urllib.error
    import urllib.request

    from paddle_tpu_torch.serving import ServingConfig, Server

    launches = _Launches()
    tmpdir = tempfile.mkdtemp(prefix="serve_bench_")
    probe = _save_model(tmpdir, device)
    cfg = ServingConfig(
        tmpdir, max_batch=args.max_batch, max_queue=args.max_queue,
        max_wait_ms=args.max_wait_ms, timeout_s=args.timeout_s,
        use_tpu=device.type == "cuda")
    server = Server(cfg)
    port = server.start(0)
    url = f"http://127.0.0.1:{port}/v1/predict"

    rng = random.Random(args.seed)
    n_requests = max(1, int(args.rate * args.duration))
    arrivals, t = [], 0.0
    for _ in range(n_requests):
        t += rng.expovariate(args.rate)
        arrivals.append(t)

    lock = threading.Lock()
    oks, rejects, timeouts, errors = [], 0, 0, 0
    body = json.dumps(
        {"feeds": {"x": probe[:args.batch].tolist()}}).encode()

    def fire():
        nonlocal rejects, timeouts, errors
        t0 = time.perf_counter()
        try:
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type":
                                         "application/json"})
            with urllib.request.urlopen(req, timeout=args.timeout_s + 5):
                pass
            dt = (time.perf_counter() - t0) * 1000
            with lock:
                oks.append(dt)
        except urllib.error.HTTPError as e:
            with lock:
                if e.code == 503:
                    rejects += 1
                elif e.code == 504:
                    timeouts += 1
                else:
                    errors += 1
        except Exception:
            with lock:
                errors += 1

    # bound in-flight senders: unbounded per-request threads would
    # distort the latencies being measured. At the cap the generator
    # degrades toward closed-loop — visible as completed < requests.
    cap = threading.Semaphore(max(64, 4 * args.max_queue))

    def fire_capped():
        try:
            fire()
        finally:
            cap.release()

    threads = []
    start = time.perf_counter()
    for at in arrivals:
        delay = at - (time.perf_counter() - start)
        if delay > 0:
            time.sleep(delay)
        cap.acquire()
        th = threading.Thread(target=fire_capped, daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=args.timeout_s + 10)
    wall = time.perf_counter() - start
    server.stop()

    done = len(oks) + rejects + timeouts + errors
    detail = {
        "rate_offered_rps": args.rate, "duration_s": args.duration,
        "requests": n_requests, "completed": done, "ok": len(oks),
        "rejected": rejects, "timeout": timeouts, "error": errors,
        "rows_per_request": args.batch, "max_batch": args.max_batch,
        "max_wait_ms": args.max_wait_ms, "max_queue": args.max_queue,
        "platform": _platform(device), "smoke": bool(args.smoke),
        **launches.read(),
    }
    for metric, value, unit in (
            ("serving_p50_latency_ms", _percentile(oks, 50), "ms"),
            ("serving_p99_latency_ms", _percentile(oks, 99), "ms"),
            ("serving_throughput_rps",
             round(len(oks) * args.batch / wall, 3) if wall > 0 else 0,
             "req_rows/s"),
            ("serving_reject_rate",
             round(rejects / max(1, done), 4), "fraction")):
        print(json.dumps({
            "metric": metric,
            "value": round(value, 3) if isinstance(value, float) else value,
            "unit": unit, "detail": detail}), flush=True)
    return 0 if (len(oks) > 0 and errors == 0) else 1


# ---------------------------------------------------------------------------
# Token-streaming mode
# ---------------------------------------------------------------------------

# max_new_tokens cycles through these per arrival: the length variance
# is what the static drain-between-batches baseline pays for (its batch
# holds every slot until the LONGEST member finishes), while continuous
# batching backfills the freed slots from the queue
_GEN_LENGTHS = (2, 2, 4, 64)


def _gpt_params(cache, cfg, seed, device):
    """`cfg`'s params from a CPU torch.Generator seeded with `seed`, on
    `device`: one draw per (seed) in `cache`, shared by the mode's
    engines (each engine casts its own copy)."""
    import torch

    from paddle_tpu_torch.models import gpt

    if seed not in cache:
        cache[seed] = gpt.init(torch.Generator(device="cpu").manual_seed(
            int(seed)), cfg, device=device)[0]
    return cache[seed]


def _build_decode_engine(static: bool, slots, buckets, seed: int = 0, *,
                         device, cfg=None, cache=None):
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

    cfg = cfg or gpt.GPTConfig.tiny()
    params = _gpt_params({} if cache is None else cache, cfg, seed, device)
    max_len = max(buckets) + max(_GEN_LENGTHS) + 8
    blocks_per_seq = -(-max_len // 8)
    dc = DecodeConfig(
        block_size=8,
        num_blocks=1 + max(slots) * blocks_per_seq + 4,
        decode_slots=slots, prefill_buckets=buckets, max_len=max_len,
        max_queue=4096,  # A/B fairness: both phases must accept all
        precision="bf16", static_batching=static)
    return DecodeEngine(params, cfg, dc, device=device), cfg


def _token_phase(label: str, static: bool, args, slots, buckets,
                 arrivals, prompts, *, device, cfg, cache):
    """One load phase over HTTP: boot engine+server, fire the arrival
    schedule, stream every reply, return the aggregate stats."""
    import urllib.error
    import urllib.request

    from paddle_tpu_torch.serving import ServingConfig, Server

    eng, _ = _build_decode_engine(static, slots, buckets, device=device,
                                  cfg=cfg, cache=cache)
    eng.warmup()
    server = Server(ServingConfig(warmup=False,
                                  use_tpu=device.type == "cuda"),
                    decode=eng)
    port = server.start(0)
    url = f"http://127.0.0.1:{port}/v1/generate"

    lock = threading.Lock()
    stats = {"ttft": [], "gaps": [], "e2e": [], "tokens": 0, "ok": 0,
             "rejected": 0, "error": 0}

    def fire(idx):
        """One non-streamed generation (N concurrent in-process chunked
        readers would throttle the scheduler thread through the GIL).
        TTFT comes back in-band from the server, e2e is client wall;
        the streamed path is exercised by the sequential probes
        below."""
        ids, max_new = prompts[idx % len(prompts)], \
            _GEN_LENGTHS[idx % len(_GEN_LENGTHS)]
        body = json.dumps({"ids": ids, "max_new_tokens": max_new,
                           "stream": False}).encode()
        t0 = time.perf_counter()
        try:
            req = urllib.request.Request(
                url, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req,
                                        timeout=args.timeout_s) as r:
                rec = json.loads(r.read())
            e2e = time.perf_counter() - t0
            with lock:
                stats["ok"] += 1
                stats["tokens"] += len(rec.get("tokens") or [])
                stats["e2e"].append(e2e)
                if rec.get("ttft_ms") is not None:
                    stats["ttft"].append(rec["ttft_ms"] / 1000.0)
        except urllib.error.HTTPError as e:
            with lock:
                stats["rejected" if e.code == 503 else "error"] += 1
        except Exception:
            with lock:
                stats["error"] += 1

    def stream_probe():
        """Sequential chunked-stream request: validates the streaming
        frontend and measures unloaded inter-token gaps."""
        body = json.dumps({"ids": prompts[0],
                           "max_new_tokens": 16}).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        last = None
        n = 0
        with urllib.request.urlopen(req, timeout=args.timeout_s) as r:
            while True:
                ln = r.readline()
                if not ln:
                    break
                rec = json.loads(ln)
                now = time.perf_counter()
                if "token" in rec:
                    n += 1
                    if last is not None:
                        stats["gaps"].append(now - last)
                    last = now
                elif rec.get("done") and rec.get("error"):
                    stats["error"] += 1
        if n == 0:
            stats["error"] += 1

    cap = threading.Semaphore(256)

    def fire_capped(i):
        try:
            fire(i)
        finally:
            cap.release()

    threads = []
    start = time.perf_counter()
    for i, at in enumerate(arrivals):
        delay = at - (time.perf_counter() - start)
        if delay > 0:
            time.sleep(delay)
        cap.acquire()
        th = threading.Thread(target=fire_capped, args=(i,), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=args.timeout_s + 60)
    wall = time.perf_counter() - start
    for _ in range(3):  # outside the timed window
        try:
            stream_probe()
        except Exception:
            # a flaky probe must not throw away the whole measured A/B
            stats["error"] += 1
    status = server.status()
    server.stop()
    return {
        "label": label, "wall_s": round(wall, 3),
        "tokens_per_sec": round(stats["tokens"] / wall, 2) if wall else 0,
        "tokens": stats["tokens"], "ok": stats["ok"],
        "rejected": stats["rejected"], "error": stats["error"],
        "ttft_p50_ms": _ms(_percentile(stats["ttft"], 50)),
        "ttft_p99_ms": _ms(_percentile(stats["ttft"], 99)),
        "token_gap_p50_ms": _ms(_percentile(stats["gaps"], 50)),
        "token_gap_p99_ms": _ms(_percentile(stats["gaps"], 99)),
        "e2e_p50_ms": _ms(_percentile(stats["e2e"], 50)),
        "e2e_p99_ms": _ms(_percentile(stats["e2e"], 99)),
        "decode_status": {k: status.get("decode", {}).get(k)
                          for k in ("requests", "kv", "phase_grid")},
    }


def _ms(v):
    return round(v * 1000, 3) if v is not None else None


def _grid_replay(eng, slots, buckets):
    """Deterministic canonical generation touching every prefill
    bucket (sequential) plus a full-slot burst: the token sequences are
    composition-independent (row-isolated decode math), so cold and
    warm engines must agree token for token."""
    outs = {}
    for b in buckets:
        plen = max(1, b // 2)
        outs[f"bucket_{b}"] = eng.submit(
            [1 + (i % 64) for i in range(plen)],
            max_new_tokens=4).result(timeout_s=300)
    hs = [eng.submit([3 + i, 5 + i], max_new_tokens=4)
          for i in range(max(slots))]
    outs["burst"] = [h.result(timeout_s=300) for h in hs]
    return outs


def _eager_decode_steps(eng) -> int:
    return int(eng.status()["phase_runs"]["decode"]["eager"])


def run_token_bench(args, *, device, cfg=None) -> int:
    import random

    from paddle_tpu_torch.observability import memwatch as _memwatch
    from paddle_tpu_torch.observability import perfwatch as _perfwatch

    launches = _Launches()
    slots = tuple(sorted({int(s) for s in args.slots.split(",")}))
    buckets = tuple(sorted({int(b) for b in
                            args.prefill_buckets.split(",")}))
    cache = {}

    rng = random.Random(args.seed)
    n_requests = max(8, int(args.rate * args.duration))
    # identical arrival schedule and prompt pool for both phases
    arrivals, t = [], 0.0
    for _ in range(n_requests):
        t += rng.expovariate(args.rate)
        arrivals.append(t)
    prompts = [[1 + rng.randrange(60)
                for _ in range(3 + (i % (min(buckets) - 2)))]
               for i in range(16)]

    # best-of-2 per phase: a noisy-neighbor CPU must not decide the
    # reported speedup
    kw = dict(device=device, cfg=cfg, cache=cache)
    cont = max((_token_phase("continuous", False, args, slots, buckets,
                             arrivals, prompts, **kw) for _ in range(2)),
               key=lambda r: r["tokens_per_sec"])
    stat = max((_token_phase("static", True, args, slots, buckets,
                             arrivals, prompts, **kw) for _ in range(2)),
               key=lambda r: r["tokens_per_sec"])
    speedup = cont["tokens_per_sec"] / stat["tokens_per_sec"] \
        if stat["tokens_per_sec"] else 0.0
    p99_ok = (cont["e2e_p99_ms"] is not None
              and stat["e2e_p99_ms"] is not None
              and cont["e2e_p99_ms"] <= stat["e2e_p99_ms"] * 1.05)

    # -- warmstart grid replay: every phase adopted, equal tokens -----
    cold_eng, model_cfg = _build_decode_engine(False, slots, buckets, **kw)
    cold_eng.warmup()
    cold_tokens = _grid_replay(cold_eng, slots, buckets)
    if args.warmstart:
        art = args.warmstart
    else:
        art = os.path.join(tempfile.mkdtemp(prefix="serve_bench_"),
                           "decode.warmstart")
        cold_eng.export_warmstart(art)
    cold_eng.stop()
    warm_eng, _ = _build_decode_engine(False, slots, buckets, **kw)
    grid = len(warm_eng._phase_keys())
    adopted = warm_eng.load_warmstart(art)
    ready = warm_eng.warmup()
    eager0 = _eager_decode_steps(warm_eng)
    warm_tokens = _grid_replay(warm_eng, slots, buckets)
    fresh = _eager_decode_steps(warm_eng) - eager0
    warm_eng.stop()
    bit_identical = warm_tokens == cold_tokens
    # on the CPU nothing is captured: every decode step is eager
    replay_ok = adopted == grid and (device.type != "cuda" or fresh == 0)

    detail_base = {
        "platform": _platform(device), "smoke": bool(args.smoke),
        "rate_offered_rps": args.rate, "duration_s": args.duration,
        "requests": n_requests, "slots": list(slots),
        "prefill_buckets": list(buckets), "gen_lengths":
        list(_GEN_LENGTHS), "precision": "bf16",
        "model": {"hidden": model_cfg.hidden, "layers": model_cfg.layers,
                  "heads": model_cfg.heads,
                  "vocab_size": model_cfg.vocab_size},
        # live attribution of the same run: decode MFU from the phases'
        # FLOP formula, and the memory high-watermark the KV pools and
        # params drove
        "mfu": round(_perfwatch.mfu("decode"), 6),
        "tokens_per_sec_per_chip_live":
            round(_perfwatch.tokens_per_sec_per_chip("decode"), 2),
        "hbm_peak_bytes": int(_memwatch.watermark_bytes()),
        **launches.read(),
    }
    for metric, value, unit, detail in (
            ("decode_tokens_per_sec_continuous",
             cont["tokens_per_sec"], "tokens/s/chip",
             dict(detail_base, **cont)),
            ("decode_tokens_per_sec_static",
             stat["tokens_per_sec"], "tokens/s/chip",
             dict(detail_base, **stat)),
            ("decode_continuous_speedup", round(speedup, 3), "x",
             dict(detail_base, equal_p99_ok=p99_ok,
                  e2e_p99_ms_continuous=cont["e2e_p99_ms"],
                  e2e_p99_ms_static=stat["e2e_p99_ms"],
                  acceptance=">=2x tokens/s at equal-or-better p99 "
                             "(reported, not gated)")),
            ("decode_warm_replay_fresh_compiles", fresh, "count",
             dict(detail_base, adopted=adopted, phases=grid,
                  phases_ready=ready, bit_identical=bit_identical,
                  artifact=art, gate_ok=replay_ok and bit_identical,
                  acceptance="every phase of the grid adopted from the "
                             "artifact, no eager decode step in the "
                             "warm replay on CUDA, tokens equal to the "
                             "cold engine's"))):
        print(json.dumps({"metric": metric, "value": value,
                          "unit": unit, "detail": detail}), flush=True)
    ok = (cont["error"] == 0 and stat["error"] == 0
          and cont["tokens"] > 0 and replay_ok and bit_identical)
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# Prefix-share mode: KV reuse A/B
# ---------------------------------------------------------------------------


def _prefix_phase(label, engine_kw, draft, prompts, max_new, repeats, *,
                  device, cfg, cache):
    """Engine-direct phase: submit every prompt `repeats` times in
    waves (wave 1 is the cold population pass; later waves hit the
    prefix cache when it is on) and collect per-request TTFT + the
    emitted streams."""
    from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

    params = _gpt_params(cache, cfg, 0, device)
    dargs = (params, cfg) if draft else None
    eng = DecodeEngine(params, cfg, DecodeConfig(**engine_kw),
                       draft=dargs, device=device)
    eng.warmup()
    streams, ttft_warm, ttft_all = [], [], []
    t0 = time.perf_counter()
    tokens = 0
    try:
        for wave in range(repeats):
            hs = [eng.submit(p, max_new_tokens=max_new)
                  for p in prompts]
            for h in hs:
                toks = h.result(timeout_s=300)
                streams.append(toks)
                tokens += len(toks)
                t = h.info["ttft_s"]
                ttft_all.append(t)
                if wave > 0:
                    ttft_warm.append(t)
        wall = time.perf_counter() - t0
        status = eng.status()
    finally:
        eng.stop()
    return {
        "label": label,
        "wall_s": round(wall, 3),
        "tokens": tokens,
        "tokens_per_sec": round(tokens / wall, 2) if wall else 0,
        "ttft_p50_ms": _ms(_percentile(ttft_all, 50)),
        "ttft_p99_ms": _ms(_percentile(ttft_all, 99)),
        "ttft_warm_p50_ms": _ms(_percentile(ttft_warm, 50)),
        "ttft_warm_p99_ms": _ms(_percentile(ttft_warm, 99)),
        "streams": streams,
        "kv": {k: v for k, v in status["kv"].items()
               if "prefix" in k or "cached" in k or "reuse" in k
               or "cow" in k or "evict" in k},
        "kv_reuse": status.get("kv_reuse"),
    }


def run_prefix_bench(args, *, device, cfg=None) -> int:
    """Shared-system-prompt A/B (SERVING.md §KV reuse): the same
    prompt set — one long shared prefix + short unique suffixes,
    submitted in repeated waves — through (a) the plain continuous
    engine and (b) the KV-reuse engine (chunked prefill + prefix cache
    + self-draft speculation). Gates: equal streams, prefix-cache hits
    > 0 and an accept rate of ~1.0 for the self-draft; the warm-wave
    TTFT gain on prefix hits is reported."""
    import random

    from paddle_tpu_torch.models import gpt

    launches = _Launches()
    cfg = cfg or gpt.GPTConfig.tiny()
    rng = random.Random(args.seed)
    if args.smoke:
        shared_len, n_suffix, max_new, repeats = 24, 3, 6, 3
    else:
        shared_len, n_suffix, max_new, repeats = 48, 4, 16, 4
    block_size = 8
    max_len = shared_len + 16 + max_new + 8
    shared = [1 + rng.randrange(60) for _ in range(shared_len)]
    prompts = [shared + [1 + rng.randrange(60)
                         for _ in range(3 + i)]
               for i in range(n_suffix)]
    plen_max = max(len(p) for p in prompts)
    bucket = 1
    while bucket < plen_max:
        bucket *= 2
    blocks_per_seq = -(-max_len // block_size)
    base_kw = dict(block_size=block_size,
                   num_blocks=1 + 4 * blocks_per_seq + 4,
                   decode_slots=(4,), max_len=max_len,
                   max_queue=4096, precision="f32")
    kw = dict(device=device, cfg=cfg, cache={})

    plain = _prefix_phase(
        "plain", dict(base_kw, prefill_buckets=(bucket,)), False,
        prompts, max_new, repeats, **kw)
    reuse = _prefix_phase(
        "kv_reuse", dict(base_kw, prefill_chunk=block_size,
                         prefix_cache=True, spec_k=2), True,
        prompts, max_new, repeats, **kw)

    bit_identical = plain.pop("streams") == reuse.pop("streams")
    hits = int(reuse["kv"].get("prefix_hits_total") or 0)
    accept = (reuse["kv_reuse"] or {}).get("spec_accept_rate")
    ttft_gain = None
    if plain["ttft_warm_p50_ms"] and reuse["ttft_warm_p50_ms"]:
        ttft_gain = round(plain["ttft_warm_p50_ms"] /
                          reuse["ttft_warm_p50_ms"], 3)

    detail = {
        "platform": _platform(device), "smoke": bool(args.smoke),
        "model": {"hidden": cfg.hidden, "layers": cfg.layers,
                  "heads": cfg.heads, "vocab_size": cfg.vocab_size},
        "shared_prefix_tokens": shared_len, "suffixes": n_suffix,
        "waves": repeats, "max_new": max_new,
        "block_size": block_size,
        "bit_identical": bit_identical,
        "prefix_hits": hits,
        "spec_accept_rate": accept,
        "plain": plain, "kv_reuse": reuse,
        "acceptance": "bit-identical streams; accept rate ~1 for the "
                      "self-draft; warm-wave TTFT p50 gain on prefix "
                      "hits reported, not gated",
        **launches.read(),
    }
    for metric, value, unit in (
            ("decode_prefix_share_ttft_speedup", ttft_gain, "x"),
            ("decode_prefix_share_hits", hits, "blocks"),
            ("decode_spec_accept_rate", accept, "fraction")):
        print(json.dumps({"metric": metric, "value": value,
                          "unit": unit, "detail": detail}), flush=True)
        detail = {"see": "decode_prefix_share_ttft_speedup"}
    ok = (bit_identical and hits > 0
          and accept is not None and accept >= 0.99)
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# Multi-tenant chaos mode (SERVING.md §Multi-tenancy)
# ---------------------------------------------------------------------------


def run_tenants_bench(args, *, device) -> int:
    """The two multi-tenant acceptance gates:

      1. **noisy neighbor** — a bronze-tier closed-loop flood
         saturates a deliberately small queue while a gold-tier
         trickle keeps measuring. Degradation must be tier-scoped:
         every shed lands on bronze (checked per response AND against
         the paddle_tpu_serving_sheds_total{tier} counter) and gold
         sees ZERO failures. Gold's p99 against --tenant-p99-factor x
         its unloaded baseline (+100 ms) is reported.
      2. **hot swap under load** — with both tenants still firing,
         the serving program's warmstart artifact is published into a
         ModelRegistry and the watcher hot-swaps it in: zero failed
         requests across the swap window, and the adopting slot adopts
         every bucket from the artifact.
    """
    import random
    import urllib.error
    import urllib.request

    from paddle_tpu_torch import observability
    from paddle_tpu_torch.serving import Server, ServingConfig
    from paddle_tpu_torch.serving.registry import ModelRegistry

    launches = _Launches()
    tmpdir = tempfile.mkdtemp(prefix="serve_bench_mt_")
    probe = _save_model(tmpdir, device)
    qos = {"tiers": ["gold", "bronze"], "default_tier": "bronze",
           "tenants": {"gold-client": {"tier": "gold", "weight": 4}}}
    qsize = max(8, args.max_queue // 8)
    cfg = ServingConfig(
        tmpdir, max_batch=args.max_batch,
        # small queue: the flood must actually hit the shed path
        max_queue=qsize,
        max_wait_ms=args.max_wait_ms, timeout_s=args.timeout_s,
        qos=qos, model_id="bench", use_tpu=device.type == "cuda")
    server = Server(cfg)
    port = server.start(0)
    url = f"http://127.0.0.1:{port}/v1/predict"
    rows = probe[:args.batch].tolist()

    def fire(tenant):
        """One predict; returns (outcome, latency_ms, shed_tier)."""
        t0 = time.perf_counter()
        body = json.dumps({"feeds": {"x": rows},
                           "tenant": tenant}).encode()
        try:
            req = urllib.request.Request(
                url, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=args.timeout_s + 5):
                pass
            return "ok", (time.perf_counter() - t0) * 1000, None
        except urllib.error.HTTPError as e:
            try:
                info = json.loads(e.read())
            except ValueError:
                info = {}
            if e.code == 503 and isinstance(info, dict) \
                    and info.get("shed"):
                return "shed", None, str(info["shed"])
            if e.code == 503:
                return "rejected", None, None
            return ("timeout" if e.code == 504 else "error"), None, None
        except Exception:
            return "error", None, None

    def shed_counts():
        snap = observability.snapshot()
        out = {}
        for s in (snap.get("paddle_tpu_serving_sheds_total")
                  or {"series": []})["series"]:
            tier = s["labels"].get("tier", "?")
            out[tier] = out.get(tier, 0) + int(s["value"])
        return out

    try:
        # ---- unloaded gold baseline ---------------------------------
        base_lat = []
        for _ in range(20):
            oc, ms, _tier = fire("gold-client")
            if oc == "ok":
                base_lat.append(ms)
        p99_base = _percentile(base_lat, 99)

        # ---- gate 1: bronze flood vs gold trickle -------------------
        sheds_t0 = shed_counts()
        stop = threading.Event()
        flood_stats = {"ok": 0, "shed": 0, "rejected": 0, "error": 0,
                       "timeout": 0}
        flood_shed_tiers = set()
        flood_lock = threading.Lock()

        flood_lat = []

        def flood():
            while not stop.is_set():
                oc, ms, tier = fire("bronze-flood")
                with flood_lock:
                    flood_stats[oc] += 1
                    if oc == "ok":
                        flood_lat.append(ms)
                    if tier is not None:
                        flood_shed_tiers.add(tier)

        # closed-loop senders bound the in-flight count at the thread
        # count, so the flood must outnumber queue + one active batch
        # or the queue never fills and nothing sheds
        n_flood = max(args.flood_threads, qsize + args.max_batch + 4)
        flooders = [threading.Thread(target=flood, daemon=True)
                    for _ in range(n_flood)]
        for th in flooders:
            th.start()
        gold_lat, gold_fails, gold_shed_tiers = [], [], set()
        gold_lock = threading.Lock()
        gold_rate = max(5.0, args.rate / 4.0)
        t_end = time.perf_counter() + args.duration

        # several open-loop gold probes: one slow reply must not
        # serialize the sampler down to a single latency point
        def gold_trickle(seed):
            tr = random.Random(seed)
            while time.perf_counter() < t_end:
                oc, ms, tier = fire("gold-client")
                with gold_lock:
                    if oc == "ok":
                        gold_lat.append(ms)
                    else:
                        gold_fails.append(oc)
                        if tier is not None:
                            gold_shed_tiers.add(tier)
                time.sleep(tr.expovariate(gold_rate))

        golds = [threading.Thread(target=gold_trickle,
                                  args=(args.seed + i,), daemon=True)
                 for i in range(3)]
        for th in golds:
            th.start()
        for th in golds:
            th.join(timeout=args.duration + args.timeout_s + 10)
        stop.set()
        for th in flooders:
            th.join(timeout=args.timeout_s + 10)
        gold_fail = len(gold_fails)
        sheds_t1 = shed_counts()
        shed_delta = {t: sheds_t1.get(t, 0) - sheds_t0.get(t, 0)
                      for t in set(sheds_t0) | set(sheds_t1)}
        p99_flood = _percentile(gold_lat, 99)
        p99_bronze = _percentile(flood_lat, 99)
        bronze_sheds = shed_delta.get("bronze", 0)
        p99_bound = None
        if p99_base is not None:
            p99_bound = args.tenant_p99_factor * p99_base + 100.0
        # the JAX tool's latency gate, reported: gold p99 within factor
        # x unloaded baseline, or far below the flooding tier's
        abs_ok = (p99_flood is not None and p99_bound is not None
                  and p99_flood <= p99_bound)
        rel_ok = (p99_flood is not None and p99_bronze is not None
                  and p99_flood <= 0.5 * p99_bronze)
        neighbor_ok = (
            gold_fail == 0 and not gold_shed_tiers
            and bronze_sheds > 0
            and flood_shed_tiers <= {"bronze"}
            and shed_delta.get("gold", 0) == 0)

        # ---- gate 2: registry hot-swap under load -------------------
        ws = os.path.join(tmpdir, "bench.warmstart")
        server.engine.export_warmstart(ws)
        registry = ModelRegistry(os.path.join(tmpdir, "registry"))
        entry = registry.publish("bench", ws, model_dir=tmpdir)
        stop = threading.Event()
        swap_stats = {"ok": 0, "shed": 0, "rejected": 0, "error": 0,
                      "timeout": 0}
        swap_lock = threading.Lock()

        def light_load(tenant, rate):
            lr = random.Random(hash(tenant) & 0xFFFF)
            while not stop.is_set():
                oc, _ms, _tier = fire(tenant)
                with swap_lock:
                    swap_stats[oc] += 1
                time.sleep(lr.expovariate(rate))

        loaders = [
            threading.Thread(target=light_load,
                             args=("gold-client", gold_rate),
                             daemon=True),
            threading.Thread(target=light_load,
                             args=("bronze-steady", gold_rate),
                             daemon=True)]
        for th in loaders:
            th.start()
        server.attach_registry(registry, poll_s=0.1)
        adopted, deadline = None, time.perf_counter() + 60.0
        while time.perf_counter() < deadline:
            row = next((r for r in server.models()
                        if r["id"] == "bench"), None)
            if row is not None and row.get("version") \
                    == entry["version"]:
                adopted = row
                break
            time.sleep(0.05)
        # keep load flowing briefly past the swap so post-swap
        # requests land in the window too
        time.sleep(0.3)
        stop.set()
        for th in loaders:
            th.join(timeout=args.timeout_s + 10)
        swap_failed = (swap_stats["error"] + swap_stats["rejected"]
                       + swap_stats["shed"] + swap_stats["timeout"])
        swap_ok = (
            adopted is not None
            and adopted.get("warmstart_adopted", 0)
            == len(adopted.get("buckets") or ()) > 0
            and swap_failed == 0 and swap_stats["ok"] > 0)
    finally:
        server.stop()

    detail = {
        "platform": _platform(device), "smoke": bool(args.smoke),
        "qos": qos, "flood_threads": n_flood,
        "duration_s": args.duration,
        "gold": {"ok": len(gold_lat), "failed": gold_fail,
                 "p99_base_ms": p99_base, "p99_flood_ms": p99_flood,
                 "p99_bound_ms": round(p99_bound, 3)
                 if p99_bound is not None else None,
                 "p99_bronze_ms": p99_bronze,
                 "abs_ok": abs_ok, "rel_ok": rel_ok},
        "flood": dict(flood_stats),
        "shed_delta": shed_delta,
        "swap": {"requests": dict(swap_stats),
                 "failed": swap_failed,
                 "adopted_version": adopted.get("version")
                 if adopted else None,
                 "warmstart_adopted": adopted.get("warmstart_adopted")
                 if adopted else None,
                 "buckets": adopted.get("buckets") if adopted else None},
        **launches.read(),
    }
    for metric, value, unit, extra in (
            ("tenant_gold_p99_ms", p99_flood, "ms",
             dict(gate_ok=neighbor_ok,
                  acceptance="bronze flood sheds bronze ONLY, zero "
                             "gold failures; gold p99 against factor x "
                             "baseline + 100ms (or the flooding tier's "
                             "p99) reported, not gated")),
            ("tenant_bronze_sheds", bronze_sheds, "count",
             dict(gate_ok=neighbor_ok)),
            ("hot_swap_failed_requests", swap_failed, "count",
             dict(gate_ok=swap_ok,
                  acceptance="registry hot-swap under load: zero "
                             "failed requests, every bucket adopted "
                             "from the warmstart artifact"))):
        print(json.dumps({"metric": metric,
                          "value": round(value, 3)
                          if isinstance(value, float) else value,
                          "unit": unit,
                          "detail": {**detail, **extra}}), flush=True)
    return 0 if (neighbor_ok and swap_ok) else 1


# ---------------------------------------------------------------------------
# Fleet chaos mode
# ---------------------------------------------------------------------------


def _fleet_phase(url: str, rate: float, duration: float, body: bytes,
                 timeout_s: float, on_tick=None):
    """Open-loop Poisson load against the router; returns per-request
    records [(arrival_s, latency_ms, outcome)] with outcome in
    ok|rejected|timeout|error. `on_tick(elapsed_s)` runs on the arrival
    thread (the chaos hook: kill a replica at a chosen moment)."""
    import random
    import urllib.error
    import urllib.request

    rng = random.Random(1234)
    n_requests = max(4, int(rate * duration))
    arrivals, t = [], 0.0
    for _ in range(n_requests):
        t += rng.expovariate(rate)
        arrivals.append(t)

    lock = threading.Lock()
    records = []

    def fire(at):
        t0 = time.perf_counter()
        try:
            req = urllib.request.Request(
                url, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout_s + 5):
                pass
            out = "ok"
        except urllib.error.HTTPError as e:
            out = {503: "rejected", 504: "timeout"}.get(e.code, "error")
        except Exception:
            out = "error"
        with lock:
            records.append((at, (time.perf_counter() - t0) * 1000, out))

    cap = threading.Semaphore(256)

    def fire_capped(at):
        try:
            fire(at)
        finally:
            cap.release()

    threads = []
    start = time.perf_counter()
    for at in arrivals:
        delay = at - (time.perf_counter() - start)
        if delay > 0:
            time.sleep(delay)
        if on_tick is not None:
            on_tick(time.perf_counter() - start)
        cap.acquire()
        th = threading.Thread(target=fire_capped, args=(at,),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout_s + 30)
    # a thread still wedged past its join timeout produced no record;
    # the zero-failed-requests gate must count it as a failure, not
    # silently shrink the denominator
    with lock:
        lost = len(threads) - len(records)
        for _ in range(lost):
            records.append((float("nan"), float("nan"), "error"))
        return list(records)


def _outcomes(records):
    out = {"ok": 0, "rejected": 0, "timeout": 0, "error": 0}
    for _, _, oc in records:
        out[oc] += 1
    return out


def _phase_p99s(records, tail_frac: float = 1 / 3, windows: int = 6):
    """(peak windowed p99, tail-third p99) of the ok latencies, by
    arrival time — the 'p99 recovers' report compares the tail against
    the worst window the traffic step caused."""
    oks = sorted((at, ms) for (at, ms, oc) in records if oc == "ok")
    if not oks:
        return None, None
    span = max(at for at, _ in oks) or 1e-9
    per_win = [[] for _ in range(windows)]
    for at, ms in oks:
        per_win[min(windows - 1, int(windows * at / span))].append(ms)
    win_p99 = [_percentile(w, 99) for w in per_win if w]
    tail = [ms for at, ms in oks if at >= span * (1 - tail_frac)]
    return (max(win_p99) if win_p99 else None,
            _percentile(tail, 99))


def _fleet_events(kind_action):
    from paddle_tpu_torch.observability import events as oe

    return [e for e in oe.recent(4096, kind="fleet")
            if e.get("action") == kind_action]


# the environment the fleet mode sets for itself and its replicas,
# restored when it returns
_FLEET_ENV = ("PADDLE_TPU_TRACE_DIR", "PADDLE_TPU_TRACE_SAMPLE",
              "PADDLE_TPU_TS_DIR", "PADDLE_TPU_TS_INTERVAL_S",
              "PADDLE_TPU_SLOW_SHIM_FILE")


def run_fleet_bench(args, *, device) -> int:
    """The five fleet gates — see the module docstring. Returns 0 when
    the failover, scale-out, scale-in, tracing and SLO gates hold."""
    saved = {k: os.environ.get(k) for k in _FLEET_ENV}
    from paddle_tpu_torch.observability import timeseries as _ts_mod

    try:
        return _run_fleet_bench(args, device)
    finally:
        _ts_mod.stop_recorder()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_fleet_bench(args, device) -> int:
    import urllib.request

    from paddle_tpu_torch.distributed.launch_serve import (
        ReplicaSpec, ReplicaSupervisor)
    from paddle_tpu_torch.serving import Engine, ServingConfig
    from paddle_tpu_torch.serving.autoscale import Autoscaler
    from paddle_tpu_torch.serving.router import Router, RouterServer

    launches = _Launches()
    platform = _platform(device)
    cpu = device.type != "cuda"
    tmpdir = tempfile.mkdtemp(prefix="serve_fleet_")
    model_dir = os.path.join(tmpdir, "model")
    os.makedirs(model_dir, exist_ok=True)
    probe = _save_model(model_dir, device)

    # gate 4: one shared trace dir for the whole fleet — replica
    # subprocesses inherit it via the environment. Sampling stays OFF
    # through gates 1-3 (the router is the trace head; with no
    # traceparent inbound and rate 0, replicas never sample either).
    trace_dir = os.path.join(tmpdir, "trace")
    os.environ["PADDLE_TPU_TRACE_DIR"] = trace_dir
    os.environ.pop("PADDLE_TPU_TRACE_SAMPLE", None)

    # bake the warmstart artifact every replica (scale-outs too) boots
    # from, on the replicas' device (artifacts are device-bound)
    art = os.path.join(tmpdir, "fleet.warmstart")
    bake = Engine(ServingConfig(model_dir, max_batch=args.max_batch,
                                use_tpu=not cpu))
    bake.warmup()
    bake.export_warmstart(art)
    del bake

    rdzv = os.path.join(tmpdir, "rdzv")
    spec = ReplicaSpec(model_dir, warmstart=art, cpu=cpu,
                       max_batch=args.max_batch,
                       max_queue=args.max_queue,
                       max_wait_ms=args.max_wait_ms,
                       timeout_s=args.timeout_s)
    sup = ReplicaSupervisor(spec, rdzv, replicas=args.replicas,
                            backoff_s=0.3,
                            log_dir=os.path.join(tmpdir, "logs"))
    router = Router(rdzv_dir=rdzv, poll_interval_s=0.1,
                    request_timeout_s=args.timeout_s)
    front = RouterServer(router)
    sup.start()
    port = front.start(0)
    url = f"http://127.0.0.1:{port}/v1/predict"
    body = json.dumps(
        {"feeds": {"x": probe[:args.batch].tolist()}}).encode()

    def wait_healthy(n, timeout=180.0):
        t0 = time.time()
        while len(router.healthy_endpoints()) < n:
            if time.time() - t0 > timeout:
                raise RuntimeError(
                    f"fleet never reached {n} healthy replicas "
                    f"(status: {router.status()})")
            time.sleep(0.1)
        return time.time() - t0

    rc = 0
    scaler = None
    try:
        boot_s = wait_healthy(args.replicas)

        # ---- gate 1: SIGKILL one replica under open-loop load -------
        kill_state = {"done": False, "endpoint": None}

        def chaos(elapsed):
            if not kill_state["done"] and elapsed >= args.duration * 0.4:
                kill_state["done"] = True
                live = [s for s in sup.slot_info() if s["alive"]]
                kill_state["endpoint"] = sup.kill_slot(live[0]["slot"])

        rec1 = _fleet_phase(url, args.rate, args.duration, body,
                            args.timeout_s, on_tick=chaos)
        oc1 = _outcomes(rec1)
        st1 = router.status()
        ejections = len(_fleet_events("eject"))
        retried = sum(st1["retries"].values())
        failover_ok = (oc1["error"] == 0 and oc1["timeout"] == 0
                       and oc1["rejected"] == 0 and oc1["ok"] > 0
                       and kill_state["done"] and ejections >= 1)
        respawn_s = wait_healthy(args.replicas)  # supervisor heals it

        # ---- gate 2: 2x traffic step with the autoscaler armed ------
        scaler = Autoscaler(
            router, sup, min_replicas=args.replicas,
            max_replicas=args.fleet_max,
            high_load=1.0, low_load=0.2,
            interval_s=0.1, breach_polls=2, clear_polls=50,
            out_cooldown_s=2.0, in_cooldown_s=3600.0)
        known = set(sup.endpoints())
        scaler.start()
        t_step = time.time()
        rec2 = _fleet_phase(url, args.rate * 2, args.duration * 2,
                            body, args.timeout_s)
        scaler.stop()
        oc2 = _outcomes(rec2)
        scale_outs = scaler.status()["actions"]["out"]
        new_eps = sorted(set(sup.endpoints()) - known)
        # a replica spawned late in the step may still be booting (a
        # torch import and a warm-up): the gate is that it lands, so
        # wait for the router to admit it before reading its status
        deadline = time.time() + 180.0
        while new_eps and time.time() < deadline and not set(
                new_eps) <= set(router.healthy_endpoints()):
            time.sleep(0.1)
        adopted = None
        for ep in new_eps:
            try:
                with urllib.request.urlopen(
                        f"http://{ep}/v1/status", timeout=5) as r:
                    adopted = json.loads(r.read()).get(
                        "warmstart_adopted")
            except Exception:
                continue
        # spawn to routable: the first scale-out's event to the router's
        # join of a new replica
        scaleout_s = None
        outs = [e["ts"] for e in _fleet_events("scale_out")
                if e.get("ts", 0) >= t_step]
        joins = [e["ts"] for e in _fleet_events("member_join")
                 if e.get("endpoint") in new_eps]
        if outs and joins:
            scaleout_s = round(min(joins) - min(outs), 3)
        peak_p99, tail_p99 = _phase_p99s(rec2)
        p99_recovered = (peak_p99 is not None and tail_p99 is not None
                         and tail_p99 <=
                         peak_p99 * args.p99_recover_factor)
        scaleout_ok = (scale_outs >= 1 and bool(new_eps)
                       and (adopted or 0) > 0 and oc2["error"] == 0)

        # ---- gate 3: graceful scale-in under an in-flight burst -----
        burst_n = 24
        results = {"ok": 0, "fail": 0}
        lock = threading.Lock()

        def burst_fire():
            try:
                req = urllib.request.Request(
                    url, data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req,
                                            timeout=args.timeout_s + 5):
                    pass
                with lock:
                    results["ok"] += 1
            except Exception:
                with lock:
                    results["fail"] += 1

        ths = [threading.Thread(target=burst_fire, daemon=True)
               for _ in range(burst_n)]
        for th in ths:
            th.start()
        drained = sup.scale_in()
        for th in ths:
            th.join(timeout=args.timeout_s + 30)
        scalein_ok = (results["fail"] == 0 and results["ok"] == burst_n
                      and drained is not None)

        # ---- gate 4: distributed tracing ----------------------------
        import signal as _signal
        import subprocess

        from paddle_tpu_torch.observability import tracing as _tracing

        def _one(url_, body_, extra_headers=None):
            req = urllib.request.Request(
                url_, data=body_,
                headers={"Content-Type": "application/json",
                         **(extra_headers or {})})
            with urllib.request.urlopen(req,
                                        timeout=args.timeout_s + 5) as r:
                return dict(r.headers), json.loads(r.read())

        ab_dur = min(args.duration, 2.0)
        os.environ["PADDLE_TPU_TRACE_SAMPLE"] = "0"
        rec_off = _fleet_phase(url, args.rate, ab_dur, body,
                               args.timeout_s)
        os.environ["PADDLE_TPU_TRACE_SAMPLE"] = "1.0"
        # the traced predict whose tree gate 4 reassembles — fired
        # BEFORE the sampled load phase, whose flood of sampled spans
        # flushes every replica's sink past this request's records
        pred_hdrs, _ = _one(url, body)
        pred_tid = pred_hdrs.get("X-Request-Id")
        rec_on = _fleet_phase(url, args.rate, ab_dur, body,
                              args.timeout_s)
        p50_off = _percentile([ms for (_, ms, oc) in rec_off
                               if oc == "ok"], 50)
        p50_on = _percentile([ms for (_, ms, oc) in rec_on
                              if oc == "ok"], 50)
        overhead = (p50_on / p50_off) if p50_off and p50_on else None
        # the JAX tool's <5% bar with a 2.5 ms floor, reported
        overhead_ok = overhead is not None and \
            (overhead <= 1.05 or (p50_on - p50_off) <= 2.5)

        # ...and one traced generate through a decode replica (a
        # SEPARATE subprocess + router front, so the tree must cross
        # process boundaries: router pid != replica pid)
        gen_tid, gen_err = None, None
        dec_front = None
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "paddle_tpu_torch.serving.replica",
             "--decode-tiny", "0", "--port", "0"]
            + (["--cpu"] if cpu else []),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        try:
            ready_line = {}

            def _read_ready():
                try:
                    ready_line["v"] = json.loads(
                        proc.stdout.readline() or "{}")
                except ValueError:
                    ready_line["v"] = {}

            reader = threading.Thread(target=_read_ready, daemon=True)
            reader.start()
            reader.join(timeout=240.0)
            ep = (ready_line.get("v") or {}).get("endpoint")
            if not ep:
                raise RuntimeError("decode replica never became ready")
            dec_router = Router([ep], poll_interval_s=0.1,
                                request_timeout_s=args.timeout_s)
            dec_front = RouterServer(dec_router)
            dport = dec_front.start(0)
            deadline = time.time() + 60
            while not dec_router.healthy_endpoints():
                if time.time() > deadline:
                    raise RuntimeError("decode replica never healthy")
                time.sleep(0.1)
            gen_body = json.dumps({"ids": [3, 1, 4, 1, 5],
                                   "max_new_tokens": 4,
                                   "stream": False}).encode()
            gen_hdrs, _ = _one(f"http://127.0.0.1:{dport}/v1/generate",
                               gen_body)
            gen_tid = gen_hdrs.get("X-Request-Id")
        except Exception as e:
            gen_err = f"{type(e).__name__}: {e}"
        finally:
            if dec_front is not None:
                dec_front.stop()
            if proc.poll() is None:
                proc.send_signal(_signal.SIGTERM)  # drain + sink flush
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            if proc.stdout is not None:
                proc.stdout.close()
        time.sleep(0.5)                 # replica handler span settle
        _tracing.flush_trace_sink()     # router-side (this process)
        trace_recs = _tracing.read_trace_dir(trace_dir)

        def _trace_view(tid):
            if not tid:
                return set(), 0, 0
            mine = [r for r in trace_recs if r.get("trace_id") == tid]
            tree = _tracing.build_trace_tree(trace_recs, tid)
            return ({r["name"] for r in mine},
                    len(tree), len({r.get("pid") for r in mine}))

        gen_names, gen_roots, gen_procs = _trace_view(gen_tid)
        pred_names, pred_roots, pred_procs = _trace_view(pred_tid)
        gen_ok = (gen_roots == 1 and gen_procs >= 2 and
                  {"router.http_generate", "router.generate",
                   "http.generate", "decode.queue_wait",
                   "decode.prefill", "decode.ttft"} <= gen_names)
        pred_ok = (pred_roots == 1 and pred_procs >= 2 and
                   {"router.predict", "router.attempt", "http.predict",
                    "serve.queue_wait", "serve.batch"} <= pred_names)
        trace_ok = gen_ok and pred_ok

        # ---- gate 5: telemetry pipeline + SLO burn-rate -------------
        # recorder on across router + every replica pid, a tight
        # latency SLO, one slow replica (sleep shim) breaching the fast
        # burn window -> slo_alert fires, lifts -> clears; the
        # recorder's p50 overhead is reported like the trace gate's.
        from paddle_tpu_torch.observability import events as _oevents
        from paddle_tpu_torch.observability import slo as _slo_mod
        from paddle_tpu_torch.observability import timeseries as _ts_mod

        ts_dir = os.path.join(tmpdir, "ts")
        shim_file = os.path.join(tmpdir, "slow_shim")
        slo_name = "predict-latency"
        # freeze the fleet: this gate measures recorder overhead and
        # drives a deliberate latency brownout — autoscale reactions
        # would fight both
        if scaler is not None:
            scaler.stop()
        # sampling off again: this A/B isolates the RECORDER's cost
        os.environ["PADDLE_TPU_TRACE_SAMPLE"] = "0"
        ts_rec_off = _fleet_phase(url, args.rate, ab_dur, body,
                                  args.timeout_s)

        def _live_slots():
            # a retired slot may still show alive while its graceful
            # drain finishes — it is not coming back, don't count it
            return [s for s in sup.slot_info()
                    if s["alive"] and not s["retired"]]

        def _respawn_fleet(n_live):
            """Recycle every live slot so respawned replicas inherit
            the env flipped since boot (TS recording, shim arming)."""
            for s in _live_slots():
                sup.kill_slot(s["slot"])
                deadline = time.time() + 180
                while len(_live_slots()) < n_live:
                    if time.time() > deadline:
                        raise RuntimeError("slot never respawned")
                    time.sleep(0.2)
            time.sleep(1.0)   # let the rendezvous drop the dead member
            wait_healthy(n_live)

        n_live = len(_live_slots())
        os.environ["PADDLE_TPU_TS_DIR"] = ts_dir
        os.environ["PADDLE_TPU_TS_INTERVAL_S"] = "0.5"
        # arm the sleep shim for respawns too (inert until the file
        # exists); every replica recycled below records AND can be
        # slowed later by just creating shim_file
        os.environ["PADDLE_TPU_SLOW_SHIM_FILE"] = shim_file
        _respawn_fleet(n_live)
        _ts_mod.maybe_start_recorder()  # the router side of the fleet
        # settle phase (discarded): the just-respawned fleet pays cold
        # sockets / first-batch costs that are respawn artifacts, not
        # recorder overhead
        _fleet_phase(url, args.rate, ab_dur, body, args.timeout_s)
        ts_rec_on = _fleet_phase(url, args.rate, ab_dur, body,
                                 args.timeout_s)
        ts_p50_off = _percentile([ms for (_, ms, oc) in ts_rec_off
                                  if oc == "ok"], 50)
        ts_p50_on = _percentile([ms for (_, ms, oc) in ts_rec_on
                                 if oc == "ok"], 50)
        ts_overhead = (ts_p50_on / ts_p50_off) \
            if ts_p50_off and ts_p50_on else None
        ts_overhead_ok = ts_overhead is not None and \
            (ts_overhead <= 1.05 or (ts_p50_on - ts_p50_off) <= 2.5)

        # a tight latency objective with bench-scale burn windows: one
        # slow replica pushes well past 1% of requests over 0.5s (burn
        # >> 14.4 on a 99% target), healthy traffic stays far under
        slo_spec_path = os.path.join(tmpdir, "slos.json")
        with open(slo_spec_path, "w") as f:  # bench-local scratch file
            json.dump({"slos": [{
                "name": slo_name, "type": "latency", "target": 0.99,
                "metric": "paddle_tpu_fleet_request_seconds",
                "threshold_s": 0.5,
                "windows": [
                    {"name": "fast", "short_s": 2.0, "long_s": 6.0,
                     "burn": 14.4},
                    {"name": "slow", "short_s": 6.0, "long_s": 18.0,
                     "burn": 6.0}]}]}, f)
        slo_engine = _slo_mod.SLOEngine(
            _slo_mod.load_spec(slo_spec_path), ts_dir)
        slo_engine.evaluate()

        def _obsdump(*cmd):
            out = subprocess.run(
                [sys.executable,
                 os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "obsdump.py")] + list(cmd),
                capture_output=True, text=True, timeout=120)
            return out.returncode, out.stdout

        # breach: the shim file makes every armed replica sleep 0.75s
        # per predict — drive load until the fast pair confirms
        with open(shim_file, "w") as f:  # presence is the signal
            f.write("0.75")
        breach_t0 = time.time()
        fired = False
        while time.time() - breach_t0 < 60.0:
            _fleet_phase(url, args.rate, 1.0, body, args.timeout_s + 5)
            slo_engine.evaluate()
            if slo_engine.state(slo_name) == "fast_burn":
                fired = True
                break
        breach_s = round(time.time() - breach_t0, 3)
        dump_rc_b, dump_out_b = _obsdump("slo", ts_dir, "--spec",
                                         slo_spec_path)
        obsdump_breach_ok = dump_rc_b == 0 and "fast_burn" in dump_out_b

        # recovery: lift the shim, keep traffic flowing until the
        # short windows drain and the alert clears
        os.unlink(shim_file)
        clear_t0 = time.time()
        cleared = False
        while fired and time.time() - clear_t0 < 60.0:
            _fleet_phase(url, args.rate, 1.0, body, args.timeout_s)
            slo_engine.evaluate()
            if slo_engine.state(slo_name) == "ok":
                cleared = True
                break
        clear_s = round(time.time() - clear_t0, 3)
        dump_rc_c, dump_out_c = _obsdump("slo", ts_dir, "--spec",
                                         slo_spec_path, "--json")
        try:
            clear_rows = json.loads(dump_out_c)
        except ValueError:
            clear_rows = []
        obsdump_clear_ok = dump_rc_c == 0 and any(
            r.get("name") == slo_name and r.get("state") == "ok"
            for r in clear_rows)

        slo_events = [e for e in _oevents.recent(4096, kind="slo_alert")
                      if e.get("slo") == slo_name]
        slo_states = [e.get("state") for e in slo_events]
        alert_ok = fired and cleared and "fast_burn" in slo_states \
            and "ok" in slo_states

        # fleet-merged dashboard: router + >= 2 replica pids recording
        top_rc, top_out = _obsdump("top", ts_dir, "--window", "30",
                                   "--json")
        try:
            top_view = json.loads(top_out)
        except ValueError:
            top_view = {}
        ts_pids = (top_view.get("pids") or [])
        top_ok = (top_rc == 0 and len(ts_pids) >= 3
                  and top_view.get("fleet", {}).get("req_per_s", 0) > 0
                  and top_view.get("fleet", {}).get("p99_ms") is not None)

        slo_ok = (alert_ok and obsdump_breach_ok and obsdump_clear_ok
                  and top_ok)

        detail_base = {
            "platform": platform, "smoke": bool(args.smoke),
            "rate_rps": args.rate, "duration_s": args.duration,
            "replicas": args.replicas, "fleet_max": args.fleet_max,
            "boot_s": round(boot_s, 3),
            **launches.read(),
        }
        for metric, value, unit, detail in (
                ("fleet_failover_failed_requests",
                 oc1["error"] + oc1["timeout"] + oc1["rejected"],
                 "count",
                 dict(detail_base, **oc1, killed=kill_state["endpoint"],
                      ejections=ejections, retries=retried,
                      respawn_s=round(respawn_s, 3),
                      gate_ok=failover_ok,
                      acceptance="SIGKILL one replica under load -> "
                                 "zero failed client requests")),
                ("fleet_scaleout_p99_recovered",
                 int(p99_recovered), "bool",
                 dict(detail_base, **oc2, scale_outs=scale_outs,
                      new_replicas=new_eps,
                      warmstart_adopted=adopted,
                      scaleout_s=scaleout_s,
                      peak_window_p99_ms=peak_p99,
                      tail_p99_ms=tail_p99,
                      p99_recover_factor=args.p99_recover_factor,
                      gate_ok=scaleout_ok,
                      acceptance="2x step -> warmstart scale-out with "
                                 "no failed request; tail p99 against "
                                 "factor x peak reported")),
                ("fleet_scalein_dropped_requests", results["fail"],
                 "count",
                 dict(detail_base, burst=burst_n, ok=results["ok"],
                      drained_endpoint=drained, gate_ok=scalein_ok,
                      acceptance="graceful drain -> zero dropped "
                                 "in-flight requests")),
                ("fleet_trace_reconstructed",
                 int(gen_ok and pred_ok), "bool",
                 dict(detail_base, trace_dir=trace_dir,
                      generate_trace_id=gen_tid,
                      generate_spans=sorted(gen_names),
                      generate_roots=gen_roots,
                      generate_processes=gen_procs,
                      generate_error=gen_err,
                      predict_trace_id=pred_tid,
                      predict_spans=sorted(pred_names),
                      predict_roots=pred_roots,
                      predict_processes=pred_procs,
                      gate_ok=trace_ok,
                      acceptance="one sampled generate reassembles to "
                                 "a single tree spanning router -> "
                                 "replica -> decode with queue-wait, "
                                 "phase, and TTFT spans")),
                ("fleet_trace_overhead_p50", overhead
                 if overhead is not None else -1.0, "ratio",
                 dict(detail_base, p50_off_ms=p50_off, p50_on_ms=p50_on,
                      abs_delta_ms=(p50_on - p50_off)
                      if p50_on and p50_off else None,
                      overhead_ok=overhead_ok,
                      acceptance="PADDLE_TPU_TRACE_SAMPLE=1.0 predict "
                                 "p50 against 1.05x tracing-off (or "
                                 "2.5ms absolute), reported")),
                ("fleet_slo_alert_fired", int(alert_ok), "bool",
                 dict(detail_base, slo=slo_name,
                      states_seen=slo_states,
                      breach_detect_s=breach_s, clear_s=clear_s,
                      obsdump_breach_ok=obsdump_breach_ok,
                      obsdump_clear_ok=obsdump_clear_ok,
                      ts_dir=ts_dir, slo_spec=slo_spec_path,
                      gate_ok=alert_ok,
                      acceptance="slow-replica shim breaches the fast "
                                 "burn pair -> slo_alert fast_burn, "
                                 "shim lifted -> clears to ok, obsdump "
                                 "slo reflects both states")),
                ("fleet_ts_recording_pids", len(ts_pids), "count",
                 dict(detail_base, ts_dir=ts_dir, pids=ts_pids,
                      fleet_req_per_s=top_view.get(
                          "fleet", {}).get("req_per_s"),
                      fleet_p99_ms=top_view.get(
                          "fleet", {}).get("p99_ms"),
                      gate_ok=top_ok,
                      acceptance="obsdump top merges the TS dir across "
                                 "router + >= 2 replica pids into one "
                                 "fleet dashboard")),
                ("fleet_ts_overhead_p50", ts_overhead
                 if ts_overhead is not None else -1.0, "ratio",
                 dict(detail_base, p50_off_ms=ts_p50_off,
                      p50_on_ms=ts_p50_on,
                      abs_delta_ms=(ts_p50_on - ts_p50_off)
                      if ts_p50_on and ts_p50_off else None,
                      overhead_ok=ts_overhead_ok,
                      acceptance="PADDLE_TPU_TS_DIR recording predict "
                                 "p50 against 1.05x recorder-off (or "
                                 "2.5ms absolute), reported"))):
            print(json.dumps({"metric": metric, "value": value,
                              "unit": unit, "detail": detail}),
                  flush=True)
        rc = 0 if (failover_ok and scaleout_ok and scalein_ok
                   and trace_ok and slo_ok) else 1
    finally:
        if scaler is not None:
            scaler.stop()
        front.stop()
        sup.stop()
    return rc


def main(argv=None) -> int:
    args = _build_args(argv)
    if args.smoke:
        smoke_settings(args)
    sys.path.insert(0, _REPO)
    from paddle_tpu_torch import resolve_device

    # --smoke runs on the CPU; everything else on the card
    device = resolve_device("cpu" if args.smoke else None)
    if args.fleet:
        return run_fleet_bench(args, device=device)
    if args.tenants:
        return run_tenants_bench(args, device=device)
    if args.tokens and args.prefix_share:
        return run_prefix_bench(args, device=device)
    if args.tokens:
        return run_token_bench(args, device=device)
    return run_bench(args, device=device)


if __name__ == "__main__":
    sys.exit(main())
