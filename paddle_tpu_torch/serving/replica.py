"""One fleet replica process: `python -m paddle_tpu_torch.serving.replica`.
Counterpart of the JAX package's `serving/replica.py`.

The unit the ReplicaSupervisor (distributed/launch_serve.py) spawns and
the Router (serving/router.py) discovers: boots a `serving.Server` (its
predict slot from `--model-dir`, adopting a warmstart artifact when one
is given; a decode engine with `--decode-tiny`), registers its endpoint
as a `FileRendezvous` member (worker_id is the "host:port" endpoint; the
heartbeat thread keeps it live), and serves until SIGTERM, which runs
the graceful scale-in sequence:

  1. leave the rendezvous (the router's next poll stops picking it),
  2. drain (the listener stays up: in-flight work finishes, stragglers
     get 503 + Retry-After and fail over through the router),
  3. stop, exit 0 (rc 0 tells the supervisor the exit was deliberate;
     anything else is a crash and respawns the slot).

The replica serves on the card (`cuda`) unless `--cpu` is given, which
serves on the CPU (fleet simulation and tests); there is no fallback.
`--decode-tiny SEED` builds `GPTConfig.tiny()` at f32 with weights from
a `torch.Generator` seeded with SEED, in the JAX replica's
`DecodeConfig`. `--model-id` names the model the default slot serves
(advertised through /v1/load for the router's model-aware picks),
`--qos FILE` loads a tier/tenant policy JSON for the predict slot's
weighted-fair admission, and `--registry DIR` watches a model registry
so newly published artifact versions are hot-swapped in without a
restart.

Stdout speaks one JSON "ready" line once serving (the supervisor and
callers wait on it): {"ready": true, "endpoint": ..., "pid": ...,
"warmstart_adopted": n, "slot": k}.

With PADDLE_TPU_TS_DIR set the replica records its metrics' time
series (`observability.timeseries`) and takes the recorder's final
sample at exit, as the JAX replica does.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

# the JAX replica's tiny decode engine (paddle_tpu/serving/replica.py)
TINY_DECODE = dict(block_size=8, num_blocks=64, decode_slots=(4,),
                   prefill_buckets=(8, 16), precision="f32", max_len=64)


def _build_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.serving.replica", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model-dir", default="",
                    help="saved inference model for the predict path "
                    "(optional when --decode-tiny builds a decode-only "
                    "replica)")
    ap.add_argument("--decode-tiny", type=int, default=None,
                    metavar="SEED",
                    help="attach a tiny-GPT continuous-batching decode "
                    "engine initialized from this seed (POST "
                    "/v1/generate)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (printed in the "
                    "ready line and registered in the rendezvous)")
    ap.add_argument("--rdzv-dir", default="",
                    help="fleet membership store (PADDLE_TPU_RDZV_DIR "
                    "fallback); empty = standalone replica")
    ap.add_argument("--warmstart", default="",
                    help="warmstart artifact of the predict engine")
    ap.add_argument("--slot", type=int, default=-1,
                    help="supervisor slot id (informational)")
    ap.add_argument("--buckets", default="",
                    help="comma batch buckets (default: policy pow2)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-queue", type=int, default=128)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--timeout-s", type=float, default=30.0)
    ap.add_argument("--precision", default="f32")
    ap.add_argument("--drain-timeout-s", type=float, default=30.0)
    ap.add_argument("--heartbeat-s", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU (device=\"cpu\"): fleet "
                    "simulation and tests")
    ap.add_argument("--model-id", default="default",
                    help="model id this replica's default slot serves "
                    "(advertised in /v1/load for the router's "
                    "model-aware picks)")
    ap.add_argument("--qos", default="",
                    help="path to a QoS policy JSON file ({tiers, "
                    "default_tier, tenants}) enabling tiered "
                    "admission + weighted-fair scheduling")
    ap.add_argument("--registry", default="",
                    help="model registry root to watch: newly "
                    "published artifact versions are hot-swapped in "
                    "with zero downtime")
    ap.add_argument("--registry-poll-s", type=float, default=1.0)
    return ap.parse_args(argv)


def _tiny_decode(seed: int, device: str):
    """GPTConfig.tiny() at f32, its weights from a torch.Generator
    seeded with `seed` on `device`, in the JAX replica's DecodeConfig."""
    import torch

    from ..models import gpt
    from .decode import DecodeConfig, DecodeEngine

    mcfg = gpt.GPTConfig.tiny()
    mcfg.dtype = "float32"
    params, _ = gpt.init(torch.Generator(device=device).manual_seed(
        int(seed)), mcfg, device=device)
    return DecodeEngine(params, mcfg, DecodeConfig(**TINY_DECODE),
                        device=device)


def main(argv=None) -> int:
    args = _build_args(argv)
    from .engine import ServingConfig
    from .httpd import Server

    if not args.model_dir and args.decode_tiny is None:
        print(json.dumps({"ready": False,
                          "error": "need --model-dir and/or "
                                   "--decode-tiny"}), flush=True)
        return 2
    decode = None
    if args.decode_tiny is not None:
        decode = _tiny_decode(args.decode_tiny,
                              "cpu" if args.cpu else "cuda")
    buckets = tuple(int(b) for b in args.buckets.split(",")) \
        if args.buckets else None
    qos = None
    if args.qos:
        with open(args.qos) as f:
            qos = json.load(f)
    cfg = ServingConfig(
        args.model_dir or None, buckets=buckets,
        max_batch=args.max_batch,
        max_queue=args.max_queue, max_wait_ms=args.max_wait_ms,
        timeout_s=args.timeout_s, precision=args.precision,
        warmstart=args.warmstart or None, use_tpu=not args.cpu,
        host=args.host, qos=qos, model_id=args.model_id)
    server = Server(cfg, decode=decode)
    if args.registry:
        from .registry import ModelRegistry

        server.attach_registry(ModelRegistry(args.registry),
                               poll_s=args.registry_poll_s)
    port = server.start(args.port)
    endpoint = f"{args.host}:{port}"
    # env-gated time-series recording (PADDLE_TPU_TS_DIR): Server.start
    # already tried; call again explicitly so a replica records even
    # when the supervisor flips the env on between respawns
    from ..observability import timeseries as _timeseries

    _timeseries.maybe_start_recorder()

    rdzv = None
    rdzv_dir = args.rdzv_dir or os.environ.get("PADDLE_TPU_RDZV_DIR", "")
    if rdzv_dir:
        from ..distributed.rendezvous import FileRendezvous

        rdzv = FileRendezvous(rdzv_dir, worker_id=endpoint,
                              min_workers=1,
                              heartbeat_s=args.heartbeat_s,
                              dead_after_s=max(2.5,
                                               5 * args.heartbeat_s))
        rdzv.register()
        rdzv.start_heartbeat()

    stop_ev = threading.Event()

    def _on_term(signum, frame):
        stop_ev.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    print(json.dumps({
        "ready": True, "endpoint": endpoint, "pid": os.getpid(),
        "slot": args.slot,
        "warmstart_adopted":
            server.engine.warmstart_adopted
            if server.engine is not None else 0}), flush=True)

    stop_ev.wait()
    # graceful scale-in: stop being routable first, then finish the
    # in-flight work, then tear down
    if rdzv is not None:
        rdzv.leave()
    server.drain(timeout=args.drain_timeout_s)
    server.stop()
    # publish any buffered sampled spans before exit, so a trace-dir
    # reassembly sees this replica's half of the tree, and take the
    # recorder's final time-series sample for the same reason (a
    # replica shorter than the interval must still record)
    from ..observability import tracing as _tracing

    _tracing.flush_trace_sink()
    _timeseries.stop_recorder()
    return 0


if __name__ == "__main__":
    sys.exit(main())
