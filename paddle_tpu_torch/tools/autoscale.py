#!/usr/bin/env python
"""autoscale — run a serving fleet with elastic autoscaling.

Counterpart of the JAX package's tools/autoscale.py, with its flags,
defaults and JSON lines. Operator entry for the fleet tier (SERVING.md
§Fleet): boots a ReplicaSupervisor (N warmstart-booted replica
processes heartbeating into a shared rendezvous store), a Router +
RouterServer HTTP front on --port, and the Autoscaler control loop
that moves the replica count within [--min, --max] on queue-depth/p99
with hysteresis.

    python -m paddle_tpu_torch.tools.autoscale --model-dir M \
        [--warmstart ART] \
        [--replicas 2] [--min 1] [--max 4] [--port 8600] \
        [--high-load 4] [--low-load 0.5] [--p99-high-ms 500] \
        [--rdzv-dir DIR] [--cpu] [--duration 0]

Prints one JSON status line per --status-every seconds (replica set,
per-replica health/load, router outcome counts, autoscaler actions).
--duration 0 runs until Ctrl-C; the shutdown path drains every replica
gracefully. `paddle_tpu_torch/tools/obsdump.py fleet` renders the same
story offline from a metrics snapshot.

The replicas serve on the card (`cuda`) unless --cpu is given; without
--cpu the tool raises before it spawns anything when CUDA is absent
(`paddle_tpu_torch.resolve_device`). On one card every replica shares
the chip.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _build_args(argv=None):
    ap = argparse.ArgumentParser(prog="autoscale", description=__doc__)
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--warmstart", default="",
                    help="warmstart artifact the replicas boot from "
                    "(scale-out serves in seconds)")
    ap.add_argument("--buckets", default="")
    ap.add_argument("--replicas", type=int, default=2,
                    help="initial replica count")
    ap.add_argument("--min", type=int, default=1, dest="min_replicas")
    ap.add_argument("--max", type=int, default=4, dest="max_replicas")
    ap.add_argument("--port", type=int, default=8600,
                    help="router HTTP port (0 = ephemeral)")
    ap.add_argument("--rdzv-dir", default="",
                    help="shared membership store (default: temp dir)")
    ap.add_argument("--high-load", type=float, default=4.0)
    ap.add_argument("--low-load", type=float, default=0.5)
    ap.add_argument("--p99-high-ms", type=float, default=None)
    ap.add_argument("--interval-s", type=float, default=0.5)
    ap.add_argument("--out-cooldown-s", type=float, default=5.0)
    ap.add_argument("--in-cooldown-s", type=float, default=10.0)
    ap.add_argument("--max-respawns", type=int, default=3)
    ap.add_argument("--log-dir", default="")
    ap.add_argument("--status-every", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=0.0,
                    help="seconds to run (0 = until Ctrl-C)")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU replicas (fleet simulation)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _build_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.distributed.launch_serve import (
        ReplicaSpec, ReplicaSupervisor)
    from paddle_tpu_torch.serving.autoscale import Autoscaler
    from paddle_tpu_torch.serving.router import Router, RouterServer

    resolve_device("cpu" if args.cpu else None)

    rdzv_dir = args.rdzv_dir or tempfile.mkdtemp(prefix="fleet_rdzv_")
    spec = ReplicaSpec(args.model_dir,
                       warmstart=args.warmstart or None,
                       buckets=args.buckets or None, cpu=args.cpu)
    sup = ReplicaSupervisor(spec, rdzv_dir, replicas=args.replicas,
                            max_respawns=args.max_respawns,
                            log_dir=args.log_dir or None)
    router = Router(rdzv_dir=rdzv_dir)
    front = RouterServer(router)
    scaler = Autoscaler(router, sup,
                        min_replicas=args.min_replicas,
                        max_replicas=args.max_replicas,
                        high_load=args.high_load,
                        low_load=args.low_load,
                        p99_high_ms=args.p99_high_ms,
                        interval_s=args.interval_s,
                        out_cooldown_s=args.out_cooldown_s,
                        in_cooldown_s=args.in_cooldown_s)
    sup.start()
    port = front.start(args.port)
    scaler.start()
    print(json.dumps({"fleet": "up", "router_port": port,
                      "rdzv_dir": rdzv_dir,
                      "replicas": sup.endpoints()}), flush=True)
    t_end = time.monotonic() + args.duration if args.duration else None
    try:
        while t_end is None or time.monotonic() < t_end:
            time.sleep(args.status_every)
            st = router.status()
            print(json.dumps({
                "ts": round(time.time(), 3),
                "replicas": st["world_size"],
                "healthy": st["healthy"],
                "requests": st["requests"],
                "retries": st["retries"],
                "recent_p99_ms": st["recent_p99_ms"],
                "autoscaler": scaler.status()["actions"],
            }), flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        scaler.stop()
        front.stop()
        sup.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
