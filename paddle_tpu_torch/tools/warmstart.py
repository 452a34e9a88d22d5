#!/usr/bin/env python
"""warmstart — bake a serving model's warm phase grid offline.

Counterpart of the JAX package's tools/warmstart.py, with its
subcommands, flags, defaults, exit codes and JSON lines.

Usage:
  python -m paddle_tpu_torch.tools.warmstart bake --model-dir DIR
                    --out ART [--buckets 1,2,4,8] [--max-batch N] [--cpu]
  python -m paddle_tpu_torch.tools.warmstart bake-decode --out ART
                    [--preset tiny] [--seed 0]
                    [--slots 4,8] [--prefill-buckets 8,16,32]
                    [--prefill-chunk C] [--spec-k K]
                    [--block-size 16] [--num-blocks N]
                    [--precision bf16] [--cpu]
  python paddle_tpu_torch/tools/warmstart.py inspect ART

`bake` builds a predict `Engine` from --model-dir, warms every bucket
and writes the engine's warmstart artifact (`Engine.export_warmstart`).
`bake-decode` builds the decode engine's whole phase grid (every
prefill bucket, or with `--prefill-chunk` the one chunk phase, plus
every decode slot count, plus with `--spec-k` the self-draft's prefill
and decode phases and the verify phase), warms it and writes
`DecodeEngine.export_warmstart`'s artifact. The model is
`GPTConfig.tiny()` (the only preset, as in the JAX tool; `bake_decode`
takes any GPTConfig as a keyword) with weights drawn from a CPU
`torch.Generator` seeded by --seed and then moved to the device: CPU
draws are the same in every process, so an engine built the same way
in another process has the same model digest and adopts the artifact.

Both run on the card (`cuda`) unless --cpu is given, and raise when
CUDA is asked for and absent. Each prints one JSON line: phases or
buckets warmed, entries written, the warm-up seconds and the artifact's
size.

The port's artifact is JSON and carries each phase's fingerprint (its
input shapes and dtypes and the hashes of the kernel sources it runs),
not an executable: a CUDA graph cannot be serialized. An engine that
adopts an entry warms that phase again in its own process, so a warm
boot takes about as long as a cold one; the printed `warmup_seconds`
and an engine's time to healthy are what they measure. The artifact is
bound to its environment (torch and CUDA versions, device, TF32 flags,
kernel sources) and to the model and grid (the model digest); an engine
refuses a mismatched one with a `warmstart` reject event and adopts
nothing.

`inspect` reads the artifact with the stdlib only (run by file path it
imports neither torch nor this package) and prints its metadata and
entries. It parses JSON and executes nothing from the file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DECODE_FORMAT = "paddle_tpu_torch-decode-warmstart-v1"
# the environment keys of an artifact (core/compile_cache.py's
# environment_meta), printed by inspect
ENV_KEYS = ("torch_version", "cuda_runtime", "device_name", "capability",
            "tf32_matmul", "tf32_cudnn", "float32_matmul_precision",
            "kernel_sources")


def _device(args):
    """The tool's device: the CPU with --cpu, else cuda (raises when
    CUDA is absent)."""
    sys.path.insert(0, _REPO)
    from paddle_tpu_torch import resolve_device

    return resolve_device("cpu" if args.cpu else None)


def _ints(text):
    return sorted({int(x) for x in text.split(",")})


def cmd_bake(args) -> int:
    device = _device(args)
    from paddle_tpu_torch.serving.engine import Engine, ServingConfig

    buckets = None
    if args.buckets:
        try:
            buckets = _ints(args.buckets)
        except ValueError:
            print(f"bake: bad --buckets {args.buckets!r} (want e.g. "
                  f"1,2,4,8)", file=sys.stderr)
            return 2
    cfg = ServingConfig(args.model_dir, buckets=buckets,
                        max_batch=args.max_batch,
                        use_tpu=device.type == "cuda", aot=True)
    t0 = time.perf_counter()
    engine = Engine(cfg)
    ready = engine.warmup()
    warm_s = time.perf_counter() - t0
    n = engine.export_warmstart(args.out)
    print(json.dumps({
        "artifact": args.out,
        "model_dir": args.model_dir,
        "buckets": [int(b) for b in engine.policy.buckets],
        "buckets_ready": ready,
        "entries": n,
        "warmup_seconds": round(warm_s, 3),
        "artifact_bytes": os.path.getsize(args.out),
    }), flush=True)
    return 0 if n else 1


def decode_engine(args, cfg=None):
    """The DecodeEngine `bake-decode` bakes, built and never warmed:
    `cfg` (default `GPTConfig.tiny()`) with weights from a CPU
    `torch.Generator` seeded by `args.seed`, on the tool's device, in
    the DecodeConfig the flags give. Raises ValueError on a bad
    --preset, --slots or --prefill-buckets."""
    device = _device(args)
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

    if cfg is None:
        if args.preset != "tiny":
            raise ValueError(
                f"unknown --preset {args.preset!r} (only 'tiny' is "
                "shipped; build bigger grids through the DecodeEngine "
                "API)")
        cfg = gpt.GPTConfig.tiny()
    try:
        slots = _ints(args.slots)
        buckets = _ints(args.prefill_buckets)
    except ValueError:
        raise ValueError("bad --slots/--prefill-buckets (want e.g. 4,8)")
    params, _ = gpt.init(torch.Generator(device="cpu").manual_seed(
        int(args.seed)), cfg, device=device)
    max_len = args.max_len or cfg.max_len
    blocks_per_seq = -(-max_len // args.block_size)
    num_blocks = args.num_blocks or (1 + max(slots) * blocks_per_seq)
    grid_kw = {}
    if args.prefill_chunk:
        # chunked path: the bucket dimension collapses into one chunk
        # phase, so --prefill-buckets is ignored for the grid key
        grid_kw["prefill_chunk"] = args.prefill_chunk
    else:
        grid_kw["prefill_buckets"] = buckets
    dc = DecodeConfig(block_size=args.block_size, num_blocks=num_blocks,
                      decode_slots=slots, max_len=max_len,
                      precision=args.precision, spec_k=args.spec_k,
                      **grid_kw)
    # self-draft: the same params serve as the draft model, so the baked
    # draft and verify phases stay deterministic from --seed
    draft = (params, cfg) if args.spec_k else None
    return DecodeEngine(params, cfg, dc, draft=draft, device=device)


def bake_decode(args, cfg=None):
    """Build `decode_engine(args, cfg)`, warm its grid and write its
    artifact to `args.out`. Returns the JSON line's dict."""
    t0 = time.perf_counter()
    engine = decode_engine(args, cfg)
    try:
        ready = engine.warmup()
        warm_s = time.perf_counter() - t0
        n = engine.export_warmstart(args.out)
    finally:
        engine.stop()
    slots = list(engine.decode_slots)
    grid_out = {"decode_slots": slots, "spec_k": args.spec_k}
    if args.prefill_chunk:
        grid_out["prefill_chunk"] = args.prefill_chunk
    else:
        grid_out["prefill_buckets"] = list(engine.prefill_buckets)
    return {
        "artifact": args.out,
        "preset": args.preset, "seed": args.seed,
        "phase_grid": grid_out,
        "phases_ready": ready,
        "entries": n,
        "precision": args.precision,
        "warmup_seconds": round(warm_s, 3),
        "artifact_bytes": os.path.getsize(args.out),
    }


def cmd_bake_decode(args) -> int:
    try:
        out = bake_decode(args)
    except ValueError as e:
        print(f"bake-decode: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0 if out["entries"] else 1


def cmd_inspect(args) -> int:
    try:
        with open(args.artifact, "rb") as f:
            art = json.loads(f.read())
    except (OSError, ValueError) as e:
        print(f"inspect: cannot read {args.artifact}: {e}",
              file=sys.stderr)
        return 2
    if not isinstance(art, dict) or "entries" not in art:
        print(f"inspect: {args.artifact} is not a warmstart artifact",
              file=sys.stderr)
        return 2
    # a dict with "entries" can still be malformed (hand-edited,
    # truncated, a future format): a diagnostic and rc 2, no traceback
    try:
        entries = art["entries"]
        if art.get("format") == DECODE_FORMAT:
            # decode artifacts key entries by phase, not by feed
            # signature
            signatures = [
                {"phase": f"{e['phase']}@{int(e['size'])}",
                 "fingerprint": (e.get("fingerprint") or "")[:16]}
                for e in sorted(entries, key=lambda e: (
                    str(e["phase"]), int(e["size"])))]
        else:
            signatures = [
                {"feeds": [f"{n}:{list(s)}:{d}"
                           for n, s, d in e["signature"]],
                 "fingerprint": (e.get("fingerprint") or "")[:16]}
                for e in sorted(entries, key=lambda e: json.dumps(
                    e["signature"]))]
        report = {"format": art.get("format"),
                  **{k: art.get(k) for k in ENV_KEYS},
                  "model_digest": art.get("model_digest"),
                  "buckets": art.get("buckets"),
                  "phase_grid": art.get("grid"),
                  "created_at": art.get("created_at"),
                  "entries": len(entries),
                  "signatures": signatures}
    except Exception as e:
        print(f"inspect: {args.artifact} has malformed entries: {e!r}",
              file=sys.stderr)
        return 2
    print(json.dumps(report, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The tool's parser: `build_parser().parse_args([...])` gives the
    Namespace that `decode_engine` and `bake_decode` take."""
    ap = argparse.ArgumentParser(prog="warmstart", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    bp = sub.add_parser("bake", help="warm every bucket and write the "
                        "engine's warmstart artifact")
    bp.add_argument("--model-dir", required=True,
                    help="saved inference model directory")
    bp.add_argument("--out", required=True, help="artifact path")
    bp.add_argument("--buckets", default=None,
                    help="comma-separated batch buckets (default: pow2 "
                    "up to --max-batch)")
    bp.add_argument("--max-batch", type=int, default=64)
    bp.add_argument("--cpu", action="store_true",
                    help="bake on the CPU (artifacts are device-bound)")
    bp.set_defaults(fn=cmd_bake)

    dp = sub.add_parser("bake-decode", help="bake a decode engine's "
                        "full phase grid (prefill buckets + decode slot "
                        "configs) into one artifact")
    dp.add_argument("--out", required=True, help="artifact path")
    dp.add_argument("--preset", default="tiny",
                    help="model preset (deterministic from --seed)")
    dp.add_argument("--seed", type=int, default=0)
    dp.add_argument("--slots", default="4,8",
                    help="comma-separated decode slot counts")
    dp.add_argument("--prefill-buckets", default="8,16,32",
                    help="comma-separated prompt-length buckets")
    dp.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill slice size; collapses the "
                    "prefill buckets into one chunk phase (0 = off)")
    dp.add_argument("--spec-k", type=int, default=0,
                    help="speculative-decoding draft length; bakes the "
                    "draft + verify phases with a self-draft (0 = off)")
    dp.add_argument("--block-size", type=int, default=16)
    dp.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool blocks (default: worst-case for the "
                    "slot count)")
    dp.add_argument("--max-len", type=int, default=None)
    dp.add_argument("--precision", default="bf16",
                    choices=("f32", "bf16"))
    dp.add_argument("--cpu", action="store_true",
                    help="bake on the CPU (artifacts are device-bound)")
    dp.set_defaults(fn=cmd_bake_decode)

    ip = sub.add_parser("inspect", help="print an artifact's metadata "
                        "(stdlib only, no torch import)")
    ip.add_argument("artifact")
    ip.set_defaults(fn=cmd_inspect)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
