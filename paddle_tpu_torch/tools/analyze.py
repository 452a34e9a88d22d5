#!/usr/bin/env python
"""analyze — run the static-analysis pass suite over a program, offline.

Counterpart of the JAX package's tools/analyze.py, with its flags,
exit codes and output: the CLI face of paddle_tpu_torch/analysis
(ANALYSIS.md). Validate a saved model before deploying it, lint a
hand-built/transpiled program before committing it, or render the
block as DOT to see what the passes see. The passes read the program
only: nothing runs on a device, so the tool takes no --cpu.

Usage (`python -m paddle_tpu_torch.tools.analyze ...`):
  analyze.py --model-dir DIR                 # saved __model__ dir
  analyze.py --model lenet                   # in-repo model builder
  analyze.py --program prog.json             # raw ProgramDesc JSON
  ... [--feeds a,b] [--fetches x,y]          # run binding (defaults:
                                             #   the model's saved ones)
  ... [--policy mixed_bf16]                  # precision policy to audit
  ... [--passes def_use,shape_dtype]         # subset (default: all)
  ... [--json]                               # findings as JSON lines
  ... [--dot out.dot]                        # render block 0 via
                                             #   debugger.block_to_dot
  ... [--max-findings N]                     # truncate the table

Exit code: 0 = no error-severity findings, 1 = errors found, 2 = usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _REPO)


def _load_target(args):
    """(ProgramDesc, feed_names, fetch_names) from whichever source the
    flags name."""
    if args.model_dir:
        path = os.path.join(args.model_dir, "__model__")
        with open(path) as f:
            payload = json.load(f)
        from paddle_tpu_torch.core.ir import ProgramDesc

        return (ProgramDesc.from_dict(payload["program"]),
                list(payload.get("feed_names", [])),
                list(payload.get("fetch_names", [])))
    if args.program:
        with open(args.program) as f:
            payload = json.load(f)
        from paddle_tpu_torch.core.ir import ProgramDesc

        if isinstance(payload, dict) and "program" in payload:
            return (ProgramDesc.from_dict(payload["program"]),
                    list(payload.get("feed_names", [])),
                    list(payload.get("fetch_names", [])))
        return ProgramDesc.from_dict(payload), [], []
    if args.model:
        import paddle_tpu_torch as pt

        builders = {"lenet": _build_lenet}
        if args.model not in builders:
            raise SystemExit(
                f"analyze: unknown --model {args.model!r}; choose from "
                f"{sorted(builders)} or use --model-dir/--program")
        return builders[args.model](pt)
    raise SystemExit("analyze: need one of --model-dir, --model, "
                     "--program")


def _build_lenet(pt):
    from paddle_tpu_torch.models import lenet

    main, _startup, feeds, loss, acc = lenet.build_program(pt)
    return main.desc, list(feeds), [loss.name, acc.name]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="analyze", description=__doc__)
    src = ap.add_argument_group("target")
    src.add_argument("--model-dir", help="saved-model dir holding "
                     "__model__")
    src.add_argument("--model", help="in-repo model builder (lenet)")
    src.add_argument("--program", help="raw ProgramDesc JSON file")
    ap.add_argument("--feeds", default=None,
                    help="comma-separated feed var names (default: the "
                    "model's saved feed_names)")
    ap.add_argument("--fetches", default=None,
                    help="comma-separated fetch var names (default: the "
                    "model's saved fetch_names)")
    ap.add_argument("--policy", default=None,
                    help="precision policy to audit under (f32|bf16|"
                    "mixed_bf16|mixed_f16; default f32)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass subset (default: all)")
    ap.add_argument("--json", action="store_true",
                    help="findings as JSON lines instead of the table")
    ap.add_argument("--dot", default=None,
                    help="also render block 0 as DOT to this path")
    ap.add_argument("--max-findings", type=int, default=200)
    args = ap.parse_args(argv)

    desc, saved_feeds, saved_fetches = _load_target(args)
    feeds = (args.feeds.split(",") if args.feeds else saved_feeds)
    fetches = (args.fetches.split(",") if args.fetches
               else saved_fetches)

    from paddle_tpu_torch import analysis

    passes = args.passes.split(",") if args.passes else None
    findings = analysis.run_passes(
        desc, feed_names=[f for f in feeds if f],
        fetch_names=[f for f in fetches if f],
        policy=args.policy, passes=passes, where="cli")

    if args.dot:
        # debugger.block_to_dot works on anything with .desc.vars/.ops;
        # wrap the raw BlockDesc in that shape
        from paddle_tpu_torch import debugger

        class _B:
            def __init__(self, bdesc):
                self.desc = bdesc

        from paddle_tpu_torch.resilience import atomic as _atomic

        _atomic.write_text(args.dot,
                           debugger.block_to_dot(_B(desc.block(0))))
        print(f"wrote {args.dot} (render: dot -Tpng {args.dot})",
              file=sys.stderr)

    shown = findings[:max(0, args.max_findings)]
    if args.json:
        for f in shown:
            print(json.dumps(f.to_dict()))
    else:
        n_ops = sum(len(b.ops) for b in desc.blocks)
        print(f"analyzed {n_ops} op(s) over {len(desc.blocks)} "
              f"block(s); feeds={feeds} fetches={fetches} "
              f"policy={args.policy or 'f32'}")
        if not findings:
            print("clean: no findings")
        for f in shown:
            print(f"  {f}")
        if len(findings) > len(shown):
            print(f"  ... {len(findings) - len(shown)} more "
                  f"(--max-findings)")
    errors = sum(1 for f in findings if f.severity == analysis.ERROR)
    if errors:
        print(f"{errors} error-severity finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
