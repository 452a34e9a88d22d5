"""The serving operator's tools: counterparts of the JAX package's
`tools/warmstart.py`, `serve_bench.py`, `obsdump.py`, `autoscale.py` and
`analyze.py`, with their subcommands, flags, defaults, exit codes and
JSON lines.

Each runs as `python -m paddle_tpu_torch.tools.<name>`, on the card
(`cuda`) unless `--cpu` is given; without a CUDA device a tool raises
(`paddle_tpu_torch.resolve_device`). `obsdump.py` and `warmstart.py
inspect` read files with the stdlib only and also run by file path
(`python paddle_tpu_torch/tools/obsdump.py ...`), which imports neither
this package's `__init__` nor torch.

This module imports nothing of this package or torch. `load` runs a
tool's file as a module of its own, without this package's `__init__`
(obsdump has its own copy, `_load_obs_module`, for the observability
modules it reads by file path).
"""

import importlib.util
import os

_DIR = os.path.dirname(os.path.abspath(__file__))


def load(name: str):
    """The tool `name` ("obsdump", "warmstart", ...) executed from its
    file as a fresh module `_tool_<name>`, without importing this
    package's `__init__`: a stdlib-only tool so loaded imports no torch."""
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
