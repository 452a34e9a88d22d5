"""What makes a warmed phase valid in this process, in its torch form.

Counterpart of the JAX package's `core/compile_cache.py::
environment_meta`. The JAX package keys serialized executables by the
jax version, the backend and device kind, XLA_FLAGS and the matmul
precision. Nothing here is serialized (a CUDA graph cannot be), so the
torch form names what would make a phase warmed in another process
behave differently here: torch's version and CUDA runtime, the device
and its compute capability, the TF32 flags (the counterpart of the
matmul precision) and the hash of every hand-written kernel's source
(`kernels/_build.py::source_hash`, the part of each library's name that
changes with the code). The rest of that module, the persistent cache
of compiled executables, has no counterpart.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from ..kernels import _build

__all__ = ["environment_meta"]


def environment_meta(device: Union[str, torch.device] = "cuda"
                     ) -> Dict[str, object]:
    """The environment keys of a warmstart artifact, for `device`:
    every value is a string, or a dict of strings (kernel name ->
    source hash), so the artifact round-trips through JSON unchanged."""
    dev = torch.device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        major, minor = torch.cuda.get_device_capability(dev)
        capability = f"{major}.{minor}"
    else:
        name = capability = "cpu"
    return {"torch_version": torch.__version__,
            "cuda_runtime": str(torch.version.cuda),
            "device_name": name, "capability": capability,
            "tf32_matmul": str(torch.backends.cuda.matmul.allow_tf32),
            "tf32_cudnn": str(torch.backends.cudnn.allow_tf32),
            "float32_matmul_precision":
                torch.get_float32_matmul_precision(),
            "kernel_sources": {n: _build.source_hash(n)
                               for n in sorted(_build.SOURCES)}}
