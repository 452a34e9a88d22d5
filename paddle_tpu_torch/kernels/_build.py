"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under `csrc/` with a plain C interface. It is
compiled at first use with `nvcc` for Hopper (`sm_90a`) into a shared
library under `build/` (listed in `.gitignore`) and loaded with
`ctypes`. A library's file name carries a hash of its source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source or
header is rebuilt and a stale build is never loaded.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "load", "source_hash"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

# kernel name -> source file under csrc/
SOURCES = {"flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "flash_attention_bias": "flash_attention_bias.cu",
           "flash_attention_bias_bwd": "flash_attention_bias_bwd.cu",
           "fused_dense_bn": "fused_dense_bn.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or nvcc on PATH. Raises when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use")
    return found


def source_hash(name: str) -> str:
    """Hash of kernel `name`'s source, the shared headers and the flags:
    the part of its library's file name that changes with the code."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_hash(name)}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one `nvcc`
    per source, all started together. Returns {name: seconds} for the
    kernels compiled by this call; raises with nvcc's output on a
    failure."""
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    took: Dict[str, float] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib
