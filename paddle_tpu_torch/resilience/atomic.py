# Copied from the JAX package: paddle_tpu/resilience/atomic.py
# (stdlib only). Keep it in step with that file.
"""Crash-safe file writes: tmp-file-in-same-directory + os.replace.

Every durable artifact the framework writes (checkpoints, inference
models, quantization metadata, traces) must be either fully present or
absent — a process killed mid-`np.savez` must never leave a truncated
`.npz` that a later `restore_latest()`/`load_inference_model` trips
over. The pattern is the one already proven in native_build.py (the .so
+ .stamp writer): write the complete payload to a temp file in the SAME
directory (os.replace is only atomic within a filesystem), fsync, then
rename onto the final name. POSIX rename atomicity guarantees readers
see the old bytes or the new bytes, never a mix.

This module is stdlib-only at import (numpy loads lazily inside the
array helpers) so the io/observability layers can depend on it without
cost. tests/test_evidence_lint.py enforces that bare `open(..., "w")` /
`np.save` / `json.dump` calls inside paddle_tpu/ go through these
helpers (or carry an explicit `# atomic-exempt:` justification).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
from typing import Any, Iterator

__all__ = ["atomic_open", "np_save", "np_savez", "json_dump",
           "write_bytes", "write_text"]

_tmp_seq = itertools.count()


def _open_tmp(d: str, base: str):
    """Create a unique temp file in `d` with umask-default permissions.
    tempfile.mkstemp would hand out 0600, silently tightening the mode
    of every checkpoint/model the framework saves (a trainer's export
    would become unreadable to the inference service account); O_CREAT
    with mode 0666 lets the process umask decide, like plain open()."""
    while True:
        tmp = os.path.join(d, f".{base}.tmp.{os.getpid()}.{next(_tmp_seq)}")
        try:
            fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o666)
        except FileExistsError:
            continue  # stale tmp from a dead process with our old pid
        return fd, tmp


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "w", **kwargs) -> Iterator[Any]:
    """`open()` for durable files: yields a handle onto a same-directory
    temp file and renames it onto `path` only after the with-body
    completes without raising. On any failure the temp file is removed
    and `path` is untouched (the previous version, if any, survives).

    Mode "x"/"xb" is genuinely exclusive: the final publish uses
    os.link, which fails atomically with FileExistsError if `path`
    appeared at any point — not a racy exists() pre-check."""
    if not any(c in mode for c in "wx"):
        raise ValueError(
            f"atomic_open is for write modes, got {mode!r} — reads and "
            f"appends don't need replace semantics")
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = _open_tmp(d, os.path.basename(path))
    try:
        with os.fdopen(fd, mode.replace("x", "w"), **kwargs) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        if "x" in mode:
            os.link(tmp, path)  # atomic EEXIST on a concurrent winner
            os.unlink(tmp)
        else:
            os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def np_save(path: str, arr) -> str:
    """Atomic `np.save`. Follows numpy's naming rule (appends `.npy`
    when missing) so it is a drop-in replacement; returns the final
    path actually written."""
    import numpy as np

    final = path if path.endswith(".npy") else path + ".npy"
    with atomic_open(final, "wb") as f:
        np.save(f, arr)
    return final


def np_savez(path: str, **arrays) -> str:
    """Atomic `np.savez` (appends `.npz` when missing, like numpy)."""
    import numpy as np

    final = path if path.endswith(".npz") else path + ".npz"
    with atomic_open(final, "wb") as f:
        np.savez(f, **arrays)
    return final


def json_dump(obj, path: str, **kwargs) -> str:
    """Atomic `json.dump(obj, open(path, "w"))`."""
    with atomic_open(path, "w") as f:
        json.dump(obj, f, **kwargs)
    return path


def write_bytes(path: str, data: bytes) -> str:
    with atomic_open(path, "wb") as f:
        f.write(data)
    return path


def write_text(path: str, text: str) -> str:
    with atomic_open(path, "w") as f:
        f.write(text)
    return path
