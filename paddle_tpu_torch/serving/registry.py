# Copied from the JAX package: paddle_tpu/serving/registry.py (stdlib
# only). Keep it in step with that file; its declared changes: a plain
# lock, an artifact's digest read from JSON, two comment lines.
"""Content-addressed model registry: publish warmstart artifacts,
adopt them on live replicas without a restart (SERVING.md
§Multi-tenancy, "Model registry & hot-swap").

The registry is a directory:

    <root>/registry.json          the manifest (atomic JSON)
    <root>/blobs/<sha256>         content-addressed artifact blobs

`publish()` copies a model's warmstart artifact (`Engine.
export_warmstart` / `DecodeEngine.export_warmstart` output) into the
blob store under its own sha256 and records a manifest entry
`{model_id: {version, digest, model_digest, model_dir, path, ...}}`.
Publishing re-derives the model digest from `model_dir/__model__` and
REFUSES an artifact whose embedded `model_digest` disagrees — the
registry must never hand a replica an artifact baked from a different
program than the directory it names (same bucket signatures, different
computation: the silent wrong-answer failure mode the warmstart binding
checks exist to kill).

`resolve()` returns the entry after re-hashing the blob against its
recorded digest, so a torn or tampered blob is rejected at adoption
time, not served. Versions increase monotonically per model id;
`Server.attach_registry` polls the manifest and hot-swaps a model slot
when its version moves — the adopting replica pays deserialization
I/O, not XLA, so the swap happens with zero failed requests and zero
fresh compiles.

The manifest is written through `resilience.atomic` (rename-commit):
concurrent publishers serialize on the registry lock within a process,
and cross-process readers never observe a torn manifest.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Dict, Optional

from ..observability import events as _events
from ..observability import metrics as _m

__all__ = ["ModelRegistry", "RegistryError"]

MANIFEST = "registry.json"

PUBLISHES = _m.counter(
    "paddle_tpu_registry_publishes_total",
    "Artifacts published into the model registry, by model id",
    labelnames=("model",))
MODEL_VERSION = _m.gauge(
    "paddle_tpu_model_version",
    "Latest registry version per model id (on the publisher); the "
    "adopted version per model slot (on a serving replica)",
    labelnames=("model",))


class RegistryError(RuntimeError):
    """Publish/resolve refused: digest mismatch, unknown model, or a
    corrupt blob/manifest."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _artifact_model_digest(path: str) -> Optional[str]:
    """The `model_digest` a warmstart artifact was baked against
    (None when the artifact is unreadable or carries none)."""
    try:
        with open(path, "rb") as f:
            art = json.loads(f.read())
        if isinstance(art, dict):
            return art.get("model_digest")
    except Exception:  # lint-exempt:swallow: unreadable/alien artifact carries no digest — publish() then requires an explicit model_dir
        pass
    return None


class ModelRegistry:
    """Digest-addressed store of serving artifacts, one manifest entry
    per model id. Thread-safe within a process; cross-process safe for
    one publisher + many readers (atomic manifest replace)."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(os.path.join(self.root, "blobs"), exist_ok=True)
        # a plain lock: the port has no lock-order checker (the JAX
        # package's analysis.lockcheck, ROADMAP item 21)
        self._lock = threading.Lock()

    # -- manifest ------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST)

    def _read_manifest(self) -> Dict[str, Dict]:
        try:
            with open(self._manifest_path()) as f:
                man = json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, ValueError) as e:
            raise RegistryError(
                f"unreadable registry manifest "
                f"{self._manifest_path()}: {e}")
        if not isinstance(man, dict):
            raise RegistryError("registry manifest is not a JSON object")
        return man

    def models(self) -> Dict[str, Dict]:
        """Snapshot of every model's latest entry (manifest read)."""
        with self._lock:
            return self._read_manifest()

    def version(self, model_id: str) -> Optional[int]:
        """Latest published version for `model_id` (None = never
        published) — the cheap probe the hot-swap watcher polls."""
        entry = self.models().get(str(model_id))
        return None if entry is None else int(entry["version"])

    # -- publish / resolve ---------------------------------------------

    def publish(self, model_id: str, warmstart: str,
                model_dir: Optional[str] = None,
                meta: Optional[Dict] = None) -> Dict:
        """Copy `warmstart` into the blob store and point `model_id`'s
        manifest entry at it; returns the new entry. When `model_dir`
        is given, the artifact's embedded model digest must match the
        directory's `__model__` program — mismatch raises
        RegistryError (the artifact was baked from a different
        program). Decode warmstarts (no model_dir) bind through the
        artifact's own digest, which the adopting engine re-checks."""
        from .engine import Engine

        model_id = str(model_id)
        if not os.path.exists(warmstart):
            raise RegistryError(f"no warmstart artifact at {warmstart}")
        art_digest = _artifact_model_digest(warmstart)
        dir_digest = Engine._digest_model_file(model_dir)
        if model_dir is not None:
            if dir_digest is None:
                raise RegistryError(
                    f"model_dir {model_dir} has no readable __model__ "
                    "program to digest")
            if art_digest != dir_digest:
                raise RegistryError(
                    f"digest mismatch publishing {model_id!r}: artifact "
                    f"{warmstart} was baked against model_digest "
                    f"{art_digest} but {model_dir}/__model__ hashes to "
                    f"{dir_digest} — rebake the artifact from this "
                    "program")
        blob_digest = _sha256_file(warmstart)
        blob_path = os.path.join(self.root, "blobs", blob_digest)
        with self._lock:
            if not os.path.exists(blob_path):
                # stage + rename: a concurrent reader must never open a
                # half-copied blob under its final (content) name
                tmp = blob_path + ".staging"
                shutil.copyfile(warmstart, tmp)
                os.replace(tmp, blob_path)
            man = self._read_manifest()
            prev = man.get(model_id)
            entry = {
                "model_id": model_id,
                "version": (int(prev["version"]) + 1) if prev else 1,
                "digest": blob_digest,
                "model_digest": art_digest,
                "model_dir": model_dir,
                "path": blob_path,
                "published_at": time.time(),
                "meta": dict(meta or {}),
            }
            man[model_id] = entry
            from ..resilience.atomic import json_dump

            json_dump(man, self._manifest_path(), indent=2,
                      sort_keys=True)
        PUBLISHES.inc(model=model_id)
        MODEL_VERSION.set(entry["version"], model=model_id)
        _events.emit("registry", action="publish", model=model_id,
                     version=entry["version"], digest=blob_digest[:16],
                     model_digest=(art_digest or "")[:16])
        return entry

    def resolve(self, model_id: str) -> Dict:
        """The latest entry for `model_id` with its blob verified
        against the recorded content digest. RegistryError on an
        unknown model or a blob whose bytes no longer hash to the
        manifest's digest (torn copy, tampering, pruned store)."""
        entry = self.models().get(str(model_id))
        if entry is None:
            raise RegistryError(
                f"model {model_id!r} is not in the registry "
                f"({self._manifest_path()})")
        path = entry.get("path") or ""
        if not os.path.exists(path):
            raise RegistryError(
                f"registry blob missing for {model_id!r}: {path}")
        actual = _sha256_file(path)
        if actual != entry.get("digest"):
            raise RegistryError(
                f"registry blob for {model_id!r} fails its digest "
                f"check (manifest {entry.get('digest')}, actual "
                f"{actual}) — refusing to adopt a corrupt artifact")
        return dict(entry)
