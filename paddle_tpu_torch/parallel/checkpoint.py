"""TrainState checkpoints in torch.

Counterpart of the JAX package's `parallel/checkpoint.py`, whose payload
is an orbax tree. Here a checkpoint is a directory holding
`state.pt`, one `torch.save` of

    {"params": {name: tensor}, "opt_state": optimizer.state_dict(),
     "step": int, "loss_scale": dict or None}

written through `resilience/atomic.py` (a temp file renamed onto the
name, so a process killed mid-save leaves no truncated payload) and
read back with `torch.load(weights_only=True)`, and `_DTYPES.json`, the
JAX package's leaf-dtype manifest: restore compares it against the
template, so a checkpoint written under one precision policy never
restores silently into another width.

Restore copies into the template's own tensors, in place: its
`opt_state` is a `torch.optim.Optimizer` holding references to those
parameter tensors, so rebinding them would leave the optimizer stepping
stale ones. The restored state lands on the template's device, whatever
device wrote it.

Not ported: `_MESH.json` and `reshard_train_state`, the cross-world-size
reshard of an elastic resize. The port trains on one device (ROADMAP
items 20c and 20e); `ReshardError` here refuses leaf shapes that differ.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from .train import TrainState

__all__ = ["save_train_state", "restore_train_state", "latest_step_dir",
           "PrecisionMismatchError", "ReshardError", "DTYPES_FILE",
           "PAYLOAD_FILE"]

DTYPES_FILE = "_DTYPES.json"
PAYLOAD_FILE = "state.pt"


class PrecisionMismatchError(ValueError):
    """Checkpoint leaf dtypes disagree with the restore template's —
    e.g. a bf16-policy checkpoint restored into an f32-policy run.
    Re-restore with cast_dtypes=True to convert explicitly, or rebuild
    the template under the checkpoint's policy."""


class ReshardError(ValueError):
    """Checkpoint leaf shapes disagree with the restore template's (a
    different model or layer width): the checkpoint cannot be laid out
    onto the template."""


def _leaves(payload) -> Dict[str, torch.Tensor]:
    """{key: tensor} of the payload's params and optimizer state, keyed
    `params/<name>` and `opt_state/<param index>/<state name>`."""
    out = {f"params/{k}": v for k, v in payload["params"].items()}
    for idx, st in payload["opt_state"]["state"].items():
        for name, v in st.items():
            if isinstance(v, torch.Tensor):
                out[f"opt_state/{idx}/{name}"] = v
    return out


def _dtype_manifest(payload) -> Dict[str, str]:
    out = {k: str(v.dtype).replace("torch.", "")
           for k, v in _leaves(payload).items()}
    if payload.get("loss_scale") is not None:
        # loss-scale presence travels in the manifest, as the JAX
        # package's `['loss_scale']...` keys do
        out.update({f"loss_scale/{k}": type(v).__name__
                    for k, v in payload["loss_scale"].items()})
    return out


def _payload(state: TrainState) -> Dict:
    return {"params": {k: v.detach() for k, v in state.params.items()},
            "opt_state": state.opt_state.state_dict(),
            "step": int(state.step),
            "loss_scale": None if state.loss_scale is None
            else dict(state.loss_scale)}


def save_train_state(path: str, state: TrainState, force: bool = False):
    """Write {params, opt_state, step, loss_scale} to the directory
    `path`, plus the leaf-dtype manifest (_DTYPES.json) restore checks.

    force=False refuses to overwrite an existing checkpoint, as the JAX
    package does: periodic savers write step-stamped dirs
    (`root/step_N`, see latest_step_dir) and prune old ones only after
    the new save returns."""
    from ..observability import events as _events
    from ..resilience import atomic

    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(
            f"checkpoint directory {path} exists; pass force=True to "
            f"overwrite it")
    payload = _payload(state)
    os.makedirs(path, exist_ok=True)
    with atomic.atomic_open(os.path.join(path, PAYLOAD_FILE), "wb") as f:
        torch.save(payload, f)
    atomic.json_dump(_dtype_manifest(payload),
                     os.path.join(path, DTYPES_FILE))
    _events.emit("checkpoint", site="save_train_state", dir=path,
                 step=int(state.step))


def restore_train_state(path: str, template: TrainState,
                        cast_dtypes: bool = False) -> TrainState:
    """Restore the checkpoint at `path` INTO `template` (a freshly built
    `init_state(params)` result, or the live state being rolled back)
    and return it: each param is `copy_`'d in place, the optimizer
    loads its state dict (torch moves it to the params' device and
    casts floating state to their dtype), and step and loss_scale are
    set. Nothing is written into the template until the whole payload
    has been read and checked, so a corrupt checkpoint leaves it as it
    was.

    Precision safety, as in the JAX package: when a leaf's saved dtype
    disagrees with the template's (a bf16 checkpoint into an f32
    template, or the reverse), the restore fails with
    PrecisionMismatchError listing the offenders, unless
    cast_dtypes=True, which casts to the template's dtypes. The same
    holds for STRUCTURE: dynamic loss-scaling state exists only under
    mixed policies, so a checkpoint and a template disagreeing on it is
    a cross-precision restore; under cast_dtypes=True the template
    keeps its own loss-scale state (fresh or not) and a checkpoint-side
    one is dropped. Leaf shapes or parameter names that differ raise
    ReshardError."""
    path = os.path.abspath(path)
    payload = torch.load(os.path.join(path, PAYLOAD_FILE),
                         map_location="cpu", weights_only=True)
    saved_dtypes: Optional[Dict[str, str]] = None
    manifest_path = os.path.join(path, DTYPES_FILE)
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            saved_dtypes = json.load(f)

    params = template.params
    if set(payload["params"]) != set(params):
        missing = sorted(set(params) - set(payload["params"]))
        extra = sorted(set(payload["params"]) - set(params))
        raise ReshardError(
            f"checkpoint at {path} holds other params than the template "
            f"(missing {missing[:8]}, extra {extra[:8]})")
    tmpl_payload = _payload(template)
    saved, want = _leaves(payload), _leaves(tmpl_payload)
    bad = [(k, tuple(saved[k].shape), tuple(v.shape))
           for k, v in want.items()
           if k in saved and saved[k].shape != v.shape]
    if bad:
        head = ", ".join(f"{k}: checkpoint {s} vs template {t}"
                         for k, s, t in bad[:8])
        raise ReshardError(
            f"checkpoint at {path} cannot be laid out onto this "
            f"template: {len(bad)} leaf shape mismatches ({head}"
            f"{', ...' if len(bad) > 8 else ''})")

    tmpl_has_ls = template.loss_scale is not None
    saved_has_ls = payload.get("loss_scale") is not None
    if saved_has_ls != tmpl_has_ls and not cast_dtypes:
        side = ("the checkpoint carries dynamic loss-scaling state "
                "but the restore template has none"
                if saved_has_ls else
                "the restore template expects dynamic loss-scaling "
                "state but the checkpoint has none")
        raise PrecisionMismatchError(
            f"checkpoint at {path} was written under a different "
            f"precision policy than the restore template ({side}). "
            f"Restore with cast_dtypes=True to reshard explicitly "
            f"— the template's loss-scale state is kept, a "
            f"checkpoint-side one is dropped — or rebuild the "
            f"template under the checkpoint's policy.")
    if saved_dtypes is not None:
        mismatches = [(k, saved_dtypes[k], w) for k, w in
                      _dtype_manifest(tmpl_payload).items()
                      if k in saved_dtypes and saved_dtypes[k] != w]
        if mismatches and not cast_dtypes:
            head = ", ".join(f"{k}: checkpoint {h} vs template {w}"
                             for k, h, w in mismatches[:8])
            raise PrecisionMismatchError(
                f"checkpoint at {path} was written under a different "
                f"precision than the restore template ({len(mismatches)}"
                f" leaf dtype mismatches: {head}"
                f"{', ...' if len(mismatches) > 8 else ''}). Restore "
                f"with cast_dtypes=True to convert explicitly, or "
                f"rebuild the template under the checkpoint's policy.")

    with torch.no_grad():
        for k, v in params.items():
            v.copy_(payload["params"][k])
    template.opt_state.load_state_dict(payload["opt_state"])
    template.step = int(payload["step"])
    if saved_has_ls and tmpl_has_ls:
        template.loss_scale = dict(payload["loss_scale"])
    return template


def latest_step_dir(root: str, committed_only: bool = False) -> Optional[str]:
    """Resume helper: `root/step_N` directories -> the highest-N path.

    CAUTION: with committed_only=False (the legacy default) this returns
    the highest-numbered directory even if it is a PARTIAL write left by
    a process that died mid-save. committed_only=True only counts
    directories carrying resilience.CheckpointManager's commit marker;
    for managed checkpoints prefer `CheckpointManager.restore_latest`,
    which additionally falls back past corrupt-but-committed dirs."""
    if not os.path.isdir(root):
        return None
    if committed_only:
        from ..resilience.checkpoint_manager import CheckpointManager

        return CheckpointManager(root).latest_committed_dir()
    best, best_n = None, -1
    for d in os.listdir(root):
        if d.startswith("step_") and os.path.isdir(os.path.join(root, d)):
            try:
                n = int(d.split("_", 1)[1])
            except ValueError:
                continue
            if n > best_n:
                best, best_n = os.path.join(root, d), n
    return best
