"""Model serialization: the JAX package's `io.py` on the port's scope
(reference: python/paddle/fluid/io.py — save_vars :135, save_params
:268, save_persistables :501, load_persistables :769,
save_inference_model :979, load_inference_model :1171).

The same formats: one `.npy` per var (`/` in a name mangled to `%2F`),
or one `.npz` when `filename` is given; a program as the `__model__`
JSON of `ProgramDesc.to_dict()` with its feed and fetch names. So a
model dir saved by either package loads in the other. Every writer goes
through `resilience.atomic` (a temp file, then `os.replace`).

The port's scope holds tensors: a saved var is its host copy
(`to_numpy`, which reads bfloat16 as float32), and a loaded var becomes
a tensor on the executor's device (numpy when no executor is given), so
a loaded model's weights cross to the card once, at load.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence

import numpy as np
import torch

from .core.async_exec import to_numpy
from .core.executor import global_scope
from .core.framework import Parameter, Program, Variable, default_main_program
from .core.ir import OpDesc, ProgramDesc
from .observability import events as _events
from .resilience import atomic as _atomic

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "save_train_model", "load_inference_model", "save", "load",
           "get_program_persistable_vars", "var_filename"]


def _is_persistable(var: Variable) -> bool:
    return var.persistable and var.desc.type not in ("reader", "raw")


def _is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter) or var.desc.is_parameter


def get_program_persistable_vars(program: Program) -> List[Variable]:
    return [v for v in program.list_vars() if _is_persistable(v)]


def var_filename(name: str) -> str:
    """Filesystem-safe var filename stem (the save_vars mangling; shared
    with the slim export path)."""
    return name.replace("/", "%2F")


def _to_scope(value: np.ndarray, executor):
    """A loaded array as the scope keeps it: a tensor on the executor's
    device, or the array itself without an executor."""
    if executor is None:
        return value
    return torch.as_tensor(value, device=executor.device)


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """reference: io.py:135."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    data = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is not None:
            data[v.name] = to_numpy(val)
    if filename is None:
        for name, arr in data.items():
            _atomic.np_save(os.path.join(dirname, var_filename(name)), arr)
    else:
        _atomic.np_savez(os.path.join(dirname, filename), **data)
    _events.emit("checkpoint", site="save_vars", dir=str(dirname),
                 vars=len(data))


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """reference: io.py load_vars."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    if filename is not None:
        data = np.load(os.path.join(dirname, filename), allow_pickle=False)
        for v in vars:
            if v.name in data:
                scope.set_var(v.name, _to_scope(data[v.name], executor))
        return
    # weight-only-quantized models store <w>@INT8/<w>@SCALE pairs
    from .slim.quantization import load_quantized_vars

    quantized = load_quantized_vars(dirname, names=[v.name for v in vars])
    for v in vars:
        if v.name in quantized:
            scope.set_var(v.name, _to_scope(quantized[v.name], executor))
            continue
        path = os.path.join(dirname, var_filename(v.name) + ".npy")
        if os.path.exists(path):
            scope.set_var(v.name, _to_scope(np.load(path), executor))


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


# ---------------------------------------------------------------------------
# Program pruning (reference: framework/prune.cc + Program._prune)
# ---------------------------------------------------------------------------


def _prune_for_inference(program: Program, feed_names: Sequence[str],
                         fetch_names: Sequence[str]) -> Program:
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = set(fetch_names)
    keep: List[OpDesc] = []
    for op in reversed(block.desc.ops):
        if any(o in needed for o in op.output_names()):
            keep.append(op)
            needed.update(n for n in op.input_names())
    keep.reverse()
    # drop backward/optimizer-only ops and dead code
    block.desc.ops = keep
    used = set(feed_names) | set(fetch_names)
    for op in keep:
        used.update(op.input_names())
        used.update(op.output_names())
    block.desc.vars = {k: v for k, v in block.desc.vars.items() if k in used}
    pruned._rebuild_from_desc()
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """reference: io.py:979 — prune to the inference subgraph + save params."""
    main_program = main_program or default_main_program()
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in target_vars]
    pruned = _prune_for_inference(main_program, feeded_var_names, fetch_names)
    pruned._attrs["feed_names"] = list(feeded_var_names)
    pruned._attrs["fetch_names"] = fetch_names
    os.makedirs(dirname, exist_ok=True)
    model_path = os.path.join(dirname, model_filename or "__model__")
    payload = {"program": pruned.desc.to_dict(),
               "feed_names": list(feeded_var_names),
               "fetch_names": fetch_names}
    _atomic.json_dump(payload, model_path)
    if not program_only:
        save_persistables(executor, dirname, main_program=pruned,
                          filename=params_filename)
    return fetch_names


def save_train_model(dirname, main_program, startup_program, feed_names,
                     loss_name):
    """Serialize a TRAINING program pair (main block with its grad and
    optimizer ops, the startup block, the feed names and the loss var)
    as `__train__`, the JAX package's format for its native trainer; no
    parameters are saved."""
    os.makedirs(dirname, exist_ok=True)
    payload = {"main": main_program.desc.to_dict(),
               "startup": startup_program.desc.to_dict(),
               "feed_names": list(feed_names),
               "loss_name": loss_name}
    _atomic.json_dump(payload, os.path.join(dirname, "__train__"))


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """reference: io.py:1171 → (program, feed_names, fetch_vars)."""
    model_path = os.path.join(dirname, model_filename or "__model__")
    with open(model_path) as f:
        payload = json.load(f)
    program = Program()
    program.desc = ProgramDesc.from_dict(payload["program"])
    program._rebuild_from_desc()
    program._is_test = True
    # restore the feed/fetch metadata transpilers rely on (float16, ...)
    program._attrs["feed_names"] = list(payload.get("feed_names", []))
    program._attrs["fetch_names"] = list(payload.get("fetch_names", []))
    load_persistables(executor, dirname, main_program=program,
                      filename=params_filename)
    fetch_vars = [program.global_block().var(n)
                  for n in payload["fetch_names"]]
    return program, payload["feed_names"], fetch_vars


# -- new-style single-file API (reference: io.py:1449 save / :1497 load) ----


def save(program: Program, model_path: str):
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    scope = global_scope()
    data = {}
    for v in get_program_persistable_vars(program):
        val = scope.find_var(v.name)
        if val is not None:
            data[v.name] = to_numpy(val)
    _atomic.np_savez(model_path + ".pdparams", **data)
    _atomic.write_bytes(model_path + ".pdmodel", program.to_bytes())
    _events.emit("checkpoint", site="save", dir=str(model_path),
                 vars=len(data))


def load(program: Program, model_path: str, executor=None, var_list=None):
    scope = global_scope()
    data = np.load(model_path + ".pdparams.npz"
                   if os.path.exists(model_path + ".pdparams.npz")
                   else model_path + ".pdparams")
    names = ([v.name for v in var_list] if var_list
             else [v.name for v in get_program_persistable_vars(program)])
    for n in names:
        if n in data:
            scope.set_var(n, _to_scope(data[n], executor))
