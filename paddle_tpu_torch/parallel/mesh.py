"""Device mesh: named axis sizes and, for each axis larger than 1, the
ring that carries it.

Counterpart of the JAX package's `parallel/mesh.py` (`AXIS_ORDER`,
`MeshConfig`, `make_mesh`, `current_mesh`, `mesh_guard`). The JAX
package hands a `jax.sharding.Mesh` to GSPMD and `shard_map`; the port
has neither, so a mesh here is the axis sizes plus the rings
(`parallel/ring.py`) over which the port's collectives run by hand.

Two kinds of ring, chosen by how the mesh is made:

- **Process ring.** With `torch.distributed` initialised and no
  `devices`, the mesh spans the world, one rank per process; the `sp`
  ring is the group of ranks along `sp`. Its device is this process's
  own: `cuda` (the current device) under NCCL, `cpu` under gloo. Only
  `sp` may be larger than 1 there: `pp` and `ep` over processes raise
  (ROADMAP items 20a and 20e), and so do `dp` and `tp` (item 20c).
- **In-process rings.** `devices` given as one device repeated N times
  (`[torch.device("cuda", 0)] * 4`): N virtual ranks in one process on
  that device, with an `InProcessRing` for each of `pp`, `ep` and `sp`
  that is larger than 1 (`MeshConfig(pp=2, ep=2)` on four: a pp ring
  of 2 and an ep ring of 2). They are made only when asked for like
  this. With `devices=None` and no process group the mesh has one
  device, so `make_mesh(MeshConfig(sp=4))` raises, as `resolve` does.
  `dp` and `tp` larger than 1 raise `NotImplementedError` (item 20c,
  and with it `make_hybrid_mesh`, `resize_mesh`, `auto_mesh` and
  `get_mesh`).

`pp` is carried by `parallel/pipeline.py::pipeline_apply` and `ep` by
GPT's expert split (`models/gpt.py::_moe_mlp`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .ring import InProcessRing, ProcessRing, Ring

__all__ = ["AXIS_ORDER", "MeshConfig", "Mesh", "make_mesh", "current_mesh",
           "mesh_guard", "refuse_process_ring"]

AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")  # outer → inner, as the JAX package


@dataclasses.dataclass
class MeshConfig:
    """Named axis sizes; -1 on one axis = absorb remaining devices."""

    dp: int = -1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        fixed = [a for a, s in sizes.items() if s != -1]
        free = [a for a, s in sizes.items() if s == -1]
        prod = math.prod(sizes[a] for a in fixed)
        if free:
            if len(free) > 1:
                raise ValueError("at most one mesh axis may be -1")
            if n_devices % prod:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[free[0]] = n_devices // prod
        elif prod != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {prod} devices, have {n_devices}")
        return sizes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`shape`: every axis of AXIS_ORDER with its size. `devices`: the
    devices this process drives, one per rank it holds (S repeated for
    an in-process ring, its own one in a process mesh). `rings`: the
    ring of each axis larger than 1."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]
    rings: Dict[str, Ring]


# the axes each kind of mesh may make larger than 1
IN_PROCESS_AXES = ("pp", "ep", "sp")
PROCESS_AXES = ("sp",)
_ITEM = {"dp": "20c", "tp": "20c", "pp": "20a and 20e",
         "ep": "20a and 20e"}


def _refuse_axes(sizes: Dict[str, int], allowed: Sequence[str],
                 where: str) -> None:
    wide = [a for a in AXIS_ORDER if a not in allowed and sizes[a] > 1]
    if wide:
        items = sorted({_ITEM[a] for a in wide})
        raise NotImplementedError(
            f"mesh axes {wide} > 1 are not ported {where} (ROADMAP item "
            f"{', '.join(items)}); it runs the axes {list(allowed)}")


def _process_device(backend: str) -> torch.device:
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"no ring for process-group backend {backend!r}")


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None,
              **axis_sizes) -> Mesh:
    """A Mesh with the standard axis order. `make_mesh(MeshConfig(sp=4),
    devices=[torch.device("cuda", 0)] * 4)` is an in-process sp ring of
    4 virtual ranks (`MeshConfig(pp=2, ep=2)` there: a pp ring and an ep
    ring of 2 each); with `devices=None` under an initialised
    `torch.distributed` the mesh is the world's process ring."""
    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    import torch.distributed as dist

    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        sizes = config.resolve(len(devs))
        _refuse_axes(sizes, IN_PROCESS_AXES, "in-process")
        if len(set(devs)) > 1:
            raise ValueError(
                f"an in-process ring runs its ranks on one device, got "
                f"{sorted(map(str, set(devs)))}; one rank per device is "
                f"the process ring (torch.distributed)")
        rings = {a: InProcessRing(sizes[a]) for a in IN_PROCESS_AXES
                 if sizes[a] > 1}
        return Mesh(sizes, devs, rings)
    if dist.is_available() and dist.is_initialized():
        sizes = config.resolve(dist.get_world_size())
        _refuse_axes(sizes, PROCESS_AXES, "over processes")
        dev = _process_device(dist.get_backend())
        # with every other axis 1, the ranks along sp are the world
        rings = {"sp": ProcessRing(None, sizes["sp"], dist.get_rank())} \
            if sizes["sp"] > 1 else {}
        return Mesh(sizes, (dev,), rings)
    sizes = config.resolve(1)   # one process, one device
    from .. import resolve_device

    return Mesh(sizes, (resolve_device(None),), {})


_mesh_stack: List[Mesh] = []


def current_mesh() -> Optional[Mesh]:
    return _mesh_stack[-1] if _mesh_stack else None


@contextlib.contextmanager
def mesh_guard(mesh: Mesh):
    _mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _mesh_stack.pop()


def refuse_process_ring(what: str) -> None:
    """Raise when the current mesh has a process ring. A model's forward
    there gets this rank's shard of the sequence and would run it as a
    whole one: positions restart at 0 on every rank, and masked
    attention stays within the shard. The JAX package stays exact under
    GSPMD; the port waits for ROADMAP item 20b (model-level sp over
    processes). The in-process ring holds whole tensors and passes."""
    m = current_mesh()
    if m is not None and any(isinstance(r, ProcessRing)
                             for r in m.rings.values()):
        raise NotImplementedError(
            f"{what} under a process ring would treat this rank's shard as "
            f"the whole sequence (positions from 0 on every rank); model-"
            f"level sp over processes is ROADMAP item 20b")
