"""Device mesh: named axis sizes and, for each axis larger than 1, the
ring that carries it.

Counterpart of the JAX package's `parallel/mesh.py` (`AXIS_ORDER`,
`MeshConfig`, `make_mesh`, `make_hybrid_mesh`, `resize_mesh`,
`auto_mesh`, `current_mesh`, `get_mesh`, `mesh_guard`). The JAX package
hands a `jax.sharding.Mesh` to GSPMD and `shard_map`; the port has
neither, so a mesh here is the axis sizes plus the rings
(`core/ring.py`) over which the port's collectives run by hand.

Two kinds of ring, chosen by how the mesh is made:

- **Process ring.** With `torch.distributed` initialised and no
  `devices`, the mesh spans the world, one rank per process; the `sp`
  ring is the group of ranks along `sp`. Its device is this process's
  own: `cuda` (the current device) under NCCL, `cpu` under gloo. Only
  `sp` may be larger than 1 there: `pp` and `ep` over processes raise
  (ROADMAP items 20a and 20e), and so do `dp` and `tp` (item 20a, the
  process ring that lifts their reductions).
- **In-process rings.** `devices` given as one device repeated N times
  (`[torch.device("cuda", 0)] * 4`): N virtual ranks in one process on
  that device, with an `InProcessRing` for each axis larger than 1
  (`MeshConfig(dp=2, tp=2)` on four: a dp ring of 2 and a tp ring of
  2; `MeshConfig(pp=2, tp=2, dp=2)` on eight). They are made only when
  asked for like this. With `devices=None` and no process group the
  mesh has one device, so `make_mesh(MeshConfig(sp=4))` raises, as
  `resolve` does.

`pp` is carried by `parallel/pipeline.py::pipeline_apply`, `ep` by
GPT's expert split (`models/gpt.py::_moe_mlp`), `sp` by ring attention,
`dp` and `tp` by the ops that split and join inside themselves
(`ops/attention.py`'s per-rank launches, `models/common.py`'s Megatron
helpers, ResNet's BatchNorm statistics, the losses' global means; see
`parallel/train.py`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.ring import InProcessRing, ProcessRing, Ring

__all__ = ["AXIS_ORDER", "MeshConfig", "Mesh", "make_mesh",
           "make_hybrid_mesh", "resize_mesh", "auto_mesh", "current_mesh",
           "get_mesh", "mesh_guard", "refuse_process_ring",
           "refuse_dp_tp"]

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


# the axes a process mesh may make larger than 1 (an in-process mesh
# takes them all)
PROCESS_AXES = ("sp",)
_ITEM = {"dp": "20a", "tp": "20a", "pp": "20a and 20e",
         "ep": "20a and 20e"}


def _refuse_process_axes(sizes: Dict[str, int]) -> None:
    wide = [a for a in AXIS_ORDER if a not in PROCESS_AXES and sizes[a] > 1]
    if wide:
        items = sorted({_ITEM[a] for a in wide})
        raise NotImplementedError(
            f"mesh axes {wide} > 1 are not ported over processes (ROADMAP "
            f"item {', '.join(items)}); it runs the axes {list(PROCESS_AXES)}")


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
    4 virtual ranks (`MeshConfig(dp=2, tp=2)` there: a dp ring and a tp
    ring of 2 each); with `devices=None` under an initialised
    `torch.distributed` the mesh is the world's process ring."""
    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    import torch.distributed as dist

    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        sizes = config.resolve(len(devs))
        if len(set(devs)) > 1:
            raise ValueError(
                f"an in-process ring runs its ranks on one device, got "
                f"{sorted(map(str, set(devs)))}; one rank per device is "
                f"the process ring (torch.distributed)")
        rings = {a: InProcessRing(sizes[a]) for a in AXIS_ORDER
                 if sizes[a] > 1}
        return Mesh(sizes, devs, rings)
    if dist.is_available() and dist.is_initialized():
        sizes = config.resolve(dist.get_world_size())
        _refuse_process_axes(sizes)
        dev = _process_device(dist.get_backend())
        # with every other axis 1, the ranks along sp are the world
        rings = {"sp": ProcessRing(None, sizes["sp"], dist.get_rank())} \
            if sizes["sp"] > 1 else {}
        return Mesh(sizes, (dev,), rings)
    sizes = config.resolve(1)   # one process, one device
    from .. import resolve_device

    return Mesh(sizes, (resolve_device(None),), {})


def _one_process() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_world_size() == 1


def make_hybrid_mesh(config: Optional[MeshConfig] = None,
                     devices: Optional[Sequence] = None,
                     **axis_sizes) -> Mesh:
    """The multi-host mesh of the JAX package, whose outer axes (pp, dp)
    ride the slow network between hosts. With one process it is
    `make_mesh(config, devices)`, as there; across processes the port
    has no such mesh yet (ROADMAP item 20a, the process ring over
    NCCL)."""
    config = config or (MeshConfig(**axis_sizes) if axis_sizes
                        else MeshConfig())
    if _one_process():
        return make_mesh(config, devices)
    raise NotImplementedError(
        "a hybrid mesh across processes is not ported (ROADMAP item 20a, "
        "the process ring over NCCL)")


def resize_mesh(mesh: Mesh, n_devices: int,
                devices: Optional[Sequence] = None,
                absorb: str = "dp") -> Mesh:
    """Re-form `mesh` for a new world size, as the JAX package's: every
    axis keeps its size except `absorb` (default 'dp'), which grows or
    shrinks to cover `n_devices`. Raises ValueError when the fixed axes
    cannot divide the new world (a tp=2 mesh cannot re-form on 3
    devices). `devices` defaults to the mesh's device repeated, so an
    in-process mesh re-forms as virtual ranks on its device; a process
    mesh re-forms only by a new process group (ROADMAP item 20e)."""
    if n_devices < 1:
        raise ValueError(f"cannot resize mesh to {n_devices} devices")
    if absorb not in AXIS_ORDER:
        raise ValueError(f"absorb axis {absorb!r} not in {AXIS_ORDER}")
    if devices is None:
        if len(mesh.devices) != math.prod(mesh.shape.values()):
            raise NotImplementedError(
                "a process mesh re-forms only with a new process group "
                "(ROADMAP item 20e, the elastic driver)")
        devices = [mesh.devices[0]] * n_devices
    devices = list(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"resize to {n_devices} devices but only {len(devices)} "
            f"are available")
    config = MeshConfig(**{a: (-1 if a == absorb else mesh.shape[a])
                           for a in AXIS_ORDER})
    return make_mesh(config, devices=devices[:n_devices])


def auto_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device=None) -> Mesh:
    """A data-parallel mesh with an optional inner tp axis, the JAX
    package's default: `n_devices` virtual ranks on `device` (default
    cuda), dp = n_devices / model_parallel. With `n_devices` None it is
    one rank, or the world under an initialised process group."""
    config = MeshConfig(dp=-1, tp=model_parallel)
    if n_devices is None and not _one_process():
        return make_mesh(config)
    from .. import resolve_device

    return make_mesh(config,
                     devices=[resolve_device(device)] * (n_devices or 1))


_mesh_stack: List[Mesh] = []


def current_mesh() -> Optional[Mesh]:
    return _mesh_stack[-1] if _mesh_stack else None


def get_mesh() -> Mesh:
    """The current mesh; with none, `auto_mesh()`, which then stays
    current, as the JAX package's."""
    m = current_mesh()
    if m is None:
        m = auto_mesh()
        _mesh_stack.append(m)
    return m


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


def refuse_dp_tp(what: str, why: str) -> None:
    """Raise when the current mesh has dp or tp larger than 1: `what`
    has no split over them (`why` says why), and computing it whole
    would pass for a data- or tensor-parallel run."""
    m = current_mesh()
    if m is None:
        return
    wide = [a for a in ("dp", "tp") if m.shape.get(a, 1) > 1]
    if wide:
        raise NotImplementedError(
            f"{what} has no split over mesh axes {wide} ({why})")
