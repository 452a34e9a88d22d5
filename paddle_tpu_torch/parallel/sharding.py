# Source: paddle_tpu/parallel/sharding.py (LogicalRules, DEFAULT_RULES,
# current_rules, with_rules, logical_to_mesh, shard_params_spec,
# named_sharding_tree), copied: that module imports jax at its top.
"""Logical-axis rules: logical axis names ("batch", "seq", "heads", ...)
mapped to mesh axes.

`ops/attention.py::mha` reads `current_rules().mesh_axis("seq")` to find
the mesh axis that carries the sequence (`sp` by default), and the
models' Megatron helpers (`models/common.py`) the axes that carry
"heads", "mlp" and "vocab" (`tp`). `LogicalRules.spec`,
`logical_to_mesh` and `shard_params_spec` build `PartitionSpec`s, here
a tuple of the port's own: `parallel/train.py` reads them to check the
tp split of every param and to choose each ZeRO-1 moment's slice
axis. `NamedSharding` pairs a spec with the port's `Mesh`.

`check_param_spec(name, axes, rules)` refuses a param whose spec maps
one mesh axis onto two dims, as `jax.sharding.NamedSharding` refuses
such a PartitionSpec (`DuplicateSpecError`) whatever the axis's size:
`parallel/train.py::make_train_step` checks every param with it, and
the Megatron helpers each param they split.

`shard(x, axes)` checks that each named dim divides its mesh axis and
returns `x` itself: the in-process ring holds whole tensors, and the
ops split them where they run (the JAX package's constraint asks GSPMD
to lay `x` out so).

`in_manual_region()` is not a copy: the JAX package asks the abstract
mesh whether it is tracing inside a `shard_map`; the port's pipeline
(`parallel/pipeline.py`) sets a flag around its stage calls with
`manual_region()`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["LogicalRules", "DEFAULT_RULES", "NO_SHARD", "PartitionSpec",
           "NamedSharding", "current_rules", "with_rules", "axis_ring",
           "logical_to_mesh", "shard", "shard_params_spec",
           "check_param_spec",
           "named_sharding_tree", "in_manual_region", "manual_region"]

# Logical axis marker for "never shard this axis".
NO_SHARD = None

LogicalAxes = Tuple[Optional[str], ...]


class PartitionSpec(tuple):
    """The mesh axis (or None) of each dim of a tensor, as
    `jax.sharding.PartitionSpec`: `PartitionSpec("dp", None)`."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A PartitionSpec over a mesh (`parallel/mesh.py::Mesh`)."""

    mesh: Any
    spec: PartitionSpec


class LogicalRules:
    """Ordered mapping logical-axis-name -> mesh axis (or None)."""

    def __init__(self, rules: Union[Dict[str, Optional[str]],
                                    Sequence[Tuple[str, Optional[str]]]]):
        self._rules = dict(rules)

    def mesh_axis(self, logical: Optional[str]) -> Optional[str]:
        if logical is None:
            return None
        return self._rules.get(logical)

    def spec(self, axes: Sequence[Optional[str]]) -> PartitionSpec:
        return PartitionSpec(*(self.mesh_axis(a) for a in axes))

    def updated(self, **kw) -> "LogicalRules":
        d = dict(self._rules)
        d.update(kw)
        return LogicalRules(d)

    def __repr__(self):
        return f"LogicalRules({self._rules})"


# The default rule table used by models/: megatron-style TP + batch DP + SP.
DEFAULT_RULES = LogicalRules({
    "batch": "dp",
    "seq": "sp",          # sequence/context parallelism
    "embed": None,        # hidden dim of activations stays replicated-ish
    "heads": "tp",
    "kv": None,
    "mlp": "tp",
    "vocab": "tp",
    "expert": "ep",
    "stage": "pp",
    "conv_out": None,
})

_rules_stack: List[LogicalRules] = []


def current_rules() -> LogicalRules:
    return _rules_stack[-1] if _rules_stack else DEFAULT_RULES


@contextlib.contextmanager
def with_rules(rules: LogicalRules):
    _rules_stack.append(rules)
    try:
        yield rules
    finally:
        _rules_stack.pop()


def axis_ring(logical: Optional[str]):
    """The ring of the mesh axis that the current rules map `logical`
    to, or None when there is no mesh, no rule, or the axis is 1."""
    from .mesh import current_mesh

    m = current_mesh()
    ax = current_rules().mesh_axis(logical)
    if m is None or ax is None or m.shape.get(ax, 1) == 1:
        return None
    return m.rings[ax]


def logical_to_mesh(axes: Sequence[Optional[str]],
                    rules: Optional[LogicalRules] = None) -> PartitionSpec:
    return (rules or current_rules()).spec(axes)


def shard(x, axes: Sequence[Optional[str]],
          rules: Optional[LogicalRules] = None):
    """Check `x` against its logical axes on the current mesh and return
    it unchanged: each dim whose mesh axis is larger than 1 must divide
    by it (ValueError otherwise). The in-process ring holds whole
    tensors and the ops split them, so nothing is laid out here. No-op
    outside a mesh_guard and inside a manual region, as the JAX
    package's."""
    from .mesh import current_mesh

    mesh = current_mesh()
    if mesh is None or in_manual_region():
        return x
    for dim, (name, ax) in enumerate(zip(axes, logical_to_mesh(axes,
                                                               rules))):
        n = mesh.shape.get(ax, 1) if ax else 1
        if n > 1 and x.shape[dim] % n:
            raise ValueError(
                f"dim {dim} ({name!r}) of size {x.shape[dim]} does not "
                f"split over mesh axis {ax!r} of {n}")
    return x


def shard_params_spec(param_axes: Dict[str, LogicalAxes],
                      rules: Optional[LogicalRules] = None
                      ) -> Dict[str, PartitionSpec]:
    """Map {param name: logical axes} -> {param name: PartitionSpec}."""
    rules = rules or current_rules()
    return {k: rules.spec(v) for k, v in param_axes.items()}


def check_param_spec(name: str, axes: Sequence[Optional[str]],
                     rules: Optional[LogicalRules] = None) -> PartitionSpec:
    """The spec of param `name` (logical `axes`) under `rules`; a spec
    that names one mesh axis for two dims raises ValueError, naming the
    param, its logical axes and the mesh axis."""
    spec = logical_to_mesh(axes, rules)
    named = [a for entry in spec if entry is not None
             for a in (entry if isinstance(entry, tuple) else (entry,))]
    for a in named:
        if named.count(a) > 1:
            raise ValueError(
                f"param {name!r} with logical axes {tuple(axes)} maps mesh "
                f"axis {a!r} onto {named.count(a)} dims ({spec!r}); a "
                f"mesh axis splits at most one dim of a tensor: map all "
                f"but one of those logical axes to None")
    return spec


def named_sharding_tree(mesh, spec_tree):
    """PartitionSpec tree (dicts, lists, tuples of specs) ->
    NamedSharding tree of the same structure."""
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named_sharding_tree(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named_sharding_tree(mesh, v)
                               for v in spec_tree)
    return spec_tree


_manual_depth = [0]


def in_manual_region() -> bool:
    """True inside a manual region (the `pp` pipeline's stage calls).
    There GPT's blocks call `mha` instead of ring attention over `sp`
    and `mha` takes no sp ring, as the JAX package, which cannot nest
    manual subregions, leaves the sequence to GSPMD's constraints."""
    return _manual_depth[0] > 0


@contextlib.contextmanager
def manual_region():
    _manual_depth[0] += 1
    try:
        yield
    finally:
        _manual_depth[0] -= 1
