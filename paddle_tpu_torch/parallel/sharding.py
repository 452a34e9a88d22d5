# Source: paddle_tpu/parallel/sharding.py (LogicalRules, DEFAULT_RULES,
# current_rules, with_rules), copied: that module imports jax at its top.
"""Logical-axis rules: logical axis names ("batch", "seq", "heads", ...)
mapped to mesh axes.

`ops/attention.py::mha` reads `current_rules().mesh_axis("seq")` to find
the mesh axis that carries the sequence (`sp` by default). The JAX
package's `shard()`, `logical_to_mesh` and `LogicalRules.spec` build
`PartitionSpec`s for GSPMD, which the port does not have; they have no
counterpart here.

`in_manual_region()` is not a copy: the JAX package asks the abstract
mesh whether it is tracing inside a `shard_map`; the port's pipeline
(`parallel/pipeline.py`) sets a flag around its stage calls with
`manual_region()`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["LogicalRules", "DEFAULT_RULES", "current_rules", "with_rules",
           "in_manual_region", "manual_region"]


class LogicalRules:
    """Ordered mapping logical-axis-name -> mesh axis (or None)."""

    def __init__(self, rules: Union[Dict[str, Optional[str]],
                                    Sequence[Tuple[str, Optional[str]]]]):
        self._rules = dict(rules)

    def mesh_axis(self, logical: Optional[str]) -> Optional[str]:
        if logical is None:
            return None
        return self._rules.get(logical)

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
