# Copied from the JAX package: paddle_tpu/analysis/__init__.py (stdlib
# only), with declared changes: the lockcheck import at the end is left
# out (not ported), and one docstring line reworded. Keep the rest in
# step with the source.
"""Program static analysis: validate ProgramDescs before they trace.

The reference front-loads correctness with a graph-IR pass pipeline
(~60 passes over ir::Graph) and an inference Analyzer that validates and
rewrites every program before the executor sees it (AnalysisPredictor →
ir_graph_build → ir_analysis). paddle_tpu lowers whole blocks into one
jit trace, so a malformed program historically died deep inside jax
tracing with an opaque error. This package is the analogous front-load:
a registry of `AnalysisPass`es over the dataclass IR (core/ir.py) that
turn those late failures into structured, op/var-addressed `Finding`s
BEFORE anything is traced.

Wiring (ANALYSIS.md has the full story):

- `PADDLE_TPU_VALIDATE=0|1|2` (off / warn / error) gates pre-run
  validation in `Executor.run`/`run_chained`/`run_stream` and
  `CompiledProgram`. Results are cached per program version + run
  signature, so a steady-state training loop pays for ONE walk and
  every later step is a dict lookup (`walk_count()` is the test hook
  proving that).
- The serving `Engine` validates the loaded program once at boot,
  honoring the same env for raise semantics.
- `tools/analyze.py` runs the suite offline over a saved model dir or
  an in-repo model function, with table/JSON output and a DOT render.

Every run lands in `paddle_tpu_analysis_findings_total{pass,severity}`
/ `paddle_tpu_analysis_runs_total` and emits an `analysis` event, so a
fleet's validation story is observable like every other subsystem.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..core import precision as _precision
from ..core.ir import ProgramDesc
from ..observability import telemetry as _telemetry

__all__ = [
    "Finding", "AnalysisPass", "PassContext", "AnalysisError",
    "register_pass", "pass_names", "get_pass", "default_passes",
    "run_passes", "validate_program", "maybe_validate", "validate_level",
    "walk_count", "findings_to_json", "ERROR", "WARNING", "INFO",
    "ENV_VAR",
]

ENV_VAR = "PADDLE_TPU_VALIDATE"

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITIES = (ERROR, WARNING, INFO)


@dataclass(frozen=True)
class Finding:
    """One structured analysis result, addressed to the op/var it is
    about (op_idx is the index within its block; var the offending
    variable name) — the actionable replacement for a KeyError three
    layers into jax tracing."""

    severity: str
    pass_name: str
    message: str
    block_idx: int = 0
    op_idx: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "severity": self.severity,
            "pass": self.pass_name,
            "message": self.message,
            "block_idx": self.block_idx,
        }
        if self.op_idx is not None:
            d["op_idx"] = self.op_idx
        if self.op_type is not None:
            d["op_type"] = self.op_type
        if self.var is not None:
            d["var"] = self.var
        return d

    def where(self) -> str:
        loc = f"block {self.block_idx}"
        if self.op_idx is not None:
            loc += f" op #{self.op_idx}"
        if self.op_type is not None:
            loc += f" ({self.op_type})"
        return loc

    def __str__(self):
        v = f" var '{self.var}'" if self.var else ""
        return (f"[{self.severity}] {self.pass_name}: {self.where()}"
                f"{v}: {self.message}")


def findings_to_json(findings: Sequence[Finding]) -> List[Dict[str, Any]]:
    return [f.to_dict() for f in findings]


class AnalysisError(RuntimeError):
    """Raised at PADDLE_TPU_VALIDATE=2 when a program carries
    error-severity findings; `.findings` holds every finding from the
    walk (errors first) so callers can render all of them at once."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = list(findings)
        errors = [f for f in self.findings if f.severity == ERROR]
        lines = [f"program failed static analysis with "
                 f"{len(errors)} error(s):"]
        lines += [f"  {f}" for f in errors]
        rest = len(self.findings) - len(errors)
        if rest:
            lines.append(f"  (+{rest} non-error finding(s); run "
                         f"tools/analyze.py for the full report)")
        super().__init__("\n".join(lines))


@dataclass
class PassContext:
    """Everything a pass may consult. feed/fetch names describe the RUN
    binding (executor feed dict / fetch list) and are unioned with any
    feed/fetch ops the program itself carries; policy is the resolved
    precision policy the program would trace under."""

    program_desc: ProgramDesc
    feed_names: frozenset = frozenset()
    fetch_names: Tuple[str, ...] = ()
    policy: Optional["_precision.PrecisionPolicy"] = None
    is_test: bool = False
    # per-walk memo for the context's own derived views (persistable
    # names, program feed/fetch ops) so each is computed once per walk,
    # not once per pass
    shared: Dict[str, Any] = field(default_factory=dict)

    def persistable_names(self) -> frozenset:
        key = "_persistable"
        if key not in self.shared:
            self.shared[key] = frozenset(
                v.name for b in self.program_desc.blocks
                for v in b.vars.values() if v.persistable)
        return self.shared[key]

    def program_feeds_fetches(self) -> Tuple[List[str], List[str]]:
        key = "_prog_feed_fetch"
        if key not in self.shared:
            from ..core.lowering import collect_feed_fetch

            self.shared[key] = collect_feed_fetch(self.program_desc)
        return self.shared[key]

    def all_feed_names(self) -> frozenset:
        return self.feed_names | frozenset(self.program_feeds_fetches()[0])

    def all_fetch_names(self) -> Tuple[str, ...]:
        extra = tuple(n for n in self.program_feeds_fetches()[1]
                      if n not in self.fetch_names)
        return tuple(self.fetch_names) + extra

    def find_var_desc(self, block_idx: int, name: str):
        """Declared VarDesc for `name`, looked up from `block_idx`
        outward through parents (the executor's scoping rule)."""
        desc = self.program_desc
        idx = block_idx
        while idx >= 0:
            b = desc.block(idx)
            v = b.vars.get(name)
            if v is not None:
                return v
            idx = b.parent_idx
        return None


class AnalysisPass:
    """One validation pass over a ProgramDesc. Subclasses set `name`
    (the metrics label and CLI filter) and implement run(ctx) returning
    Findings; raising is a pass bug — the runner converts it into a
    WARNING finding against the pass itself rather than killing (or,
    at level 2, blocking) the run."""

    name = "?"

    def run(self, ctx: PassContext) -> List[Finding]:
        raise NotImplementedError


_PASSES: Dict[str, AnalysisPass] = {}
_ORDER: List[str] = []


def register_pass(cls):
    """Class decorator registering an AnalysisPass (instantiated once;
    passes must be stateless between runs). Registration order is
    execution order."""
    inst = cls()
    if cls.name in _PASSES:
        _ORDER.remove(cls.name)
    _PASSES[cls.name] = inst
    _ORDER.append(cls.name)
    return cls


def pass_names() -> List[str]:
    return list(_ORDER)


def get_pass(name: str) -> AnalysisPass:
    if name not in _PASSES:
        raise KeyError(f"unknown analysis pass {name!r}; choose from "
                       f"{_ORDER}")
    return _PASSES[name]


def default_passes() -> List[AnalysisPass]:
    return [_PASSES[n] for n in _ORDER]


# walker-invocation counter: the per-program-version cache contract
# (zero per-step overhead after the first run) is tested by counting
# full suite walks across repeated identical runs
_walks = 0


def walk_count() -> int:
    return _walks


def run_passes(
    program_desc: ProgramDesc,
    feed_names: Iterable[str] = (),
    fetch_names: Iterable[str] = (),
    policy=None,
    is_test: bool = False,
    passes: Optional[Sequence[str]] = None,
    where: str = "api",
) -> List[Finding]:
    """One full analysis walk: every (selected) pass over the program.
    Returns findings sorted errors-first. Records the run + per-pass
    finding counts in the metrics registry and emits one `analysis`
    event — validation is a fleet behavior worth observing, not just a
    local raise."""
    global _walks
    _walks += 1
    ctx = PassContext(
        program_desc=program_desc,
        feed_names=frozenset(feed_names),
        fetch_names=tuple(fetch_names),
        policy=_precision.get_policy(policy),
        is_test=is_test,
    )
    selected = (default_passes() if passes is None
                else [get_pass(n) for n in passes])
    t0 = time.perf_counter()
    findings: List[Finding] = []
    for p in selected:
        try:
            findings.extend(p.run(ctx))
        except Exception as e:
            # a buggy pass must not kill the run — and must not BLOCK
            # it either: WARNING severity keeps the crash visible in
            # findings/metrics/events without the fail-closed trap of
            # level 2 refusing a valid program because the VALIDATOR
            # broke (validate_level's contract)
            findings.append(Finding(
                severity=WARNING, pass_name=p.name,
                message=f"analysis pass crashed (finding suppressed, "
                        f"not blocking): {type(e).__name__}: {e}"))
    findings.sort(key=lambda f: (_SEVERITIES.index(f.severity),
                                 f.block_idx, f.op_idx or 0))
    n_ops = sum(len(b.ops) for b in program_desc.blocks)
    _telemetry.record_analysis(findings, n_ops=n_ops, where=where,
                               seconds=time.perf_counter() - t0)
    return findings


def validate_level() -> int:
    """PADDLE_TPU_VALIDATE parsed: 0 off (default), 1 warn, 2 error.
    Junk values mean off — validation must never be the thing that
    breaks a run by accident."""
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return 0
    try:
        return max(0, min(2, int(raw)))
    except ValueError:
        return 0


def validate_program(program_desc, feed_names=(), fetch_names=(),
                     policy=None, is_test=False, level: int = 2,
                     where: str = "api") -> List[Finding]:
    """Run the suite and apply `level` semantics: level>=2 raises
    AnalysisError on any error-severity finding, level 1 warns once,
    level 0 still returns the findings (callers wanting a report)."""
    findings = run_passes(program_desc, feed_names, fetch_names,
                          policy=policy, is_test=is_test, where=where)
    _apply_level(findings, level)
    return findings


def _apply_level(findings: List[Finding], level: int):
    errors = [f for f in findings if f.severity == ERROR]
    if errors and level >= 2:
        raise AnalysisError(findings)
    if errors and level == 1:
        warnings.warn(
            f"program failed static analysis with {len(errors)} "
            f"error(s) (PADDLE_TPU_VALIDATE=1 → run anyway): "
            + "; ".join(str(f) for f in errors[:5]),
            stacklevel=3)


# per-Program result cache: {id-keyed on the Program object itself via
# __dict__} — (version, {signature: findings}). Re-validating a hot
# training loop would pay a full IR walk per step; the cache makes every
# post-first step a dict lookup. Bounded per version; a version bump
# (any program mutation) drops everything.
_CACHE_ATTR = "_analysis_cache"
_CACHE_MAX_SIGS = 32


def maybe_validate(program, feed_names=(), fetch_names=(), policy=None,
                   where: str = "executor") -> Optional[List[Finding]]:
    """Env-gated pre-run validation for the executor hot paths: no-op
    at PADDLE_TPU_VALIDATE=0; at 1/2 the first run of a (program
    version, feeds, fetches, policy) signature walks the pass suite and
    later runs replay the cached outcome — including the raise at
    level 2, so a bad program fails every run, not just the first."""
    level = validate_level()
    if level <= 0:
        return None
    pol = _precision.get_policy(policy) if policy is not None \
        else _precision.resolve(program)
    sig = (frozenset(feed_names), tuple(fetch_names), pol.name,
           bool(getattr(program, "_is_test", False)))
    version = getattr(program, "_version", 0)
    cache = program.__dict__.get(_CACHE_ATTR)
    if cache is None or cache[0] != version:
        cache = (version, {})
        program.__dict__[_CACHE_ATTR] = cache
    findings = cache[1].get(sig)
    if findings is None:
        findings = run_passes(
            program.desc, feed_names=feed_names, fetch_names=fetch_names,
            policy=pol, is_test=bool(getattr(program, "_is_test", False)),
            where=where)
        if len(cache[1]) >= _CACHE_MAX_SIGS:
            cache[1].pop(next(iter(cache[1])))
        cache[1][sig] = findings
    _apply_level(findings, level)
    return findings


from . import passes  # noqa: E402,F401  (self-registers the suite)
# The runtime concurrency sanitizer (the JAX package's lockcheck) is
# not ported (ROADMAP item 21).
