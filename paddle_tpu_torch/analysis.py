# Copied from the JAX package: the boot-validation subset of
# paddle_tpu/analysis/__init__.py (stdlib only). Each definition below is
# that file's, unchanged; keep them in step with it. The rest of that
# module (the program IR passes) is not ported.
"""The analysis Finding shape, for the decode engine's boot validation.

`Finding` is one structured result (severity, pass name, message, the
offending variable), `AnalysisError` the error raised at
PADDLE_TPU_VALIDATE=2 when a boot walk found an error, and
`validate_level()` reads that variable (0 off, 1 warn, 2 error).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Finding", "AnalysisError", "findings_to_json", "validate_level",
           "ERROR", "WARNING", "INFO", "ENV_VAR"]

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
