# Copied from the JAX package: the dynamic loss-scaling, pipeline and
# analysis subsets of paddle_tpu/observability/telemetry.py (stdlib
# only). Each
# definition below is that file's, unchanged; keep them in step with
# it. The rest of that module (executor, trainer, compile and async
# telemetry) is not ported (ROADMAP item 18).
"""Dynamic loss-scaling telemetry: `paddle_tpu_amp_total{event}`, the
`paddle_tpu_amp_loss_scale` gauge, and `record_amp`, which ticks them
and logs each overflow as an `amp_overflow` event. The training loop
feeds them through `parallel.train.sync_loss_scale_metrics`.

Pipeline telemetry: `paddle_tpu_pipeline_traces_total{axis}` and the
stages, microbatches and bubble-fraction gauges of the last pipeline.
The JAX package sets all four at trace time, through
`record_pipeline_trace`. The port has no trace: `parallel/pipeline.py`
sets the gauges on every call and ticks the trace counter on each new
schedule signature, so it does not call `record_pipeline_trace`.

Analysis telemetry: `paddle_tpu_analysis_runs_total{where}`,
`paddle_tpu_analysis_findings_total{pass,severity}` and the `analysis`
event, recorded by `record_analysis` once per pass-suite walk
(`analysis.run_passes`).
"""

from __future__ import annotations

from typing import Dict, Optional

from . import events as _events
from . import metrics as _m

__all__ = ["record_amp", "record_pipeline_trace", "record_analysis"]

AMP_EVENTS = _m.counter(
    "paddle_tpu_amp_total",
    "Dynamic loss-scaling outcomes under a mixed-precision policy: "
    "overflow (nonfinite grads detected), skip (the update those grads "
    "would have applied was dropped), growth (scale grew after a clean "
    "streak). A rising overflow rate at steady state means the scale "
    "is thrashing — lower init_loss_scale or widen growth_interval",
    labelnames=("event",))
AMP_LOSS_SCALE = _m.gauge(
    "paddle_tpu_amp_loss_scale",
    "Current dynamic loss scale (last host-observed value)")


def record_amp(event: str, n: int = 1, step: Optional[int] = None,
               scale: Optional[float] = None):
    """`n` dynamic loss-scaling outcomes of kind `event`
    (overflow|growth|skip). Overflows additionally land in the JSONL
    log as `amp_overflow` events — a scale-thrash timeline is how a
    diverging mixed-precision run is diagnosed after the fact
    (tools/obsdump.py events --kind amp_overflow)."""
    if n <= 0:
        return
    AMP_EVENTS.inc(n, event=event)
    if scale is not None:
        AMP_LOSS_SCALE.set(float(scale))
    if event == "overflow":
        fields: Dict = {"count": int(n)}
        if step is not None:
            fields["step"] = int(step)
        if scale is not None:
            fields["scale"] = float(scale)
        _events.emit("amp_overflow", **fields)


PIPELINE_TRACES = _m.counter(
    "paddle_tpu_pipeline_traces_total",
    "pipeline_apply traces (jit retrace = new schedule/shape)",
    labelnames=("axis",))
PIPELINE_STAGES = _m.gauge(
    "paddle_tpu_pipeline_stages", "Stages in the last traced pipeline",
    labelnames=("axis",))
PIPELINE_MICROBATCHES = _m.gauge(
    "paddle_tpu_pipeline_microbatches",
    "Microbatches in the last traced pipeline", labelnames=("axis",))
PIPELINE_BUBBLE_FRACTION = _m.gauge(
    "paddle_tpu_pipeline_bubble_fraction",
    "GPipe bubble (S-1)/(n_micro+S-1) of the last traced pipeline",
    labelnames=("axis",))


def record_pipeline_trace(axis: str, stages: int, n_micro: int):
    PIPELINE_TRACES.inc(axis=axis)
    PIPELINE_STAGES.set(stages, axis=axis)
    PIPELINE_MICROBATCHES.set(n_micro, axis=axis)
    PIPELINE_BUBBLE_FRACTION.set(
        (stages - 1) / max(1, n_micro + stages - 1), axis=axis)


ANALYSIS_RUNS = _m.counter(
    "paddle_tpu_analysis_runs_total",
    "Full static-analysis pass-suite walks (paddle_tpu/analysis). "
    "Validation results are cached per program version — a rising rate "
    "at steady state means the validation cache is not holding",
    labelnames=("where",))
ANALYSIS_FINDINGS = _m.counter(
    "paddle_tpu_analysis_findings_total",
    "Static-analysis findings by pass and severity "
    "(error|warning|info); PADDLE_TPU_VALIDATE=2 refuses to run a "
    "program with error-severity findings",
    labelnames=("pass", "severity"))


def record_analysis(findings, n_ops: int, where: str, seconds: float):
    """One static-analysis pass-suite walk (paddle_tpu/analysis
    run_passes): per-pass/severity finding counts plus one `analysis`
    event summarizing the walk — a program failing validation on a
    fleet must be reconstructable from the JSONL log alone."""
    ANALYSIS_RUNS.inc(where=where)
    by_sev: Dict[str, int] = {}
    for f in findings:
        ANALYSIS_FINDINGS.inc(**{"pass": f.pass_name,
                                 "severity": f.severity})
        by_sev[f.severity] = by_sev.get(f.severity, 0) + 1
    _events.emit("analysis", where=where, ops=int(n_ops),
                 seconds=round(seconds, 6),
                 errors=by_sev.get("error", 0),
                 warnings=by_sev.get("warning", 0),
                 infos=by_sev.get("info", 0))
