"""The port's copies of the JAX package's stdlib observability and
resilience modules have not drifted from their sources, and the decode
engine's metrics, events and trace spans are those of the JAX package's
engine: the same names, updated at the same points."""

import ast
import os

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import events, tracing
from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
from paddle_tpu_torch.serving import decode as tdecode

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (copy in the port, its source in the JAX package)
COPIES = [("resilience/atomic.py", "resilience/atomic.py"),
          ("observability/events.py", "observability/events.py"),
          ("observability/metrics.py", "observability/metrics.py")]

# tracing.py's one declared change: the logger's name, whose JAX-package
# form the port's import-hygiene test refuses
TRACING_CHANGE = ('logging.getLogger("paddle_tpu.observability")',
                  'logging.getLogger("paddle_tpu_torch.observability")')

ANALYSIS_NAMES = ("ENV_VAR", "ERROR", "WARNING", "INFO", "_SEVERITIES",
                  "Finding", "findings_to_json", "AnalysisError",
                  "validate_level")


def _read(*parts):
    with open(os.path.join(_REPO, *parts)) as f:
        return f.read()


def _copy_body(rel, header_lines):
    """A copy's text after its header, which must name the source."""
    lines = _read("paddle_tpu_torch", rel).splitlines(keepends=True)
    return lines[0], "".join(lines[header_lines:])


@pytest.mark.parametrize("copy,source", COPIES, ids=[c for c, _ in COPIES])
def test_stdlib_copy_matches_its_source(copy, source):
    first, body = _copy_body(copy, 2)
    assert f"paddle_tpu/{source}" in first
    assert body == _read("paddle_tpu", source)


def test_tracing_copy_differs_only_by_its_logger_name():
    first, body = _copy_body("observability/tracing.py", 3)
    assert "paddle_tpu/observability/tracing.py" in first
    src = _read("paddle_tpu", "observability", "tracing.py")
    assert src.count(TRACING_CHANGE[0]) == 1
    assert body == src.replace(*TRACING_CHANGE)


def _definitions(text):
    """{name: source segment} of the module-level definitions, a class
    or function with its decorators."""
    out = {}
    lines = text.splitlines(keepends=True)
    for node in ast.parse(text).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            name = node.name
            start = min([d.lineno for d in node.decorator_list] +
                        [node.lineno])
            out[name] = "".join(lines[start - 1:node.end_lineno])
        elif isinstance(node, ast.Assign) and \
                isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.get_source_segment(text, node)
    return out


def test_analysis_copy_matches_its_source_definitions():
    src = _definitions(_read("paddle_tpu", "analysis", "__init__.py"))
    copy = _definitions(_read("paddle_tpu_torch", "analysis.py"))
    assert set(copy) == set(ANALYSIS_NAMES) | {"__all__"}
    for name in ANALYSIS_NAMES:
        assert copy[name] == src[name], name


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig.tiny()
    jcfg.dtype = "float32"
    jparams, _ = jgpt.init(jax.random.key(0), jcfg)
    cfg = gpt.GPTConfig.tiny()
    cfg.dtype = "float32"
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               "cpu", expected=gpt.param_shapes(cfg))
    return params, cfg, jparams, jcfg


KW = dict(block_size=8, num_blocks=64, decode_slots=(4,),
          prefill_buckets=(8, 16), precision="f32", max_len=64)

# a pool that preempts: 4 prompts of 3 tokens that grow to 3 blocks each
# against 8 usable blocks
PREEMPT_KW = dict(block_size=8, num_blocks=9, decode_slots=(4,),
                  prefill_buckets=(8, 16, 32, 64), precision="f32",
                  max_len=64)


def _counters():
    return ({p: tdecode.TOKENS.value(phase=p) for p in ("prefill", "decode")},
            {o: tdecode.REQUESTS.value(outcome=o)
             for o in ("eos", "length", "rejected", "cancelled", "error")},
            tdecode.PREEMPTIONS.total(), tdecode.STEPS.value(phase="decode"))


def test_decode_metrics_count_tokens_and_outcomes(model):
    """After a run with a preemption: the tokens counted by phase sum
    to the tokens emitted, the finished requests by outcome equal
    status()["requests"], the preemptions its "preempted"."""
    params, cfg = model[:2]
    eng = DecodeEngine(params, cfg, DecodeConfig(**PREEMPT_KW),
                       device="cpu")
    tok0, req0, pre0, steps0 = _counters()
    try:
        with eng._cv:   # every request queued before the first admission
            handles = [eng.submit([1 + i, 2, 3], max_new_tokens=20)
                       for i in range(4)]
        got = [h.result(timeout_s=300) for h in handles]
        status = eng.status()
    finally:
        eng.stop()
    tok1, req1, pre1, steps1 = _counters()
    assert status["requests"]["preempted"] > 0
    assert sum(tok1.values()) - sum(tok0.values()) == sum(map(len, got))
    # one prefill token a request, and one more a preemption's replay
    assert tok1["prefill"] - tok0["prefill"] == \
        len(got) + status["requests"]["preempted"]
    for outcome, n in req1.items():
        assert n - req0[outcome] == status["requests"][outcome], outcome
    assert pre1 - pre0 == status["requests"]["preempted"]
    assert steps1 > steps0
    assert tdecode.QUEUE_DEPTH.value() == 0


def _trace_names(trace_mod, ctx):
    return sorted({s.name for s in trace_mod.get_spans()
                   if (s.args or {}).get("trace_id") == ctx.trace_id})


def test_decode_spans_match_jax(model):
    """One request under a sampled trace: the port records the JAX
    engine's per-request spans, under the submitter's trace."""
    params, cfg, jparams, jcfg = model
    teng = DecodeEngine(params, cfg, DecodeConfig(**KW), device="cpu")
    jeng = JDecodeEngine(jparams, jcfg, JDecodeConfig(**KW))
    try:
        tctx = tracing.start_trace(sampled=True)
        with tracing.activate(tctx):
            teng.submit([1, 2, 3], max_new_tokens=4).result(timeout_s=120)
        jctx = jtracing.start_trace(sampled=True)
        with jtracing.activate(jctx):
            jeng.submit([1, 2, 3], max_new_tokens=4).result(timeout_s=120)
    finally:
        teng.stop()
        jeng.stop()
    names = _trace_names(tracing, tctx)
    assert names == _trace_names(jtracing, jctx)
    assert names == ["decode.decode", "decode.generate", "decode.prefill",
                     "decode.queue_wait", "decode.ttft"]


def test_preemption_span_and_events(model):
    """A preempted request records decode.preempt under its trace; the
    engine emits its start, preempt, drain and stop events, the preempt
    event carrying the trace id."""
    params, cfg = model[:2]
    eng = DecodeEngine(params, cfg, DecodeConfig(**PREEMPT_KW),
                       device="cpu")
    first = events.recent(1)
    seq = first[-1]["seq"] if first else 0
    ctx = tracing.start_trace(sampled=True)
    try:
        with tracing.activate(ctx), eng._cv:
            handles = [eng.submit([1 + i, 2, 3], max_new_tokens=20)
                       for i in range(4)]
        for h in handles:
            h.result(timeout_s=300)
        assert eng.drain(timeout_s=30)
    finally:
        eng.stop()
    assert "decode.preempt" in _trace_names(tracing, ctx)
    mine = [e for e in events.recent(1000, kind="decode") if e["seq"] > seq]
    actions = [e["action"] for e in mine]
    assert actions[0] == "start" and actions[-2:] == ["drain", "stop"]
    preempts = [e for e in mine if e["action"] == "preempt"]
    assert preempts and all(e["trace_id"] == ctx.trace_id for e in preempts)
