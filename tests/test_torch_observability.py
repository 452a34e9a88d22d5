"""The port's copies of the JAX package's stdlib observability,
resilience and parameter-server-error modules have not drifted from
their sources, and the decode
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

from test_torch_imports import reword_lines

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (copy in the port, its source in the JAX package)
COPIES = [("resilience/atomic.py", "resilience/atomic.py"),
          ("observability/events.py", "observability/events.py"),
          ("observability/metrics.py", "observability/metrics.py"),
          ("ps/errors.py", "ps/errors.py"),
          ("resilience/faults.py", "resilience/faults.py"),
          ("resilience/preemption.py", "resilience/preemption.py"),
          ("resilience/checkpoint_manager.py",
           "resilience/checkpoint_manager.py"),
          ("observability/perfwatch.py", "observability/perfwatch.py"),
          ("observability/timeseries.py", "observability/timeseries.py"),
          ("observability/aggregate.py", "observability/aggregate.py"),
          ("observability/slo.py", "observability/slo.py"),
          ("observability/telemetry.py", "observability/telemetry.py"),
          ("observability/__init__.py", "observability/__init__.py")]

# copies with declared changes: (copy, header lines, [(source text, its
# replacement)]); each source text occurs once in the source. The
# loggers' JAX-package names are refused by the port's import-hygiene
# test; retry.py's CircuitBreaker takes the JAX package's
# analysis.lockcheck.Lock, which the port does not have.
CHANGED_COPIES = [
    # the deferred profiler import's comment names torch (the import
    # itself, `from .. import profiler`, resolves to this package's)
    ("observability/httpd.py", 3,
     [("    # deferred: profiler pulls in jax; this module stays "
       "import-light\n",
       "    # deferred: profiler pulls in torch; this module stays "
       "import-light\n")]),
    # PEAKS gains the H100 rows at its head
    ("observability/device_peaks.py", 3,
     [("PEAKS = (\n", """PEAKS = (
    # NVIDIA cards, keyed by substrings of torch.cuda.get_device_name()
    # ("NVIDIA H100 PCIe", "NVIDIA H100 80GB HBM3"): public per-card
    # dense bf16, HBM bandwidth, HBM capacity and one-direction NVLink
    # (half the bidirectional figure). PCIe before SXM: more specific.
    ("h100 pcie", DevicePeak(756e12, 2.0e12, 80e9, 300e9)),
    ("h100 sxm", DevicePeak(989e12, 3.35e12, 80e9, 450e9)),
    ("h100 80gb hbm3", DevicePeak(989e12, 3.35e12, 80e9, 450e9)),
""")]),
    ("observability/health.py", 3,
     [('logging.getLogger("paddle_tpu.health")',
       'logging.getLogger("paddle_tpu_torch.health")')]),
    ("resilience/retry.py", 3,
     [('logging.getLogger("paddle_tpu.resilience")',
       'logging.getLogger("paddle_tpu_torch.resilience")'),
      ("""        # deferred import: the analysis package must not load during
        # package bootstrap; constructors only run after it
        from ..analysis import lockcheck as _lockcheck

        self._lock = _lockcheck.Lock(
            "resilience.retry.CircuitBreaker._lock")
""", """        # a plain lock: the port has no lock-order checker (the JAX
        # package's analysis.lockcheck, ROADMAP item 21)
        self._lock = threading.Lock()
""")]),
]

# memwatch.py is a port: every module-level definition is its source's
# but these, which read torch's allocator and tensors where the source
# walks jax.live_arrays() (`_owned_ids` becomes `_owned_storages` and
# `_device_total`), name this package's logger, or reword a gauge's
# help text; the docstring says what differs
MEMWATCH_PORTED = {"log", "HBM_BYTES", "EXECUTABLE_BYTES", "sweep",
                   "is_oom"}
MEMWATCH_SOURCE_ONLY = {"_owned_ids"}
MEMWATCH_PORT_ONLY = {"_owned_storages", "_device_total"}

# tracing.py's one declared change: the logger's name, whose JAX-package
# form the port's import-hygiene test refuses
TRACING_CHANGE = ('logging.getLogger("paddle_tpu.observability")',
                  'logging.getLogger("paddle_tpu_torch.observability")')

# analysis/__init__.py's declared changes: the lockcheck import at its
# end is left out (the port has no lock-order checker, ROADMAP item 21),
# and its line 24 is reworded; analysis/passes.py rewords its lines 22
# and 373 (by line, test_torch_imports.reword_lines)
ANALYSIS_REWORDED = {
    24: "  an in-repo model function, with table/JSON output and a DOT "
        "render."}
PASSES_REWORDED = {
    22: "  precision      — programs whose declared dtypes contradict the",
    373: "# precision-policy audit (autocast white/black lists)"}
ANALYSIS_CHANGE = ("""# The runtime concurrency sanitizer (PADDLE_TPU_LOCKCHECK instrumented
# lock factories + deadlock detection) lives beside the program passes:
# same package, same observability contract, different substrate
# (threads instead of ProgramDescs). Stdlib-only, so importing it here
# costs nothing.
from . import lockcheck  # noqa: E402,F401
""", """# The runtime concurrency sanitizer (the JAX package's lockcheck) is
# not ported (ROADMAP item 21).
""")


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


@pytest.mark.parametrize("copy,header,changes", CHANGED_COPIES,
                         ids=[c[0] for c in CHANGED_COPIES])
def test_copy_differs_only_by_its_declared_changes(copy, header, changes):
    first, body = _copy_body(copy, header)
    assert f"paddle_tpu/{copy}" in first
    src = _read("paddle_tpu", copy)
    for old, new in changes:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert body == src


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
    first, body = _copy_body("analysis/__init__.py", 4)
    assert "paddle_tpu/analysis/__init__.py" in first
    src = reword_lines(_read("paddle_tpu", "analysis", "__init__.py"),
                       ANALYSIS_REWORDED)
    assert src.count(ANALYSIS_CHANGE[0]) == 1
    assert body == src.replace(*ANALYSIS_CHANGE)
    first, body = _copy_body("analysis/passes.py", 3)
    assert "paddle_tpu/analysis/passes.py" in first
    assert body == reword_lines(_read("paddle_tpu", "analysis", "passes.py"),
                                PASSES_REWORDED)


def test_telemetry_copy_matches_its_source_definitions():
    """telemetry.py is a whole-file copy: every definition, and every
    line, is its source's."""
    first, body = _copy_body("observability/telemetry.py", 2)
    assert "paddle_tpu/observability/telemetry.py" in first
    src = _read("paddle_tpu", "observability", "telemetry.py")
    assert body == src
    assert _definitions(body) == _definitions(src)


def test_memwatch_port_keeps_every_other_definition_of_its_source():
    src = _definitions(_read("paddle_tpu", "observability", "memwatch.py"))
    port_text = _read("paddle_tpu_torch", "observability", "memwatch.py")
    assert "paddle_tpu/observability/memwatch.py" in \
        port_text.splitlines()[0]
    port = _definitions(port_text)
    assert set(src) - set(port) == MEMWATCH_SOURCE_ONLY
    assert set(port) - set(src) == MEMWATCH_PORT_ONLY
    for name in set(src) & set(port):
        if name in MEMWATCH_PORTED:
            assert port[name] != src[name], name
        else:
            assert port[name] == src[name], name


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
