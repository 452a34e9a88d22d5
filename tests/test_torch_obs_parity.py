"""The port's observability layers against the JAX package's, on the same
inputs (numpy from a seed, injected clocks): perfwatch snapshots, SLO
burn rates and alerts, time-series dirs read across packages, memwatch
owner rows of a decode engine, the decode phases' FLOP formula against
XLA's cost analysis, the decode engine's and the executor's telemetry,
and the profiler with POST /v1/profile."""

import concurrent.futures
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

import chip_smoke
import paddle_tpu as pt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import aggregate as jaggregate
from paddle_tpu.observability import events as jevents
from paddle_tpu.observability import memwatch as jmemwatch
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import perfwatch as jperfwatch
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import telemetry as jtelemetry
from paddle_tpu.observability import timeseries as jtimeseries
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine

import paddle_tpu_torch as ptt
from paddle_tpu_torch import profiler
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import aggregate, events, httpd
from paddle_tpu_torch.observability import memwatch, metrics, perfwatch
from paddle_tpu_torch.observability import slo, telemetry, timeseries
from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
from paddle_tpu_torch.serving import Server, ServingConfig

torch.set_num_threads(2)

# relative tolerance of the float comparisons below: both packages run
# the same stdlib arithmetic on the same inputs, so they agree to the
# last bits
REL = 1e-12


def _close(a, b, path="snapshot"):
    """a == b, floats within REL relative (dicts and lists recursed)."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=REL, abs=1e-300), (path, a, b)
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# perfwatch
# ---------------------------------------------------------------------------

def _perf_steps(seed=0, n=60):
    """(kind, seconds, flops, tokens, host_blocked, collective,
    device_kind, n_devices, now) of `n` steps over 120 s, so the 60 s
    window prunes the early ones."""
    rng = np.random.RandomState(seed)
    kinds = {"pw_prefill": ("TPU v5 lite", 1), "pw_decode": ("cpu", 4)}
    names = sorted(kinds)
    out = []
    for t in np.sort(rng.uniform(1000.0, 1120.0, size=n)):
        kind = names[rng.randint(2)]
        seconds = float(rng.uniform(1e-3, 0.2))
        out.append((kind, seconds, float(rng.uniform(1e9, 1e13)),
                    int(rng.randint(0, 9)),
                    float(rng.uniform(0, seconds)),
                    float(rng.uniform(0, 0.05)), *kinds[kind], float(t)))
    return out


def _step_time(pw, kind):
    return {c: pw.STEP_TIME.value(kind=kind, component=c)
            for c in ("device", "host_blocked", "collective")}


def test_perfwatch_snapshots_match_jax():
    """The same record_step sequence (injected `now`) gives equal
    snapshot() dicts at every step, and equal step-time components."""
    steps = _perf_steps()
    for pw in (perfwatch, jperfwatch):
        pw.reset()
    kinds = sorted({s[0] for s in steps})
    before = {id(pw): {k: _step_time(pw, k) for k in kinds}
              for pw in (perfwatch, jperfwatch)}
    for kind, sec, flops, tok, host, coll, dk, nd, now in steps:
        for pw in (perfwatch, jperfwatch):
            pw.record_step(kind, sec, flops=flops, tokens=tok,
                           host_blocked=host, collective_seconds=coll,
                           device_kind=dk, n_devices=nd, now=now)
        _close(perfwatch.snapshot(now=now + 0.5),
               jperfwatch.snapshot(now=now + 0.5))
    for kind in kinds:
        got = {c: v - before[id(perfwatch)][kind][c]
               for c, v in _step_time(perfwatch, kind).items()}
        want = {c: v - before[id(jperfwatch)][kind][c]
                for c, v in _step_time(jperfwatch, kind).items()}
        _close(got, want, kind)
    assert perfwatch.snapshot(now=1200.0)["pw_decode"]["steps"] == 0
    for pw in (perfwatch, jperfwatch):
        pw.reset()


# ---------------------------------------------------------------------------
# time series and SLOs
# ---------------------------------------------------------------------------

TS_REQUESTS = "obs_parity_requests_total"
TS_LATENCY = "obs_parity_request_seconds"
SLO_SPEC = {"slos": [
    {"name": "parity-availability", "type": "availability",
     "target": 0.99,
     "errors": {"metric": TS_REQUESTS, "labels": {"outcome": "error"}},
     "total": {"metric": TS_REQUESTS}},
    {"name": "parity-latency", "type": "latency", "target": 0.9,
     "metric": TS_LATENCY, "threshold_s": 0.25}]}


def _traffic(seed=1, ticks=80):
    """Per 10 s tick: (ok, errors, latencies). Ticks 30-44 are an error
    and slow-request burst, so the alerts fire and then clear."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(ticks):
        burst = 30 <= i < 45
        n = int(rng.randint(20, 60))
        err = int(rng.binomial(n, 0.4 if burst else 0.002))
        lat = rng.lognormal(np.log(0.6 if burst else 0.05), 0.5, size=n)
        out.append((n - err, err, lat.tolist()))
    return out


def _record(mod_metrics, mod_ts, directory, traffic, t0=1000.0):
    """Drive one package's Recorder over `traffic` on its own registry;
    returns the sample times."""
    reg = mod_metrics.MetricsRegistry()
    req = reg.counter(TS_REQUESTS, "requests", labelnames=("outcome",))
    lat = reg.histogram(TS_LATENCY, "latency")
    rec = mod_ts.Recorder(directory, registry=reg, segment_samples=16)
    times = [t0]
    rec.sample_once(now=t0)        # the baseline
    for i, (ok, err, lats) in enumerate(traffic):
        req.inc(ok, outcome="ok")
        if err:
            req.inc(err, outcome="error")
        for v in lats:
            lat.observe(v)
        times.append(t0 + 10.0 * (i + 1))
        rec.sample_once(now=times[-1])
    return times


def _alerts(mod_events, seq):
    return [(e["slo"], e["state"], e["prev"])
            for e in mod_events.recent(10000, kind="slo_alert")
            if e["seq"] > seq and e["slo"].startswith("parity-")]


def _last_seq(mod_events):
    last = mod_events.recent(1)
    return last[-1]["seq"] if last else 0


def test_slo_engines_match_jax(tmp_path):
    """One objectives spec and one traffic sequence at injected times:
    the two SLOEngines give equal rows (burn rates, states) at every
    evaluation, and the same slo_alert transitions."""
    traffic = _traffic()
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    times = _record(metrics, timeseries, tdir, traffic)
    assert _record(jmetrics, jtimeseries, jdir, traffic) == times
    seqs = _last_seq(events), _last_seq(jevents)
    teng = slo.SLOEngine(SLO_SPEC, tdir, window_scale=0.05)
    jeng = jslo.SLOEngine(SLO_SPEC, jdir, window_scale=0.05)
    states = set()
    for now in times[1:]:
        rows = teng.evaluate(now=now)
        _close(rows, jeng.evaluate(now=now), f"rows@{now}")
        states.update(r["state"] for r in rows)
    assert teng.max_burn_rate() == pytest.approx(jeng.max_burn_rate(),
                                                 rel=REL)
    assert {"ok", "fast_burn"} <= states
    got, want = _alerts(events, seqs[0]), _alerts(jevents, seqs[1])
    assert got == want and len(got) >= 4


TS_QUERIES = (("increase", TS_REQUESTS, None),
              ("increase", TS_REQUESTS, {"outcome": "error"}),
              ("rate", TS_REQUESTS, None))


def _ts_numbers(store, now):
    """rate(), increase() and quantiles of one TSStore over 60 s and
    300 s windows ending at `now`."""
    out = {}
    for w in (60.0, 300.0):
        for fn, name, labels in TS_QUERIES:
            out[f"{fn}:{labels}:{w}"] = getattr(store, fn)(
                name, w, now=now, labels=labels)
        out[f"by:{w}"] = store.increase(TS_REQUESTS, w, now=now,
                                        by="outcome")
        for q in (0.5, 0.9, 0.99):
            out[f"q{q}:{w}"] = store.quantile(q, TS_LATENCY, w, now=now)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ts_dirs_read_across_packages(tmp_path, writer):
    """One package's Recorder writes a dir and the other's
    `aggregate.read_ts_dir` reads it: both packages' stores give the
    same rate(), increase() and quantiles."""
    traffic = _traffic(seed=2, ticks=40)
    mods = {"port": (metrics, timeseries), "jax": (jmetrics, jtimeseries)}
    d = str(tmp_path / writer)
    times = _record(*mods[writer], d, traffic)
    reader = jaggregate if writer == "port" else aggregate
    writer_agg = aggregate if writer == "port" else jaggregate
    recs = reader.read_ts_dir(d)
    assert recs == writer_agg.read_ts_dir(d)
    assert len(recs) == len(times)
    for now in times[10::10]:
        got = _ts_numbers(reader.TSStore(recs), now)
        _close(got, _ts_numbers(writer_agg.TSStore.load(d), now))
    total = sum(ok + err for ok, err, _ in traffic)
    assert reader.TSStore(recs).increase(TS_REQUESTS, 1e9,
                                         now=times[-1]) == total


# ---------------------------------------------------------------------------
# the decode engine: memwatch, FLOPs, telemetry
# ---------------------------------------------------------------------------

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


BASE = dict(block_size=8, num_blocks=64, precision="f32", max_len=64)
BUCKETED = dict(BASE, decode_slots=(2, 4), prefill_buckets=(8, 16, 32, 64))
REUSE = dict(BASE, decode_slots=(4,), prefill_chunk=8, prefix_cache=True,
             spec_k=2)


def _prompts(seed=3):
    """Five prompts of 3-36 tokens sharing a 16-token prefix (two full
    blocks, so the prefix cache retains them)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 500, size=16).tolist()
    return [shared + rng.randint(1, 500, size=n).tolist()
            for n in (4, 9, 20)] + [[5, 6, 7], list(range(1, 12))]


def _engines(model, kw, draft=False, tag=None):
    params, cfg, jparams, jcfg = model
    kw = dict(kw, model_tag=tag) if tag else kw
    jeng = JDecodeEngine(jparams, jcfg, JDecodeConfig(**kw),
                         draft=(jparams, jcfg) if draft else None)
    teng = DecodeEngine(params, cfg, DecodeConfig(**kw),
                        (params, cfg) if draft else None, device="cpu")
    return teng, jeng


def _serve(eng, prompts, max_new=6):
    """Warm, then every prompt queued before the first admission."""
    eng.warmup()
    with eng._cv:
        handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    return [[int(t) for t in h.result(timeout_s=300)] for h in handles]


def _owner_rows(mod, tag):
    rep = mod.sweep(force=True)
    rows = {}
    for owner in (f"kv_pool[{tag}]", f"params[{tag}]",
                  f"prefix_cache[{tag}]"):
        rows[owner] = (mod.HBM_BYTES.value(owner=owner),
                       mod.HBM_BUFFERS.value(owner=owner))
        assert rep["owners"].get(owner, 0) == rows[owner][0]
    return rows


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_memwatch_owner_rows_match_jax(model, precision):
    """After the same requests the owner rows kv_pool[m], params[m] and
    prefix_cache[m] are equal in bytes and buffer counts; they are gone
    after stop()."""
    teng, jeng = _engines(model, dict(REUSE, spec_k=0, precision=precision),
                          tag="m")
    try:
        prompts = _prompts()
        assert _serve(teng, prompts) == _serve(jeng, prompts)
        got, want = _owner_rows(memwatch, "m"), _owner_rows(jmemwatch, "m")
        assert got == want
        assert got["kv_pool[m]"] == (
            sum(t.numel() * t.element_size() for t in teng._pools), 2)
        assert got["params[m]"][1] == len(teng.params)
        assert got["prefix_cache[m]"][0] > 0
    finally:
        teng.stop()
        jeng.stop()
    # the providers are gone: the owners leave the sweep's report (their
    # gauges keep the last value in both packages)
    for mod in (memwatch, jmemwatch):
        owners = mod.sweep(force=True)["owners"]
        assert not [o for o in owners if o.endswith("[m]")], owners


def test_oom_guard_reports_as_the_jax_package(model):
    """oom_guard turns a torch.cuda.OutOfMemoryError into the JAX
    package's `oom` event (same fields) and a counted, logged report,
    and re-raises it."""
    teng, jeng = _engines(model, BUCKETED, tag="oom")
    seqs = _last_seq(events), _last_seq(jevents)
    try:
        n0 = memwatch.OOMS.value(kind="obs_parity")
        with pytest.raises(torch.cuda.OutOfMemoryError):
            with memwatch.oom_guard("obs_parity"):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        with pytest.raises(MemoryError):
            with jmemwatch.oom_guard("obs_parity"):
                raise MemoryError("RESOURCE_EXHAUSTED: out of memory")
        with pytest.raises(ValueError):
            with memwatch.oom_guard("obs_parity"):
                raise ValueError("not an allocation failure")
    finally:
        teng.stop()
        jeng.stop()
    assert memwatch.OOMS.value(kind="obs_parity") == n0 + 1
    got = [e for e in events.recent(1000, kind="oom") if e["seq"] > seqs[0]]
    want = [e for e in jevents.recent(1000, kind="oom")
            if e["seq"] > seqs[1]]
    assert len(got) == len(want) == 1
    drop = {"ts", "seq", "pid", "host", "trace_id"}
    assert set(got[0]) - drop == set(want[0]) - drop
    assert got[0]["dispatch_kind"] == want[0]["dispatch_kind"]
    assert {"kv_pool[oom]", "params[oom]"} <= set(got[0]["owners"])
    assert got[0]["owners"]["params[oom]"] == \
        want[0]["owners"]["params[oom]"]


# The JAX engine's FLOPs are XLA's cost analysis of each phase, which
# counts the body of the layer scan ONCE (and every elementwise op):
# they are a one-layer model's. The port's `forward_flops` at depth 1
# is therefore held against them, and comes out below them by the
# elementwise work it leaves out (layer norms, softmax, GELU, residual
# adds): 0.92-0.94 of XLA's count on this CPU at GPTConfig.tiny(), on
# every bucket and slot count.
FLOPS_RATIO = (0.85, 1.0)


def test_phase_flops_against_xla_cost_analysis(model):
    teng, jeng = _engines(model, BUCKETED)
    try:
        jeng.warmup()
        one = gpt.GPTConfig.tiny()
        one.layers = 1
        table = teng.kv_cfg.max_blocks_per_seq * teng.kv_cfg.block_size
        ratios = {}
        for key, disp, want in (
                [(("prefill", b), jeng._prefill[b],
                  one.forward_flops(b, b, 1)) for b in teng.prefill_buckets] +
                [(("decode", s), jeng._decode[s],
                  one.forward_flops(s, table, s)) for s in teng.decode_slots]):
            xla = disp.current_cost()["flops"]
            ratios[key] = want / xla
            # the port's sample is the full depth's
            assert teng._flops[key] == pytest.approx(
                teng.model_cfg.forward_flops(*{
                    "prefill": (key[1], key[1], 1),
                    "decode": (key[1], table, key[1])}[key[0]]), rel=0)
        assert all(FLOPS_RATIO[0] <= r <= FLOPS_RATIO[1]
                   for r in ratios.values()), ratios
    finally:
        teng.stop()
        jeng.stop()


def _window_tokens(pw):
    with pw._lock:
        return {k: (len(w.entries), sum(e[3] for e in w.entries))
                for k, w in pw._windows.items()}


def _ready_counts(tel, sites):
    return {s: tel.DISPATCH_READY_SECONDS.stats(site=s)["count"]
            for s in sites}


@pytest.mark.parametrize("kw,draft", [(BUCKETED, False), (REUSE, True)],
                         ids=["bucketed", "reuse"])
def test_decode_telemetry_matches_jax(model, kw, draft):
    """The same requests through both engines: equal boot analysis runs,
    equal perfwatch samples and tokens per kind (prefill one token a
    request; decode the occupied slots or the accepted tokens), equal
    dispatch-ready observations per site."""
    sites = ("decode:prefill", "fetch:decode")
    runs = (telemetry.ANALYSIS_RUNS.value(where="decode"),
            jtelemetry.ANALYSIS_RUNS.value(where="decode"))
    ready = _ready_counts(telemetry, sites), _ready_counts(jtelemetry, sites)
    teng, jeng = _engines(model, kw, draft=draft)
    perfwatch.reset()
    jperfwatch.reset()
    try:
        prompts = _prompts()
        assert _serve(teng, prompts) == _serve(jeng, prompts)
    finally:
        # stop() joins the scheduler, which resolves its last in-flight
        # step: every sample is in before they are read
        teng.stop()
        jeng.stop()
    samples = _window_tokens(perfwatch)
    assert samples == _window_tokens(jperfwatch)
    assert samples["prefill"][1] == len(prompts)
    snap = perfwatch.snapshot()
    assert snap["decode"]["device_kind"] == "cpu"
    assert snap["decode"]["mfu"] > 0
    assert snap["decode"]["tokens_per_sec_per_chip"] > 0
    perfwatch.reset()
    jperfwatch.reset()
    assert telemetry.ANALYSIS_RUNS.value(where="decode") - runs[0] == 1
    assert jtelemetry.ANALYSIS_RUNS.value(where="decode") - runs[1] == 1
    got = {s: n - ready[0][s] for s, n in
           _ready_counts(telemetry, sites).items()}
    want = {s: n - ready[1][s] for s, n in
            _ready_counts(jtelemetry, sites).items()}
    assert got == want


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _exec_counts(tel):
    return ({m: tel.EXEC_STEPS.value(mode=m) for m in ("run", "chained")},
            {e: tel.EXEC_CACHE.value(event=e) for e in ("hit", "miss")})


def test_executor_telemetry_matches_jax():
    """The LeNet rung's startup program, then `n` steps and two chained
    runs, with both packages' Executors: equal
    paddle_tpu_executor_steps_total{mode} and cache hit/miss counts."""
    rng = np.random.RandomState(4)
    feed = {"x": rng.rand(8, 1, 28, 28).astype("float32"),
            "y": rng.randint(0, 10, (8, 1)).astype("int64")}
    deltas = []
    for pkg, tel in ((ptt, telemetry), (pt, jtelemetry)):
        with pkg.framework.unique_name.guard():
            main, startup, loss = chip_smoke.lenet_rung_program(pkg)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        before = _exec_counts(tel)
        exe.run(startup, scope=scope)
        for _ in range(5):
            exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        for _ in range(2):
            exe.run_chained(main, feed=feed, fetch_list=[loss.name],
                            n_steps=2, scope=scope)
        after = _exec_counts(tel)
        deltas.append(tuple({k: d[k] - b[k] for k in d}
                            for d, b in zip(after, before)))
    assert deltas[0] == deltas[1]
    assert deltas[0][0] == {"run": 6, "chained": 2}
    assert deltas[0][1]["miss"] >= 2


# ---------------------------------------------------------------------------
# the profiler and POST /v1/profile
# ---------------------------------------------------------------------------

def test_profiler_state_machine(tmp_path):
    """The JAX package's state machine on torch.profiler: stop without
    start is a no-op, a second start raises, the timeline lands in
    <dir>/<host>.trace.json, reset clears the dir."""
    profiler.reset_profiler()
    profiler.stop_profiler()            # no trace: no-op
    assert profiler.trace_dir() is None
    profiler.start_profiler(profile_path=str(tmp_path))
    try:
        with pytest.raises(profiler.ProfilerBusyError,
                           match="already active"):
            profiler.start_profiler(profile_path=str(tmp_path))
        with pytest.raises(profiler.ProfilerBusyError):
            profiler.capture_profile(0.05)
        torch.ones(8) @ torch.ones(8)
    finally:
        profiler.stop_profiler()
    profiler.stop_profiler()            # second stop: no-op
    assert profiler.trace_dir() == str(tmp_path)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        assert json.load(f)["traceEvents"]
    profiler.reset_profiler()
    assert profiler.trace_dir() is None


def test_trace_starts_and_stops_only_between_device_steps(tmp_path):
    """A start or stop waits for another thread's running device step,
    and a step asked for meanwhile waits for it (ROADMAP F12: a stop
    overlapping a CUDA-graph replay hung the process on the card); steps
    nest, and a thread inside one starts and stops a trace itself."""
    profiler.reset_profiler()
    seen = []
    held, release = threading.Event(), threading.Event()

    def step(name, hold=False):
        with profiler.device_step():
            seen.append((name, profiler._prof is not None))
            if hold:
                held.set()
                assert release.wait(30)

    def waiting():
        t0 = time.monotonic()
        while not profiler._waiting and time.monotonic() - t0 < 30:
            time.sleep(0.001)
        return profiler._waiting

    def traces():
        return [f for f in os.listdir(tmp_path) if f.endswith(".trace.json")]

    # torch.profiler stops a trace on the thread that started it
    switcher = concurrent.futures.ThreadPoolExecutor(1)
    for switch in (lambda: profiler.start_profiler(
            profile_path=str(tmp_path)), profiler.stop_profiler):
        held.clear()
        release.clear()
        seen.clear()
        on = profiler._prof is None         # the state after the switch
        a = threading.Thread(target=step, args=("a", True))
        a.start()
        assert held.wait(30)
        done = switcher.submit(switch)
        assert waiting() == 1
        b = threading.Thread(target=step, args=("b",))
        b.start()
        time.sleep(0.2)
        # the switch waits for a's step, and b's step for the switch
        assert seen == [("a", not on)] and not traces()
        release.set()
        done.result(30)
        for t in (a, b):
            t.join(30)
        assert seen == [("a", not on), ("b", on)]
        assert bool(traces()) == (not on)
    switcher.shutdown()
    with profiler.device_step(), profiler.device_step():
        profiler.start_profiler(profile_path=str(tmp_path / "own"))
        profiler.stop_profiler()
    assert profiler._steps == 0 and not profiler._switching
    assert os.listdir(tmp_path / "own")
    profiler.reset_profiler()


def test_export_chrome_tracing_roundtrip(tmp_path):
    profiler.reset_profiler()
    with profiler.RecordEvent("op_run"):
        time.sleep(0.02)
    with profiler.RecordEvent("fetch"):
        pass
    p = profiler.export_chrome_tracing(str(tmp_path / "trace.json"))
    evs = json.load(open(p))["traceEvents"]
    by_name = {e["name"]: e for e in evs}
    assert {"op_run", "fetch"} <= set(by_name)
    assert all(e["ph"] == "X" for e in evs)
    assert 15e3 <= by_name["op_run"]["dur"] <= 5e6
    assert all(e["cat"] == "host" for e in evs)


def test_profiled_record_events_merge_with_the_torch_timeline(tmp_path):
    """Under profiler.profiler() the merged export holds the RecordEvent
    host spans and torch.profiler's own records of the same ranges."""
    profiler.reset_profiler()
    with profiler.profiler(profile_path=str(tmp_path)):
        with profiler.RecordEvent("obs_matmul"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    evs = json.load(open(profiler.export_chrome_tracing(
        str(tmp_path / "merged.json"))))["traceEvents"]
    cats = {e.get("cat") for e in evs if e.get("name") == "obs_matmul"}
    assert "host" in cats and cats - {"host"}, cats
    assert any(e.get("cat") == "cpu_op" for e in evs)
    profiler.reset_profiler()


def _post_profile(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/profile", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_profile_endpoint_busy_409_and_bad_request_400():
    port = httpd.start_http_server(0)
    try:
        t = threading.Thread(target=lambda: profiler.capture_profile(1.0),
                             daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while profiler._prof is None and time.monotonic() < deadline:
            time.sleep(0.01)
        code, body = _post_profile(port, b'{"seconds": 0.1}')
        assert code == 409 and "error" in body
        for bad in (b"[1, 2]", b'{"seconds": "x"}', b"not json"):
            assert _post_profile(port, bad)[0] == 400
        t.join(timeout=30)
    finally:
        httpd.stop_http_server()
    out = profiler.capture_profile(0.0)      # clamped up to the minimum
    assert out["seconds"] == profiler.MIN_CAPTURE_SECONDS


def test_serving_profile_route_returns_the_capture(model, tmp_path,
                                                   monkeypatch):
    """POST /v1/profile on the serving port, under generate traffic:
    200 with dir, trace and perf; perf.json holds perfwatch (the decode
    engine's samples) and the memory owner table; /v1/status carries
    the same memory block."""
    monkeypatch.setenv(profiler.PROFILE_DIR_ENV, str(tmp_path))
    params, cfg = model[:2]
    eng = DecodeEngine(params, cfg, DecodeConfig(**dict(
        BUCKETED, model_tag="srv")), device="cpu")
    srv = Server(ServingConfig(), decode=eng)
    port = srv.start(0)
    # status_block() sweeps at most once a second: start from a sweep
    # that sees this engine
    memwatch.sweep(force=True)
    try:
        stop = threading.Event()

        def traffic():
            while not stop.is_set():
                eng.submit([1, 2, 3], max_new_tokens=4).result(timeout_s=60)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        code, out = _post_profile(port, b'{"seconds": 0.5}')
        stop.set()
        t.join(timeout=60)
        assert code == 200, out
        assert set(out) == {"dir", "trace", "perf", "seconds"}
        assert os.path.dirname(out["dir"]) == str(tmp_path)
        with open(out["perf"]) as f:
            perf = json.load(f)
        assert {"perfwatch", "memory"} <= set(perf)
        assert "decode" in perf["perfwatch"]
        assert "kv_pool[srv]" in perf["memory"]["owners"]
        with open(out["trace"]) as f:
            assert json.load(f)["traceEvents"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/status", timeout=30) as r:
            status = json.loads(r.read())
        assert status["memory"]["owners"]["kv_pool[srv]"] == \
            perf["memory"]["owners"]["kv_pool[srv]"]
    finally:
        srv.stop()
