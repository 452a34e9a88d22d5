"""The port's offline tools against the JAX package's, on the same files:
`paddle_tpu_torch/tools/obsdump.py` prints byte for byte what the JAX
package's `tools/obsdump.py` prints, for every subcommand in its text
and `--json` forms, on dumps that the port's own modules wrote on the
CPU (a tiny decode engine and a QoS predict slot behind one Server, a
Router in front of it, the event log, the time-series recorder, the
trace sink, the profiler's run dir and a `capture_profile` dir). It
runs by file path without importing torch. `analyze --model lenet`
finds what the JAX tool finds."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import observability, profiler
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import memwatch, timeseries, tracing
from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
from paddle_tpu_torch.serving import Server, ServingConfig
from paddle_tpu_torch.serving.router import Router, RouterServer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT_TOOL = os.path.join(_REPO, "paddle_tpu_torch", "tools", "obsdump.py")
_JAX_TOOL = os.path.join(_REPO, "tools", "obsdump.py")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


QOS = {"tiers": ["gold", "bronze"], "default_tier": "bronze",
       "tenants": {"gold-client": {"tier": "gold", "weight": 4}}}
SLOS = {"slos": [{"name": "predict-latency", "type": "latency",
                  "target": 0.99,
                  "metric": "paddle_tpu_serving_request_seconds",
                  "threshold_s": 0.5}]}
SAMPLED = "00-{:032x}-{:016x}-01"
TRACE_ID = 0x5151


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _save_mlp(dirname):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[16], dtype="float32")
        pred = pt.layers.fc(input=x, size=4, act="softmax")
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    pt.io.save_inference_model(dirname, ["x"], [pred], exe,
                               main_program=main)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Files the port's modules wrote: {"metrics", "events", "trace_dir",
    "run_dir", "ts_dir", "slo_spec", "profile_dir"}."""
    root = tmp_path_factory.mktemp("obs")
    paths = {"metrics": str(root / "metrics.json"),
             "events": str(root / "events.jsonl"),
             "trace_dir": str(root / "trace"),
             "run_dir": str(root / "run"),
             "ts_dir": str(root / "ts"),
             "slo_spec": str(root / "slos.json"),
             "profile_dir": str(root / "profile")}
    with open(paths["slo_spec"], "w") as f:
        json.dump(SLOS, f)
    env = {"PADDLE_TPU_EVENT_LOG": paths["events"],
           "PADDLE_TPU_TRACE_DIR": paths["trace_dir"],
           "PADDLE_TPU_TRACE_SAMPLE": "1.0",
           "PADDLE_TPU_TS_DIR": paths["ts_dir"],
           "PADDLE_TPU_TS_INTERVAL_S": "0.2"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    model = str(root / "model")
    _save_mlp(model)
    cfg = gpt.GPTConfig.tiny()
    params, _ = gpt.init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    eng = DecodeEngine(params, cfg, DecodeConfig(
        block_size=8, num_blocks=40, decode_slots=(2, 4),
        prefill_buckets=(8, 16), max_len=48, precision="f32",
        prefix_cache=False), device="cpu")
    server = Server(ServingConfig(model, buckets=(1, 2, 4), use_tpu=False,
                                  qos=QOS, model_id="mlp"), decode=eng)
    router = front = None
    try:
        port = server.start(0)
        router = Router([f"127.0.0.1:{port}"], poll_interval_s=0.1)
        front = RouterServer(router)
        rport = front.start(0)
        timeseries.maybe_start_recorder()
        rows = np.random.RandomState(0).rand(2, 16).tolist()

        def traffic():
            for i in range(4):
                _post(port, "/v1/generate",
                      {"ids": [1 + i, 2, 3], "max_new_tokens": 4,
                       "stream": False},
                      {"traceparent": SAMPLED.format(TRACE_ID + i, 1 + i)})
                for tenant in ("gold-client", "bronze-x"):
                    _post(port, "/v1/predict",
                          {"feeds": {"x": rows}, "tenant": tenant})
                _post(rport, "/v1/predict", {"feeds": {"x": rows}})

        # the profiler's run dir (<host>.trace.json) and spans.json
        profiler.start_profiler(profile_path=paths["run_dir"])
        traffic()
        profiler.stop_profiler(profile_path=paths["run_dir"])
        tracing.save_spans(os.path.join(paths["run_dir"], "spans.json"))
        # a capture dir, taken while traffic runs
        th = threading.Thread(target=traffic)
        th.start()
        profiler.capture_profile(0.3, out_dir=paths["profile_dir"])
        th.join()
        memwatch.sweep(force=True)
    finally:
        if front is not None:
            front.stop()
        server.stop()
        timeseries.stop_recorder()
        tracing.flush_trace_sink()
        torch.set_num_threads(threads)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with open(paths["metrics"], "w") as f:
        json.dump(observability.snapshot(), f)
    return paths


def _run(path, argv):
    """(rc, stdout) of the tool at `path` run as main(argv) in this
    process. The tool is loaded inside the redirect: obsdump binds
    sys.stdout as a default argument when it loads."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _load(path, "_tool_under_test").main(argv)
    return rc, out.getvalue()


TOOLS = (_JAX_TOOL, _PORT_TOOL)


def _trace_id():
    return f"{TRACE_ID:032x}"


# subcommand argv with {placeholders} for the dumps. Every summary
# subcommand runs in its text and --json forms. No field is left out of
# the comparison: `top` and `slo` read their windows up to the TS dir's
# newest sample (`TSStore.latest_ts()`), not up to the clock, so two
# runs on one dir print the same bytes.
CASES = {
    "snapshot": ["snapshot", "{metrics}"],
    "snapshot_prom": ["snapshot", "{metrics}", "--prom"],
    "trace_list": ["trace", "{trace_dir}", "--list-traces"],
    "trace_id": ["trace", "{trace_dir}", "--trace-id", "{trace_id}"],
    "events": ["events", "{events}", "-n", "200"],
    "events_json": ["events", "{events}", "--json", "-n", "200"],
    "events_kind": ["events", "{events}", "--kind", "decode", "-n", "5"],
}
for _cmd in ("cache", "analysis", "locks", "ps", "fleet", "decode",
             "tenants", "mem"):
    CASES[_cmd] = [_cmd, "{metrics}"]
    CASES[_cmd + "_json"] = [_cmd, "{metrics}", "--json"]
for _cmd in ("ps", "fleet", "decode", "tenants"):
    CASES[_cmd + "_events"] = [_cmd, "{metrics}", "--events", "{events}"]
CASES.update({
    "top": ["top", "{ts_dir}", "--window", "3600"],
    "top_json": ["top", "{ts_dir}", "--window", "3600", "--json"],
    "slo": ["slo", "{ts_dir}", "--spec", "{slo_spec}"],
    "slo_json": ["slo", "{ts_dir}", "--spec", "{slo_spec}", "--json"],
    "profile": ["profile", "{profile_dir}"],
    "profile_json": ["profile", "{profile_dir}", "--json"],
})

# the subcommands whose table must hold rows of these dumps (the port
# emits no compile-cache, lock-check or parameter-server metric, so
# cache, locks and ps render the JAX tool's empty tables)
NON_EMPTY = {"snapshot": "paddle_tpu_decode_tokens_total",
             "trace_id": "decode.ttft", "events": "serve_start",
             "decode": "tokens", "tenants": "gold-client",
             "fleet": "127.0.0.1", "top": "recording pid",
             "slo": "predict-latency", "mem": "watermark",
             "profile": "capture dir"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_obsdump_prints_what_the_jax_tool_prints(dumps, case):
    argv = [a.format(trace_id=_trace_id(), **dumps) for a in CASES[case]]
    jax_rc, jax_out = _run(_JAX_TOOL, argv)
    rc, out = _run(_PORT_TOOL, argv)
    assert (rc, out) == (jax_rc, jax_out)
    assert rc == 0
    if case in NON_EMPTY:
        assert NON_EMPTY[case] in out, out[:2000]


def test_obsdump_trace_merges_the_profilers_run_dir(dumps, tmp_path):
    """`trace RUN_DIR` takes the torch profiler's <host>.trace.json and
    spans.json; `--trace-id --chrome` writes one trace's tree. Both
    tools write the same file."""
    for argv in (["trace", dumps["run_dir"]],
                 ["trace", dumps["trace_dir"], "--trace-id", _trace_id(),
                  "--chrome"]):
        got = []
        for tool in TOOLS:
            out = str(tmp_path / "out.json")
            rc, text = _run(tool, argv + ["-o", out])
            with open(out) as f:
                got.append((rc, text, json.load(f)))
        assert got[0] == got[1]
        assert got[1][0] == 0 and got[1][2]["traceEvents"]
    assert "from 2 source(s)" in got[0][1] or "events for trace" in \
        got[0][1]


_OFFLINE_PROBE = r"""
import importlib.util, sys
tool, argv = sys.argv[1], sys.argv[2:]
spec = importlib.util.spec_from_file_location("_obsdump", tool)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
for cmd in ("snapshot", "events", "top", "slo", "trace"):
    args = [a for a in argv if a.startswith(cmd + "=")][0][len(cmd) + 1:]
    assert mod.main([cmd] + args.split("|")) == 0, cmd
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("torch", "numpy", "paddle_tpu_torch", "jax", "paddle_tpu"))
assert not bad, bad
print("OFFLINE_OK")
"""


def test_obsdump_by_file_path_imports_no_torch(dumps):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    argv = [f"snapshot={dumps['metrics']}",
            f"events={dumps['events']}",
            f"top={dumps['ts_dir']}",
            f"slo={dumps['ts_dir']}|--spec|{dumps['slo_spec']}",
            f"trace={dumps['trace_dir']}|--list-traces"]
    r = subprocess.run([sys.executable, "-c", _OFFLINE_PROBE, _PORT_TOOL]
                       + argv, capture_output=True, text=True, timeout=60,
                       env=env, cwd=str(os.path.dirname(dumps["metrics"])))
    assert r.returncode == 0, r.stderr
    assert "OFFLINE_OK" in r.stdout


def test_analyze_lenet_finds_what_the_jax_tool_finds(tmp_path):
    """`analyze --model lenet` in its --json and text forms, and a
    program with an unknown op (exit code 1), as
    tests/test_analysis.py::test_analyze_cli_roundtrip runs the JAX
    tool."""
    import paddle_tpu as jpt
    from paddle_tpu.core.ir import OpDesc

    jax_tool = os.path.join(_REPO, "tools", "analyze.py")
    port_tool = os.path.join(_REPO, "paddle_tpu_torch", "tools",
                             "analyze.py")
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup):
        x = jpt.layers.data(name="x", shape=[4], dtype="float32")
        jpt.layers.fc(input=x, size=2)
    main.desc.block(0).ops.append(OpDesc(type="nosuch_op",
                                         inputs={"X": ["ghost"]},
                                         outputs={"Out": ["z"]}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"program": main.desc.to_dict(),
                               "feed_names": ["x"], "fetch_names": ["z"]}))
    for argv, want_rc in ((["--model", "lenet", "--json"], 0),
                          (["--model", "lenet"], 0),
                          (["--program", str(bad), "--json"], 1),
                          (["--program", str(bad)], 1)):
        got = []
        # each package names a program's vars from its own process-wide
        # counters: start both at 0, as in a fresh process
        for tool, pkg in ((jax_tool, jpt), (port_tool, pt)):
            with pkg.unique_name.guard():
                got.append(_run(tool, argv))
        assert got[0] == got[1] and got[1][0] == want_rc, argv
    assert "nosuch_op" in got[1][1]
