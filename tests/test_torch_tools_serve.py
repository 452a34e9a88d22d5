"""The port's `tools/serve_bench.py` at `--smoke` on the CPU: the
predict, token, prefix-share and tenants modes in this process, the
fleet mode (slow) as a subprocess. Each asserts correctness only (no
failed or wrong request, equal tokens, adoption, sheds on bronze, no
failure across the swap) and the report's metric names and units,
which are the JAX tool's. No assertion reads a time, a rate or a
speedup."""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (metric, unit) of each mode's JSON lines, as the JAX package's
# tools/serve_bench.py prints them
PREDICT = [("serving_p50_latency_ms", "ms"),          # :267
           ("serving_p99_latency_ms", "ms"),          # :268
           ("serving_throughput_rps", "req_rows/s"),  # :269
           ("serving_reject_rate", "fraction")]       # :272
TOKENS = [("decode_tokens_per_sec_continuous", "tokens/s/chip"),  # :550
          ("decode_tokens_per_sec_static", "tokens/s/chip"),      # :553
          ("decode_continuous_speedup", "x"),                     # :556
          ("decode_warm_replay_fresh_compiles", "count")]         # :561
PREFIX = [("decode_prefix_share_ttft_speedup", "x"),  # :693
          ("decode_prefix_share_hits", "blocks"),     # :694
          ("decode_spec_accept_rate", "fraction")]    # :695
TENANTS = [("tenant_gold_p99_ms", "ms"),              # :962
           ("tenant_bronze_sheds", "count"),          # :968
           ("hot_swap_failed_requests", "count")]     # :970
FLEET = [("fleet_failover_failed_requests", "count"),  # :1514
         ("fleet_scaleout_p99_recovered", "bool"),     # :1523
         ("fleet_scalein_dropped_requests", "count"),  # :1534
         ("fleet_trace_reconstructed", "bool"),        # :1540
         ("fleet_trace_overhead_p50", "ratio"),        # :1557
         ("fleet_slo_alert_fired", "bool"),            # :1566
         ("fleet_ts_recording_pids", "count"),         # :1577
         ("fleet_ts_overhead_p50", "ratio")]           # :1587


@pytest.fixture(autouse=True)
def one_thread(tmp_path, monkeypatch):
    """The tiny engines' CPU steps are dominated by per-op overhead,
    which intra-op threads only add to. The tool's scratch dirs
    (`tempfile.mkdtemp`) go under the test's tmp_path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench(argv):
    """(rc, JSON lines) of serve_bench's main(argv) in this process."""
    from paddle_tpu_torch.tools import serve_bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_bench.main(argv)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    return rc, lines


def _named(lines, want):
    """{metric: line}, after checking the lines' metric names and units
    against `want`."""
    assert [(ln["metric"], ln["unit"]) for ln in lines] == want
    return {ln["metric"]: ln for ln in lines}


def test_predict_mode_smoke():
    rc, lines = _bench(["--smoke"])
    m = _named(lines, PREDICT)
    d = m["serving_p50_latency_ms"]["detail"]
    assert rc == 0
    assert d["error"] == 0 and d["ok"] > 0
    assert d["ok"] + d["rejected"] + d["timeout"] == d["requests"] == \
        d["completed"]
    assert d["platform"] == "cpu" and d["smoke"] is True
    assert d["k1_fwd_launches"] == 0


def test_token_mode_smoke():
    rc, lines = _bench(["--smoke", "--tokens"])
    m = _named(lines, TOKENS)
    assert rc == 0
    for name in ("decode_tokens_per_sec_continuous",
                 "decode_tokens_per_sec_static"):
        d = m[name]["detail"]
        assert d["error"] == 0 and d["rejected"] == 0 and d["tokens"] > 0
        assert d["ok"] == d["requests"]
    # both phases served the same schedule: the same tokens in all
    assert m["decode_tokens_per_sec_continuous"]["detail"]["tokens"] == \
        m["decode_tokens_per_sec_static"]["detail"]["tokens"]
    d = m["decode_warm_replay_fresh_compiles"]["detail"]
    assert d["bit_identical"] is True and d["gate_ok"] is True
    # the grid: prefill buckets 8 and 16, one decode slot count
    assert d["adopted"] == d["phases"] == d["phases_ready"] == 3
    # the CPU runs every attention call on the plain route
    assert d["k1_fwd_launches"] == 0 and set(d["attention_routes"]) == \
        {"plain"}


def test_prefix_share_mode_smoke():
    rc, lines = _bench(["--smoke", "--tokens", "--prefix-share"])
    m = _named(lines, PREFIX)
    d = m["decode_prefix_share_ttft_speedup"]["detail"]
    assert rc == 0
    assert d["bit_identical"] is True and d["prefix_hits"] > 0
    assert m["decode_prefix_share_hits"]["value"] == d["prefix_hits"]
    assert m["decode_spec_accept_rate"]["value"] >= 0.99
    assert d["plain"]["tokens"] == d["kv_reuse"]["tokens"] > 0


def test_tenants_mode_smoke(monkeypatch):
    """The flood must overfill the 8-request queue for anything to shed.
    The MLP serves a batch in about a millisecond, faster than a host
    busy with other work lets this process's client threads send, and
    then nothing sheds; so each request is a full batch of 8 rows and
    each batch takes 20 ms more, and the 20 closed-loop senders
    outnumber the queue whatever the host's load."""
    from paddle_tpu_torch.serving import engine

    run_batch = engine.Engine.run_batch

    def slow_run_batch(self, feeds):
        time.sleep(0.02)
        return run_batch(self, feeds)

    monkeypatch.setattr(engine.Engine, "run_batch", slow_run_batch)
    rc, lines = _bench(["--smoke", "--tenants", "--batch", "8"])
    m = _named(lines, TENANTS)
    d = m["tenant_gold_p99_ms"]["detail"]
    assert rc == 0, json.dumps({k: d[k] for k in ("gold", "flood",
                                                  "shed_delta", "swap")})
    # every shed on bronze, none on gold, gold never failed
    assert d["gold"]["failed"] == 0 and d["gold"]["ok"] > 0
    assert d["shed_delta"].get("bronze", 0) > 0
    assert d["shed_delta"].get("gold", 0) == 0
    assert m["tenant_bronze_sheds"]["value"] == d["shed_delta"]["bronze"]
    # the hot swap: nothing failed, every bucket adopted
    swap = d["swap"]
    assert m["hot_swap_failed_requests"]["value"] == swap["failed"] == 0
    assert swap["requests"]["ok"] > 0 and swap["adopted_version"] == 1
    assert swap["warmstart_adopted"] == len(swap["buckets"]) > 0


def test_smoke_settings_are_the_jax_tools():
    """--smoke's traffic and sizes per mode, as the JAX tool sets them
    (tools/serve_bench.py:1617-1640)."""
    from paddle_tpu_torch.tools import serve_bench as sb

    def smoke(*flags):
        a = sb.smoke_settings(sb._build_args(list(flags)))
        return (a.rate, a.duration, a.max_batch, a.max_queue,
                a.max_wait_ms, a.timeout_s, a.slots, a.prefill_buckets,
                a.flood_threads, a.tenant_p99_factor)

    assert smoke() == (80.0, 1.5, 8, 64, 5.0, 10.0, "4,8", "8,16,32", 8,
                       10.0)
    assert smoke("--fleet") == (60.0, 2.5, 8, 64, 1.0, 20.0, "4,8",
                                "8,16,32", 8, 10.0)
    assert smoke("--tokens") == (600.0, 0.08, 8, 64, 5.0, 120.0, "4",
                                 "8,16", 8, 10.0)
    assert smoke("--tenants") == (40.0, 1.2, 8, 64, 5.0, 30.0, "4,8",
                                  "8,16,32", 4, 15.0)


def test_without_smoke_the_tool_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")
    from paddle_tpu_torch.tools import serve_bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bench.main(["--tokens"])


@pytest.mark.slow
def test_fleet_mode_smoke(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.serve_bench",
         "--fleet", "--smoke"],
        cwd=_REPO, capture_output=True, text=True, timeout=540,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    m = _named([json.loads(ln) for ln in r.stdout.splitlines()
                if ln.startswith("{")], FLEET)
    d = m["fleet_failover_failed_requests"]["detail"]
    assert m["fleet_failover_failed_requests"]["value"] == 0
    assert d["killed"] and d["ejections"] >= 1 and d["ok"] > 0
    d = m["fleet_scaleout_p99_recovered"]["detail"]
    assert d["scale_outs"] >= 1 and d["warmstart_adopted"] > 0
    assert m["fleet_scalein_dropped_requests"]["value"] == 0
    assert m["fleet_trace_reconstructed"]["value"] == 1
    d = m["fleet_trace_reconstructed"]["detail"]
    assert d["generate_processes"] >= 2 and d["generate_roots"] == 1
    assert "decode.ttft" in d["generate_spans"]
    assert "serve.queue_wait" in d["predict_spans"]
    assert m["fleet_slo_alert_fired"]["value"] == 1
    d = m["fleet_slo_alert_fired"]["detail"]
    assert "fast_burn" in d["states_seen"] and "ok" in d["states_seen"]
    assert m["fleet_ts_recording_pids"]["value"] >= 3
