"""The port's HTTP token-serving front end, end to end on the CPU:
streamed and non-streamed /v1/generate, /v1/status, 400s, the 503 on a
full queue, cancellation when a streaming client hangs up, and the
operations surface (/v1/healthz's states, /v1/load and /v1/models
against the JAX package's server, trace headers, several models)."""

import json
import re
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import Server as JServer
from paddle_tpu.serving import ServingConfig as JServingConfig

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import events as tevents
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine, Server,
                                      ServingConfig)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    jparams, _ = jgpt.init(jax.random.key(0), jgpt.GPTConfig.tiny())
    cfg = gpt.GPTConfig.tiny()
    cfg.dtype = "float32"
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               "cpu")
    return params, cfg


def make_engine(model, **kw):
    params, cfg = model
    base = dict(block_size=8, num_blocks=64, decode_slots=(4,),
                prefill_buckets=(8,), precision="f32", max_len=64)
    base.update(kw)
    return DecodeEngine(params, cfg, DecodeConfig(**base), device="cpu")


def _post(port, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def test_streaming_http_e2e(model):
    eng = make_engine(model, max_queue=8)
    srv = Server(ServingConfig(), decode=eng)
    port = srv.start(0)
    try:
        # chunked stream: one ndjson line per token, closed by a done
        # record carrying finish_reason + ttft
        with _post(port, {"ids": [1, 2, 3], "max_new_tokens": 5}) as r:
            assert r.headers.get("Transfer-Encoding") == "chunked"
            recs = [json.loads(ln) for ln in r if ln.strip()]
        toks = [rec["token"] for rec in recs if "token" in rec]
        done = recs[-1]
        assert len(toks) == 5
        assert done["done"] and done["tokens"] == 5
        assert done["finish_reason"] == "length"
        assert done["ttft_ms"] > 0
        # the stream carries the engine's own greedy tokens
        assert toks == eng.submit([1, 2, 3], max_new_tokens=5).result(60)
        # non-stream reply carries the same tokens
        with _post(port, {"ids": [1, 2, 3], "max_new_tokens": 5,
                          "stream": False}) as r:
            body = json.loads(r.read())
        assert body["tokens"] == toks
        assert body["finish_reason"] == "length"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/status", timeout=30) as r:
            st = json.loads(r.read())
        assert st["decode"]["phase_grid"]["decode_slots"] == [4]
        assert st["decode"]["requests"]["length"] >= 3
        # malformed requests are 400s
        for bad in ({"max_new_tokens": 4}, {"ids": []},
                    {"ids": [10 ** 9]}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(port, bad)
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/nope",
                                   timeout=30)
        assert ei.value.code == 404
    finally:
        srv.stop()
    assert srv.port() is None and eng.status()["active"] == 0


def test_http_queue_full_503(model):
    eng = make_engine(model, static_batching=True, decode_slots=(1,),
                      max_queue=1, max_len=64)
    srv = Server(ServingConfig(), decode=eng)
    port = srv.start(0)
    try:
        # long active generation + one waiting fills the queue
        eng.submit([1, 2, 3], max_new_tokens=50)
        assert _wait(lambda: eng.status()["active"])
        eng.submit([4, 5], max_new_tokens=2)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, {"ids": [6, 7], "max_new_tokens": 2})
        assert ei.value.code == 503
    finally:
        srv.stop()


def test_client_disconnect_cancels_generation(model, monkeypatch):
    """A streaming client that hangs up after its first token frees its
    slot and KV blocks at once: the generation ends as cancelled long
    before its max_new_tokens."""
    real_step = gpt.apply_decode_step

    def slow_step(*a, **kw):   # keep the generation running for a while
        time.sleep(0.01)
        return real_step(*a, **kw)

    monkeypatch.setattr(gpt, "apply_decode_step", slow_step)
    eng = make_engine(model)
    srv = Server(ServingConfig(), decode=eng)
    port = srv.start(0)
    try:
        body = json.dumps({"ids": [1, 2, 3], "max_new_tokens": 60})
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        sock.sendall((f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Type: application/json\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n{body}")
                     .encode())
        got = b""
        while b'"token"' not in got:
            got += sock.recv(4096)
        assert got.startswith(b"HTTP/1.1 200")
        sock.close()
        total = eng.kv_cfg.usable_blocks
        assert _wait(lambda: eng.status()["requests"]["cancelled"] == 1)
        assert _wait(lambda: eng.status()["kv"]["blocks_free"] == total)
        st = eng.status()
        assert st["active"] == 0 and st["requests"]["length"] == 0
    finally:
        srv.stop()


# -- the operations surface: /v1/healthz, /v1/load, /v1/models ----------

TRACEPARENT = re.compile(r"^00-[0-9a-f]{32}-[0-9a-f]{16}-0[01]$")


def _get(port, path, headers=None):
    """(code, body, headers) of one GET, errors included."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _traced(headers):
    assert TRACEPARENT.match(headers.get("traceparent", "")), dict(headers)
    assert headers.get("X-Request-Id") == headers["traceparent"][3:35]


def _port_events(seq, kind):
    return [e for e in tevents.recent(1000, kind=kind) if e["seq"] > seq]


def test_healthz_follows_the_serving_state(model):
    """start() warms the engine before it binds; /v1/healthz reads 503
    "warming" while an engine is not warm, 200 "serving", 503
    "draining" after drain() (new generations 503 with Retry-After),
    and "stopped" once the engine or the server stopped."""
    eng = make_engine(model, decode_slots=(2, 4))
    srv = Server(ServingConfig(), decode=eng)
    assert srv.state() == "stopped" and not eng.warmed
    first = tevents.recent(1)
    seq = first[-1]["seq"] if first else 0
    port = srv.start(0)
    try:
        assert eng.warmed and eng.status()["warmed"]
        code, body, hdrs = _get(port, "/v1/healthz")
        assert (code, body["state"]) == (200, "serving")
        _traced(hdrs)
        # start() warms before binding, so the warming window is not
        # visible over HTTP; drive it directly, as the JAX package's
        # test of the same state does
        eng.warmed = False
        code, body, _ = _get(port, "/v1/healthz")
        assert (code, body["state"]) == (503, "warming")
        eng.warmed = True
        with _post(port, {"ids": [1, 2, 3], "max_new_tokens": 3,
                          "stream": False}) as r:
            assert len(json.loads(r.read())["tokens"]) == 3
        srv.drain(timeout=30)
        code, body, hdrs = _get(port, "/v1/healthz")
        assert (code, body["state"]) == (503, "draining")
        _traced(hdrs)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, {"ids": [1, 2], "max_new_tokens": 2})
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") == "1"
        _traced(ei.value.headers)
    finally:
        srv.stop()
    assert srv.state() == "stopped" and srv.port() is None
    kinds = [e["kind"] for e in tevents.recent(1000) if e["seq"] > seq
             and e["kind"].startswith("serve_")]
    assert kinds == ["serve_start", "serve_drain", "serve_stop"]
    # an engine stopped underneath a running server reads "stopped"
    eng2 = make_engine(model)
    srv2 = Server(ServingConfig(warmup=False), decode=eng2)
    port2 = srv2.start(0)
    try:
        assert not eng2.warmed and srv2.state() == "serving"
        eng2.stop()
        code, body, _ = _get(port2, "/v1/healthz")
        assert (code, body["state"]) == (503, "stopped")
    finally:
        srv2.stop()


def test_load_and_models_carry_the_jax_servers_keys(model):
    """/v1/load and /v1/models against the JAX package's decode-only
    Server on the same tiny GPT: the same keys, in the replies and in
    each model row; every reply carries X-Request-Id and a traceparent,
    adopting the caller's."""
    params, cfg = model
    jparams, _ = jgpt.init(jax.random.key(0), jgpt.GPTConfig.tiny())
    kw = dict(block_size=8, num_blocks=64, decode_slots=(4,),
              prefill_buckets=(8,), precision="f32", max_len=64)
    jsrv = JServer(JServingConfig(), decode=JDecodeEngine(
        jparams, jgpt.GPTConfig.tiny(), JDecodeConfig(**kw)))
    srv = Server(ServingConfig(), decode=make_engine(model))
    jport, port = jsrv.start(0), srv.start(0)
    try:
        replies = {}
        for path in ("/v1/load", "/v1/models", "/v1/status"):
            (jc, jb, _), (c, b, hdrs) = _get(jport, path), _get(port, path)
            assert c == jc == 200
            _traced(hdrs)
            replies[path] = (jb, b)
        jload, load = replies["/v1/load"]
        assert set(load) == set(jload)
        assert load == {"load": 0.0, "inflight": 0, "queue_depth": 0,
                        "state": "serving", "models": ["default"]}
        jrows, rows = (r["models"] for r in replies["/v1/models"])
        assert [set(r) for r in rows] == [set(r) for r in jrows]
        assert [set(r["decode"]) for r in rows] == \
            [set(r["decode"]) for r in jrows]
        assert rows[0]["id"] == "default" and rows[0]["kind"] == "decode"
        assert rows[0]["decode"]["warmed"] is True
        jst, st = replies["/v1/status"]
        assert {"state", "load", "inflight", "models", "decode"} <= \
            set(st) & set(jst)
        assert set(jst["decode"]) <= set(st["decode"])
        # a caller's traceparent is adopted: the reply names its trace
        theirs = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        _, _, hdrs = _get(port, "/v1/load", {"traceparent": theirs})
        assert hdrs["X-Request-Id"] == "ab" * 16
        with _post(port, {"ids": [1, 2, 3], "max_new_tokens": 2}) as r:
            _traced(r.headers)
            assert len([ln for ln in r if b'"token"' in ln]) == 2
    finally:
        srv.stop()
        jsrv.stop()


def test_a_server_of_several_models(model):
    """decode={model_id: engine}: /v1/models lists each, a request's
    "model" picks its engine, an unknown one is 404, and with no
    default engine a request without "model" is 404 too."""
    engines = {"a": make_engine(model), "b": make_engine(model,
                                                         decode_slots=(2,))}
    srv = Server(ServingConfig(), decode=engines)
    port = srv.start(0)
    try:
        assert all(e.warmed for e in engines.values())
        code, body, _ = _get(port, "/v1/models")
        assert [r["id"] for r in body["models"]] == ["a", "b"]
        assert not any(r["default"] for r in body["models"])
        with _post(port, {"ids": [1, 2, 3], "max_new_tokens": 3,
                          "model": "b", "stream": False}) as r:
            toks = json.loads(r.read())["tokens"]
        assert toks == engines["a"].submit([1, 2, 3], 3).result(60)
        assert engines["b"].status()["requests"]["length"] == 1
        for payload in ({"ids": [1], "model": "c"}, {"ids": [1]}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(port, payload)
            assert ei.value.code == 404
        assert srv.load()["models"] == ["a", "b"]
    finally:
        srv.stop()
