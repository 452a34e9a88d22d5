"""The port's HTTP token-serving front end, end to end on the CPU:
streamed and non-streamed /v1/generate, /v1/status, 400s, the 503 on a
full queue, and cancellation when a streaming client hangs up."""

import json
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt
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
