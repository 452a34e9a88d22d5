"""The port's multi-tenant serving front against the JAX package's, on
the CPU: QoS tiers, weighted-fair admission, quotas and typed sheds on
the predict Batcher and on the decode engine's two loops, the typed 503
over HTTP, more predict slots, hot swap under traffic and the model
registry.

Tolerances: decode tokens are held exactly (GPTConfig.tiny() at f32
with the JAX package's weights, as test_torch_kv_reuse.py does);
predict replies against the JAX package's Predictor on the same model
dir at F32_REPLY_TOL (relative to the largest |reply|), the limit of
test_torch_predict.py. The admission order, sheds, outcome counts and
served shares are held equal.

The JAX package's own hot-swap test fails in the reference (ROADMAP
F3), so hot swap is held against the JAX Predictor's replies on the old
and the new dir and against the port's own engines, never against that
test.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.inference import AnalysisConfig as JAnalysisConfig
from paddle_tpu.inference import create_paddle_predictor as jcreate
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import events as jevents
from paddle_tpu.serving import Batcher as JBatcher
from paddle_tpu.serving import BucketPolicy as JBucketPolicy
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import Server as JServer
from paddle_tpu.serving import ServerClosed as JServerClosed
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import qos as jqos

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import events as tevents
from paddle_tpu_torch.serving import (Batcher, BucketPolicy, DecodeConfig,
                                      DecodeEngine, Engine, ModelRegistry,
                                      RegistryError, Server, ServerClosed,
                                      ServingConfig, ShedError)
from paddle_tpu_torch.serving import qos as tqos

from chip_smoke import lenet_rung_logits, lenet_rung_program, synthetic_mnist

torch.set_num_threads(2)

F32_REPLY_TOL = 1e-5

# three tiers; two normal tenants sharing their tier 3:1, a high one, a
# low one with a quota of 2, and a low one that may hold nothing
POLICY = {"tiers": ["high", "normal", "low"], "default_tier": "low",
          "tenants": {"gold": {"tier": "high"},
                      "a": {"tier": "normal", "weight": 3},
                      "b": {"tier": "normal", "weight": 1},
                      "bulk": {"tier": "low", "max_inflight": 2},
                      "capped": {"tier": "low", "max_inflight": 0}}}

JAX = dict(Batcher=JBatcher, BucketPolicy=JBucketPolicy, qos=jqos,
           DecodeEngine=JDecodeEngine, DecodeConfig=JDecodeConfig,
           events=jevents)
PORT = dict(Batcher=Batcher, BucketPolicy=BucketPolicy, qos=tqos,
            DecodeEngine=DecodeEngine, DecodeConfig=DecodeConfig,
            events=tevents)


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _tenant_counts(qos, tenants):
    """The per-tenant outcome counters of `qos`'s package, by (tenant,
    outcome)."""
    policy = qos.QoSPolicy.from_spec(POLICY)
    return {(t, o): qos.TENANT_REQUESTS.value(
        tenant=t, tier=policy.tier_of(t), outcome=o)
        for t in tenants for o in ("ok", "rejected")}


# -- the predict Batcher --------------------------------------------------

# (tenant) per arrival after the first request is in flight: the queue
# holds 4; bulk's fifth is over quota; gold and b displace the queued
# bulk requests, newest first; anon (default tier low) is its own
# victim, and so is the last a: once no low-tier request waits, the
# newest normal-tier request is the arrival
BATCHER_ARRIVALS = ["a", "b", "bulk", "bulk", "bulk", "gold", "b", "anon",
                    "a"]


def _batcher_run(pkg):
    """The arrival sequence through `pkg`'s Batcher(qos=POLICY) with one
    request held in flight: each caller's outcome, the dispatch order,
    the outcome counts, the served shares and the per-tenant metric
    deltas."""
    release = threading.Event()
    order = []

    def run_batch(feeds):
        order.append(int(feeds["x"][0, 0]))
        if len(order) == 1:
            release.wait(30)
        return {"y": feeds["x"] * 2}

    tenants = sorted(set(BATCHER_ARRIVALS))
    before = _tenant_counts(pkg["qos"], tenants)
    b = pkg["Batcher"](run_batch, pkg["BucketPolicy"](max_batch=1),
                       max_queue=4, max_wait_ms=1, timeout_s=60,
                       qos=POLICY)
    outcomes = {}

    def call(i, tenant):
        # gold's rows are 2 wide: a signature of their own (F8)
        width = 2 if tenant == "gold" else 1
        try:
            b.submit({"x": np.full((1, width), i, np.float32)},
                     tenant=tenant)
            outcomes[i] = "ok"
        except pkg["qos"].ShedError as e:
            outcomes[i] = ("shed", e.tenant, e.tier, e.kind)

    threads = []
    try:
        for i, tenant in enumerate(["a"] + BATCHER_ARRIVALS):
            t = threading.Thread(target=call, args=(i, tenant))
            t.start()
            threads.append(t)
            # the sequence, not timing, decides: the next arrival waits
            # until this one is queued (or answered)
            if i == 0:
                assert _wait(lambda: order == [0])
                continue
            assert _wait(lambda: (not t.is_alive()) or any(
                int(r.feeds["x"][0, 0]) == i for r in b._pending))
        release.set()
        for t in threads:
            t.join(30)
        after = _tenant_counts(pkg["qos"], tenants)
        return {"outcomes": outcomes, "order": order,
                "counts": b.outcome_counts(),
                "shares": b._wfq.served_shares(),
                "tenants": {k: after[k] - before[k] for k in after}}
    finally:
        release.set()
        b.stop()


def test_batcher_qos_matches_jax():
    got = {name: _batcher_run(pkg) for name, pkg in (("jax", JAX),
                                                     ("port", PORT))}
    assert got["port"] == got["jax"]
    out = got["port"]["outcomes"]
    # the sheds the policy promises: quota, queued lowest-tier victims
    # newest first, arrivals that are their own victims
    assert out[5] == ("shed", "bulk", "low", "quota")
    assert out[4] == ("shed", "bulk", "low", "queue")
    assert out[3] == ("shed", "bulk", "low", "queue")
    assert out[8] == ("shed", "anon", "low", "queue")
    assert out[9] == ("shed", "a", "normal", "queue")
    assert sorted(i for i, o in out.items() if o == "ok") == [0, 1, 2, 6, 7]
    # the weighted-fair pick chooses the batch's head: gold (high) is
    # dispatched first once the held batch is done; the batch then
    # fills in arrival order among the head's signature, which is why
    # gold's rows have a signature of their own (ROADMAP F8)
    assert got["port"]["order"] == [0, 6, 1, 2, 7]


def test_batcher_without_policy_is_fifo_and_plain():
    from paddle_tpu_torch.serving import QueueFullError

    release = threading.Event()
    order = []

    def run_batch(feeds):
        order.append(int(feeds["x"][0, 0]))
        if len(order) == 1:
            release.wait(30)
        return {"y": feeds["x"]}

    b = Batcher(run_batch, BucketPolicy(max_batch=1), max_queue=1,
                max_wait_ms=1)
    ts = [threading.Thread(target=b.submit,
                           args=({"x": np.full((1, 1), i, np.float32)},),
                           kwargs={"tenant": t})
          for i, t in enumerate(["bulk", "gold"])]
    try:
        ts[0].start()
        assert _wait(lambda: order == [0])
        ts[1].start()
        assert _wait(lambda: b.depth() == 1)
        with pytest.raises(QueueFullError) as ei:
            b.submit({"x": np.full((1, 1), 9, np.float32)}, tenant="gold")
        assert not isinstance(ei.value, ShedError)
    finally:
        release.set()
        for t in ts:
            t.join(30)
        b.stop()
    assert order == [0, 1]


# -- the decode engine, both loops ----------------------------------------

def _tiny(seed):
    """(port params, port cfg, JAX params, JAX cfg) of a tiny f32 GPT."""
    jcfg = jgpt.GPTConfig.tiny()
    jcfg.dtype = "float32"
    cfg = gpt.GPTConfig.tiny()
    cfg.dtype = "float32"
    jparams, _ = jgpt.init(jax.random.key(seed), jcfg)
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               "cpu", expected=gpt.param_shapes(cfg))
    return params, cfg, jparams, jcfg


@pytest.fixture(scope="module")
def model():
    return _tiny(0)


DECODE_BASE = dict(block_size=8, num_blocks=64, decode_slots=(2,),
                   precision="f32", max_len=64, max_queue=5)
# (tenant, prompt length, new tokens): bulk's third is over quota; a,
# gold and b then displace queued low-tier requests; anon is its own
# victim
DECODE_ARRIVALS = [("a", 11, 6), ("b", 5, 9), ("bulk", 17, 4),
                   ("bulk", 3, 7), ("bulk", 9, 5), ("a", 14, 8),
                   ("b", 6, 5), ("gold", 20, 6), ("anon", 4, 3),
                   ("b", 8, 4)]


def _arrival_prompts(arrivals):
    rs = np.random.RandomState(17)
    vocab = gpt.GPTConfig.tiny().vocab_size
    return [rs.randint(0, vocab, size=n).tolist() for _, n, _ in arrivals]


def _decode_run(pkg, params, cfg, arrivals, **kw):
    """Every arrival submitted while the scheduler is held (the sequence
    decides, not timing), then served: each request's tokens or typed
    shed, the admission order (requests ordered by their admitted_at
    stamps), the preemptions (rid, tenant) and the served shares."""
    eng = pkg["DecodeEngine"](params, cfg, pkg["DecodeConfig"](
        **dict(DECODE_BASE, qos=POLICY, **kw)),
        **({"device": "cpu"} if pkg is PORT else {}))
    pkg["events"].clear()
    prompts = _arrival_prompts(arrivals)
    handles = []
    try:
        with eng._cv:
            for (tenant, _, new), p in zip(arrivals, prompts):
                try:
                    handles.append(eng.submit(p, max_new_tokens=new,
                                              tenant=tenant))
                except pkg["qos"].ShedError as e:
                    handles.append(("shed", e.tenant, e.tier, e.kind))
        out = []
        for h in handles:
            if isinstance(h, tuple):
                out.append(h)
                continue
            try:
                out.append([int(t) for t in h.result(timeout_s=180)])
            except pkg["qos"].ShedError as e:
                out.append(("shed", e.tenant, e.tier, e.kind))
        served = [h._req for h in handles if not isinstance(h, tuple)
                  and h._req.finish_reason != "rejected"]
        admitted = [r.rid for r in sorted(served,
                                          key=lambda r: r.admitted_at)]
        preempts = [(e["rid"], e["tenant"])
                    for e in pkg["events"].recent(500, kind="decode")
                    if e.get("action") == "preempt"]
        st = eng.status()
        return {"streams": out, "admitted": admitted, "preempts": preempts,
                "shares": st["qos"]["served_shares"],
                "policy": st["qos"]["policy"],
                "requests": st["requests"]}
    finally:
        eng.stop()


@pytest.mark.parametrize("loop", ["async", "sync"])
def test_decode_admission_sheds_and_tokens_match_jax(model, loop):
    """The async loop, and the synchronous loop (prefill_chunk > 0): the
    same sheds, admission order, f32 tokens and served shares as the
    JAX engine. Every request is queued before the first admission; the
    async loop's one-step-late resolve is the same in both packages, so
    its admission order is a function of the policy and the tokens."""
    params, cfg, jparams, jcfg = model
    kw = {"prefill_chunk": 8} if loop == "sync" else {}
    port = _decode_run(PORT, params, cfg, DECODE_ARRIVALS, **kw)
    ref = _decode_run(JAX, jparams, jcfg, DECODE_ARRIVALS, **kw)
    assert port == ref
    streams = port["streams"]
    assert streams[4] == ("shed", "bulk", "low", "quota")
    assert streams[3] == ("shed", "bulk", "low", "queue")
    assert streams[2] == ("shed", "bulk", "low", "queue")
    assert streams[8] == ("shed", "anon", "low", "queue")
    assert streams[9] == ("shed", "b", "normal", "queue")
    assert set(port["shares"]) == {"a", "b", "gold"}
    # no lower tier was admitted while a higher tier waited: gold's
    # request (rid 7: shed arrivals take no rid) is admitted first
    assert port["admitted"][0] == 7


# the KV-pressure case: two slots and a pool too small for both
# sequences at full length; bulk (low) is admitted before gold (high)
KV_ARRIVALS = [("bulk", 20, 40), ("gold", 18, 40), ("a", 9, 10)]


@pytest.mark.parametrize("loop", ["async", "sync"])
def test_decode_preemption_victim_is_the_lowest_tier(model, loop):
    params, cfg, jparams, jcfg = model
    kw = dict(num_blocks=12)
    if loop == "sync":
        kw["prefill_chunk"] = 8
    port = _decode_run(PORT, params, cfg, KV_ARRIVALS, **kw)
    ref = _decode_run(JAX, jparams, jcfg, KV_ARRIVALS, **kw)
    assert port == ref
    assert port["preempts"], port
    # the victim is bulk (low), although gold was admitted later
    assert {t for _, t in port["preempts"]} == {"bulk"}
    assert all(isinstance(s, list) and len(s) == n
               for s, (_, _, n) in zip(port["streams"], KV_ARRIVALS))


def test_decode_victim_key_without_policy_is_youngest_first(model):
    params, cfg = model[:2]
    eng = DecodeEngine(params, cfg, DecodeConfig(**DECODE_BASE),
                       device="cpu")
    try:
        class R:
            def __init__(self, tenant, t):
                self.tenant, self.admitted_at = tenant, t

        reqs = [R("gold", 3.0), R("bulk", 1.0), R("a", 2.0)]
        assert max(reqs, key=eng._victim_key) is reqs[0]
        assert eng._pick_waiting_locked() == 0
        assert "qos" not in eng.status()
    finally:
        eng.stop()


# -- HTTP -----------------------------------------------------------------

def _save_lenet(pt, dirname, steps):
    """The LeNet rung built with `pt`, `steps` Adam steps on the CPU,
    saved as an inference model fetching the logits."""
    main, startup, loss = lenet_rung_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    x, y = synthetic_mnist(64, seed=1)
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            exe.run(main, feed={"x": x, "y": y}, fetch_list=[loss])
        pt.io.save_inference_model(dirname, ["x"], [lenet_rung_logits(main)],
                                   exe, main_program=main)
    return dirname


@pytest.fixture(scope="module")
def lenets(tmp_path_factory):
    """Four LeNet dirs saved by the port, each after a different number
    of training steps (so their replies differ)."""
    root = tmp_path_factory.mktemp("lenets")
    return [_save_lenet(tfluid, str(root / f"m{s}"), s) for s in (1, 3, 5, 7)]


def _jax_predictor(dirname):
    cfg = JAnalysisConfig(dirname)
    cfg.disable_gpu()
    return jcreate(cfg)


def _gap(a, b):
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


def _http(port, path, payload=None, timeout=60):
    """(status, JSON body, headers) of one request."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _servers(model, lenets):
    params, cfg, jparams, jcfg = model
    dcfg = dict(block_size=8, num_blocks=64, decode_slots=(2,),
                prefill_buckets=(8, 16), precision="f32", max_len=64,
                max_queue=2, qos=POLICY)
    port = Server(ServingConfig(lenets[0], use_tpu=False, warmup=False,
                                buckets=(1, 2), qos=POLICY),
                  decode=DecodeEngine(params, cfg, DecodeConfig(**dcfg),
                                      device="cpu"))
    ref = JServer(JServingConfig(lenets[0], use_tpu=False, warmup=False,
                                 buckets=(1, 2), qos=POLICY),
                  decode=JDecodeEngine(jparams, jcfg, JDecodeConfig(**dcfg)))
    return port, ref


def test_http_typed_sheds_and_the_tenant_field_match_jax(model, lenets):
    """The tenant field on both routes, a quota shed on each, and a
    queue shed on /v1/generate: the same status, body and Retry-After as
    the JAX server's."""
    port_srv, jax_srv = _servers(model, lenets)
    x = synthetic_mnist(2, seed=3)[0].tolist()
    prompt = _arrival_prompts([("a", 7, 0)])[0]
    served = [("/v1/predict", {"feeds": {"x": x}, "tenant": "a"}),
              ("/v1/generate", {"ids": prompt, "max_new_tokens": 5,
                                "stream": False, "tenant": "gold"})]
    shed = [("/v1/predict", {"feeds": {"x": x}, "tenant": "capped"}),
            ("/v1/generate", {"ids": prompt, "tenant": "bulk",
                              "stream": False}),
            ("/v1/generate", {"ids": prompt, "tenant": "anon",
                              "stream": False})]
    got = {}
    try:
        for name, srv in (("port", port_srv), ("jax", jax_srv)):
            p = srv.start(0)
            replies = [_http(p, path, body) for path, body in served]
            dec = srv._decodes["default"]
            # hold the decode scheduler: the queue keeps what it holds
            dec._admit = lambda: False
            dec._admit_sync = lambda: None
            held = [dec.submit(prompt, max_new_tokens=2, tenant="bulk")
                    for _ in range(2)]
            sheds = [_http(p, path, body) for path, body in shed]
            st = dec.status()["qos"]
            got[name] = {
                "served": [(c, b.get("tokens"), b.get("finish_reason"))
                           for c, b, _ in replies],
                "outputs": replies[0][1]["outputs"],
                "sheds": [(c, b, h.get("Retry-After")) for c, b, h in sheds],
                "shares": st["served_shares"], "policy": st["policy"],
                "held": len(held)}
            srv.stop()
    finally:
        port_srv.stop()
        jax_srv.stop()
    port, ref = got["port"], got["jax"]
    assert port["served"] == ref["served"]
    assert port["served"][0][0] == 200 and len(port["served"][1][1]) == 5
    for name in ref["outputs"]:
        assert _gap(port["outputs"][name], ref["outputs"][name]) \
            <= F32_REPLY_TOL
    assert port["sheds"] == ref["sheds"]
    codes = [(c, b["shed"], b["kind"], b["tenant"], h)
             for c, b, h in port["sheds"]]
    assert codes == [(503, "low", "quota", "capped", "1"),
                     (503, "low", "quota", "bulk", "1"),
                     (503, "low", "queue", "anon", "1")]
    assert set(port["sheds"][0][1]) == {"error", "shed", "kind", "tenant",
                                        "retry_after_s"}
    assert port["shares"] == ref["shares"] == {"gold": 1.0}
    assert port["policy"] == ref["policy"]


# -- predict slots, hot swap, the registry --------------------------------

def _cfg(d, **kw):
    return ServingConfig(d, use_tpu=False, buckets=(1, 2, 4), **kw)


def test_server_models_route_by_model_id(lenets):
    srv = Server(_cfg(lenets[0], model_id="lenet"),
                 models={"second": _cfg(lenets[1])})
    port = srv.start(0)
    try:
        x = synthetic_mnist(3, seed=4)[0]
        for model, d in (("lenet", lenets[0]), ("second", lenets[1]),
                         (None, lenets[0])):
            body = {"feeds": {"x": x.tolist()}}
            if model is not None:
                body["model"] = model
            code, reply, _ = _http(port, "/v1/predict", body)
            assert code == 200, reply
            want = _jax_predictor(d).predict(x=x)
            for name in want:
                assert _gap(reply["outputs"][name], want[name]) \
                    <= F32_REPLY_TOL
        code, reply, _ = _http(port, "/v1/predict",
                               {"feeds": {"x": x.tolist()}, "model": "nope"})
        assert code == 404 and "nope" in reply["error"]
        code, body, _ = _http(port, "/v1/models")
        rows = {r["id"]: r for r in body["models"]}
        assert set(rows) == {"lenet", "second"}
        assert rows["lenet"]["default"] and not rows["second"]["default"]
        for mid, d in (("lenet", lenets[0]), ("second", lenets[1])):
            assert rows[mid]["kind"] == "predict" and rows[mid]["warmed"]
            assert rows[mid]["version"] is None
            assert rows[mid]["buckets"] == [1, 2, 4]
            assert rows[mid]["digest"] == Engine._digest_model_file(d)
            assert rows[mid]["requests"]["ok"] == (2 if mid == "lenet"
                                                   else 1)
        assert srv.load()["models"] == ["lenet", "second"]
        assert _http(port, "/v1/load")[1]["models"] == ["lenet", "second"]
    finally:
        srv.stop()


def _traffic(port, model, stop, log, seed):
    """Predict requests for `model` until `stop` is set: (t_start,
    t_end, rows, status, reply) each."""
    rs = np.random.RandomState(seed)
    pool = synthetic_mnist(64, seed=seed)[0]
    while not stop.is_set():
        n = int(rs.randint(1, 4))
        i = int(rs.randint(0, 60))
        rows = pool[i:i + n]
        t0 = time.monotonic()
        code, reply, _ = _http(port, "/v1/predict",
                               {"feeds": {"x": rows.tolist()},
                                "model": model})
        log.append((t0, time.monotonic(), rows, code, reply))


def _held_against(entries, wants):
    """Whether every reply equals one of the `wants` predictors'."""
    for _, _, rows, code, reply in entries:
        assert code == 200, reply
        gaps = [max(_gap(reply["outputs"][n], w.predict(x=rows)[n])
                    for n in reply["outputs"]) for w in wants]
        assert min(gaps) <= F32_REPLY_TOL, gaps


def test_hot_swap_under_traffic_loses_nothing(lenets):
    srv = Server(_cfg(lenets[0]), models={"second": _cfg(lenets[1])})
    port = srv.start(0)
    stop, log = threading.Event(), []
    workers = [threading.Thread(target=_traffic,
                                args=(port, "second", stop, log, s))
               for s in range(3)]
    try:
        for w in workers:
            w.start()
        assert _wait(lambda: len(log) >= 10)
        t_swap0 = time.monotonic()
        record = srv.hot_swap("second", model_dir=lenets[2])
        t_swap1 = time.monotonic()
        n_at_swap = len(log)
        assert _wait(lambda: len(log) >= n_at_swap + 10)
    finally:
        stop.set()
        for w in workers:
            w.join(60)
        models = {r["id"]: r for r in srv.models()}
        srv.stop()
    assert record["model"] == "second" and record["swap_s"] > 0
    assert record["digest"] == Engine._digest_model_file(lenets[2])
    assert models["second"]["digest"] == record["digest"]
    old, new = _jax_predictor(lenets[1]), _jax_predictor(lenets[2])
    before = [e for e in log if e[1] < t_swap0]
    after = [e for e in log if e[0] > t_swap1]
    during = [e for e in log if e not in before and e not in after]
    assert before and after
    assert all(e[3] == 200 for e in log)         # zero failed requests
    _held_against(before, [old])
    _held_against(after, [new])
    _held_against(during, [old, new])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_hot_swap_between_slot_lookup_and_submit(lenets, pkg):
    """ROADMAP F9: a request that looked its slot up just before a hot
    swap reaches the displaced batcher after it stopped. The swap runs
    inside the lookup here, so the order is fixed. The JAX Server
    raises ServerClosed (its HTTP route answers 503); the port's
    retries once on the slot's new batcher and answers with the new
    dir's model."""
    server, cfg, closed = ((JServer, JServingConfig, JServerClosed)
                           if pkg == "jax" else
                           (Server, ServingConfig, ServerClosed))
    srv = server(cfg(lenets[0], use_tpu=False, buckets=(1, 2, 4)),
                 models={"second": cfg(lenets[1], use_tpu=False,
                                       buckets=(1, 2, 4))})
    srv.start(0)
    lookup, swaps = srv._slot, []

    def lookup_then_swap(model):
        slot = lookup(model)
        if model == "second" and not swaps:
            swaps.append(srv.hot_swap("second", model_dir=lenets[2]))
        return slot

    srv._slot = lookup_then_swap
    x = synthetic_mnist(3, seed=5)[0]
    try:
        if pkg == "jax":
            with pytest.raises(closed):
                srv.submit({"x": x}, model="second")
        else:
            got = srv.submit({"x": x}, model="second")
            want = _jax_predictor(lenets[2]).predict(x=x)
            assert set(got) == set(want)
            for name in want:
                assert _gap(got[name], want[name]) <= F32_REPLY_TOL
        assert len(swaps) == 1
        # the next request finds the new slot in both packages
        got = srv.submit({"x": x}, model="second")
        want = _jax_predictor(lenets[2]).predict(x=x)
        for name in want:
            assert _gap(got[name], want[name]) <= F32_REPLY_TOL
    finally:
        srv.stop()


def _warmstart(d, path):
    eng = Engine(_cfg(d))
    eng.warmup()
    assert eng.export_warmstart(path) > 0
    return path


def test_registry_publish_resolve_and_refusals(lenets, tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    art = _warmstart(lenets[3], str(tmp_path / "m7.json"))
    assert reg.version("second") is None
    e1 = reg.publish("second", art, model_dir=lenets[3])
    assert e1["version"] == 1 and reg.version("second") == 1
    assert e1["model_digest"] == Engine._digest_model_file(lenets[3])
    assert reg.resolve("second")["digest"] == e1["digest"]
    e2 = reg.publish("second", art, model_dir=lenets[3])
    assert e2["version"] == 2 and e2["digest"] == e1["digest"]
    assert set(reg.models()) == {"second"}
    # an artifact baked from another program is refused
    with open(art) as f:
        other = json.load(f)
    other["model_digest"] = "0" * 64
    bad = str(tmp_path / "other.json")
    with open(bad, "w") as f:
        json.dump(other, f)
    with pytest.raises(RegistryError, match="digest mismatch"):
        reg.publish("second", bad, model_dir=lenets[3])
    with pytest.raises(RegistryError, match="not in the registry"):
        reg.resolve("nope")
    # a torn or tampered blob is refused at adoption
    with open(e2["path"], "ab") as f:
        f.write(b" ")
    with pytest.raises(RegistryError, match="fails its digest check"):
        reg.resolve("second")


def test_registry_watcher_adopts_a_published_version(lenets, tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    srv = Server(_cfg(lenets[0]), models={"second": _cfg(lenets[1])})
    port = srv.start(0)
    tevents.clear()
    try:
        srv.attach_registry(reg, poll_s=0.05)
        art = _warmstart(lenets[3], str(tmp_path / "m7.json"))
        e1 = reg.publish("second", art, model_dir=lenets[3])

        def row():
            return {r["id"]: r for r in
                    _http(port, "/v1/models")[1]["models"]}["second"]

        assert _wait(lambda: row()["version"] == 1)
        r = row()
        assert r["digest"] == Engine._digest_model_file(lenets[3])
        assert r["warmstart_adopted"] > 0
        x = synthetic_mnist(2, seed=5)[0]
        code, reply, _ = _http(port, "/v1/predict",
                               {"feeds": {"x": x.tolist()},
                                "model": "second"})
        want = _jax_predictor(lenets[3]).predict(x=x)
        assert code == 200 and all(
            _gap(reply["outputs"][n], want[n]) <= F32_REPLY_TOL
            for n in want)
        # a corrupt blob is not adopted; the watcher lives on. Blobs are
        # stored by content, so version 2's blob is version 1's file:
        # corrupt it before version 2 is published, or a poll between
        # the publish and the corruption adopts an intact version 2
        with open(e1["path"], "ab") as f:
            f.write(b" ")
        e2 = reg.publish("second", art, model_dir=lenets[3])
        assert e2["path"] == e1["path"]
        assert _wait(lambda: any(
            e.get("model") == "second"
            for e in tevents.recent(200, kind="model_swap_failed")))
        assert row()["version"] == 1
        swaps = [e for e in tevents.recent(200, kind="model_swap")]
        assert [e["version"] for e in swaps] == [1]
    finally:
        srv.stop()
    assert not srv._watch_thread
