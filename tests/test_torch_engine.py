"""The port's continuous-batching decode engine, on the CPU.

Its greedy tokens are held against the JAX package's DecodeEngine on
the same parameters, and the scheduler's own contract (the JAX
package's tests/test_decode.py, ported) is checked: decode equals the
full forward, continuous batching is invisible to a sequence,
preemption is transparent, finish reasons, queue-full rejection.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine

from paddle_tpu_torch.analysis import AnalysisError
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                      QueueFullError, ServerClosed)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig.tiny()
    jcfg.dtype = "float32"  # exactness vs the full-forward reference
    jparams, _ = jgpt.init(jax.random.key(0), jcfg)
    cfg = gpt.GPTConfig.tiny()
    cfg.dtype = "float32"
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               "cpu", expected=gpt.param_shapes(cfg))
    return params, cfg, jparams, jcfg


def make_engine(model, **kw):
    params, cfg = model[:2]
    base = dict(block_size=8, num_blocks=64, decode_slots=(4,),
                prefill_buckets=(8,), precision="f32", max_len=64)
    base.update(kw)
    return DecodeEngine(params, cfg, DecodeConfig(**base), device="cpu")


@pytest.fixture(scope="module")
def engine(model):
    eng = make_engine(model)
    yield eng
    eng.stop()


def _wait_active(eng, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if eng.status()["active"]:
            return
        time.sleep(0.002)
    raise AssertionError("engine never admitted the request")


def _top2_margin(jparams, jcfg, seq):
    logits = np.asarray(jgpt.apply(jparams, jcfg,
                                   jnp.asarray([seq], jnp.int32)))[0, -1]
    top = np.sort(logits.astype(np.float64))[-2:]
    return float(top[1] - top[0])


def test_greedy_tokens_match_jax_engine(model):
    """3 concurrent prompts x 12 tokens through both engines. A token
    may differ only where the JAX full forward's top-2 logit margin is
    under 1e-4 (a near-tie that summation order can flip); later tokens
    then follow different prefixes and are not compared."""
    params, cfg, jparams, jcfg = model
    kw = dict(block_size=8, num_blocks=64, decode_slots=(4,),
              prefill_buckets=(8, 16), precision="f32", max_len=64)
    prompts = [list(np.random.RandomState(s).randint(0, 512, size=n))
               for s, n in ((0, 5), (1, 11), (2, 16))]
    jeng = JDecodeEngine(jparams, jcfg, JDecodeConfig(**kw))
    teng = DecodeEngine(params, cfg, DecodeConfig(**kw), device="cpu")
    try:
        jh = [jeng.submit(p, max_new_tokens=12) for p in prompts]
        th = [teng.submit(p, max_new_tokens=12) for p in prompts]
        jtoks = [[int(t) for t in h.result(timeout_s=300)] for h in jh]
        ttoks = [h.result(timeout_s=300) for h in th]
    finally:
        jeng.stop()
        teng.stop()
    for prompt, want, got in zip(prompts, jtoks, ttoks):
        assert len(want) == len(got) == 12
        for i, (a, b) in enumerate(zip(want, got)):
            if a != b:
                margin = _top2_margin(jparams, jcfg, prompt + want[:i])
                assert margin < 1e-4, (
                    f"token {i} differs ({a} vs {b}) at top-2 margin "
                    f"{margin}")
                break


def test_decode_matches_full_forward(model, engine):
    """The paged decode path (prefill + block-table attention steps)
    produces exactly the greedy tokens of the full forward."""
    params, cfg = model[:2]
    prompt = [1, 2, 3, 4, 5]
    got = engine.submit(prompt, max_new_tokens=6).result(timeout_s=120)
    seq = list(prompt)
    want = []
    for _ in range(6):
        logits = gpt.apply(params, cfg, torch.tensor([seq]))
        t = int(logits[0, -1].argmax())
        want.append(t)
        seq.append(t)
    assert got == want


def test_admit_mid_decode_bit_identical(engine):
    """Sequence A's tokens are the same whether it decodes alone or a
    second request joins the running batch mid-generation."""
    solo = engine.submit([1, 2, 3, 4],
                         max_new_tokens=12).result(timeout_s=120)
    hA = engine.submit([1, 2, 3, 4], max_new_tokens=12)
    time.sleep(0.02)  # let A's decode get going before B arrives
    hB = engine.submit([9, 9], max_new_tokens=6)
    assert hA.result(timeout_s=120) == solo
    assert len(hB.result(timeout_s=120)) == 6


def test_retirement_frees_blocks(engine):
    total = engine.kv_cfg.usable_blocks
    engine.submit([1, 2, 3], max_new_tokens=30).result(timeout_s=120)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if engine.status()["kv"]["blocks_free"] == total:
            break
        time.sleep(0.01)
    st = engine.status()
    assert st["kv"]["blocks_free"] == total
    assert st["kv"]["blocks_used"] == 0 and st["active"] == 0


def test_finish_reasons(model):
    """max_new_tokens exhaustion reports "length"; sampling the
    configured eos id reports "eos" and stops at once."""
    probe = make_engine(model)
    toks = probe.submit([1, 2, 3], max_new_tokens=3).result(timeout_s=120)
    h = probe.submit([1, 2, 3], max_new_tokens=3)
    assert h.result(timeout_s=120) == toks
    assert h.info["finish_reason"] == "length"
    assert h.info["ttft_s"] > 0 and h.info["n_tokens"] == 3
    probe.stop()
    eos_eng = make_engine(model, eos_id=toks[0])
    h = eos_eng.submit([1, 2, 3], max_new_tokens=10)
    assert h.result(timeout_s=120) == [toks[0]]
    assert h.info["finish_reason"] == "eos"
    eos_eng.stop()


def test_submit_validation(engine):
    with pytest.raises(ValueError):
        engine.submit([], max_new_tokens=4)
    with pytest.raises(ValueError):
        engine.submit([1] * 9, max_new_tokens=4)     # > largest bucket
    with pytest.raises(ValueError):
        engine.submit([999999], max_new_tokens=4)    # out of vocab
    with pytest.raises(ValueError):
        engine.submit([1, 2], max_new_tokens=0)


def test_queue_full_rejects(model):
    """With the drain-between-batches scheduler holding one long
    generation, the bounded waiting queue fills and the next submit
    raises QueueFullError; after stop() submits raise ServerClosed."""
    eng = make_engine(model, static_batching=True, decode_slots=(1,),
                      max_queue=1, max_len=64)
    a = eng.submit([1, 2, 3], max_new_tokens=50)     # long generation
    _wait_active(eng)                                # A holds the slot
    eng.submit([4, 5], max_new_tokens=2)             # waits (static)
    with pytest.raises(QueueFullError):
        eng.submit([6, 7], max_new_tokens=2)
    assert a.result(timeout_s=120)
    assert eng.status()["requests"]["rejected"] == 1
    eng.stop()
    with pytest.raises(ServerClosed):
        eng.submit([1], max_new_tokens=1)


def test_preemption_recompute_is_transparent(model):
    """When the pool runs dry mid-decode the youngest sequence is
    preempted and re-prefilled later; emitted tokens are exactly the
    no-pressure run's, with no duplicates and no gaps."""
    kw = dict(block_size=4, num_blocks=12, decode_slots=(2,),
              prefill_buckets=(8, 40), max_len=40)
    eng = make_engine(model, **kw)
    ref_a = eng.submit([1, 2, 3, 4], max_new_tokens=24).result(
        timeout_s=120)
    ref_b = eng.submit([5, 6, 7], max_new_tokens=24).result(timeout_s=120)
    # concurrent: 2 growing sequences need 2*ceil(28/4)=14 > 11 blocks
    hA = eng.submit([1, 2, 3, 4], max_new_tokens=24)
    hB = eng.submit([5, 6, 7], max_new_tokens=24)
    assert hA.result(timeout_s=180) == ref_a
    assert hB.result(timeout_s=180) == ref_b
    assert eng.status()["requests"]["preempted"] > 0
    eng.stop()


def test_block_boundary_admit_after_retire(model):
    """A request admitted on the retire path whose prompt length is an
    exact block multiple gets its next block before the dispatch."""
    eng = make_engine(model, decode_slots=(1,), prefill_buckets=(8,),
                      block_size=8, num_blocks=32, max_len=64)
    prompt_b = [7, 1, 3, 5, 2, 6, 4, 1]        # len == block_size
    solo = eng.submit(prompt_b, max_new_tokens=10).result(timeout_s=120)
    hA = eng.submit([1, 2, 3], max_new_tokens=20)
    _wait_active(eng)
    hB = eng.submit(prompt_b, max_new_tokens=10)
    hA.result(timeout_s=120)
    assert hB.result(timeout_s=120) == solo
    eng.stop()


def test_engine_runs_on_cuda_unless_told_cpu(model):
    """No silent CPU fallback: without device="cpu" the engine asks for
    cuda, and raises on a machine that has none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    params, cfg = model[:2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(params, cfg, DecodeConfig(precision="f32",
                                               max_len=64))


def test_engine_refuses_moe_and_bad_precision(model, monkeypatch):
    """An MoE config is a boot-validation error, as in the JAX engine:
    AnalysisError at PADDLE_TPU_VALIDATE=2; below it the engine
    constructs, shows the error and refuses to serve."""
    params, cfg = model[:2]
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "2")
    with pytest.raises(AnalysisError, match="MoE"):
        DecodeEngine(params, gpt.GPTConfig.tiny(n_experts=2),
                     DecodeConfig(max_len=64), device="cpu")
    monkeypatch.delenv("PADDLE_TPU_VALIDATE")
    eng = DecodeEngine(params, gpt.GPTConfig.tiny(n_experts=2),
                       DecodeConfig(max_len=64), device="cpu")
    try:
        assert eng.analysis["errors"] == 1
        with pytest.raises(RuntimeError, match="MoE"):
            eng.submit([1, 2, 3])
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="precision"):
        DecodeEngine(params, cfg, DecodeConfig(precision="fp8"),
                     device="cpu")


def test_bf16_engine_casts_params_and_pools(model):
    eng = make_engine(model, precision="bf16")
    try:
        assert eng.params["blk.wqkv"].dtype == torch.bfloat16
        assert eng._pools[0].dtype == torch.bfloat16
        toks = eng.submit([1, 2, 3], max_new_tokens=4).result(timeout_s=120)
        assert len(toks) == 4 and all(0 <= t < 512 for t in toks)
    finally:
        eng.stop()


def test_drain_finishes_work_and_rejects_new(model):
    eng = make_engine(model)
    try:
        h = eng.submit([1, 2, 3], max_new_tokens=10)
        assert eng.drain(timeout_s=60)
        assert len(h.result(timeout_s=10)) == 10
        assert h.info["finish_reason"] == "length"
        with pytest.raises(ServerClosed):
            eng.submit([1], max_new_tokens=1)
        assert eng.status()["draining"]
    finally:
        eng.stop()


def test_cancel_frees_slot_and_blocks(model):
    eng = make_engine(model, decode_slots=(1,), static_batching=True)
    try:
        h = eng.submit([1, 2, 3], max_new_tokens=60)
        _wait_active(eng)
        eng.cancel(h)
        toks = h.result(timeout_s=60)
        assert len(toks) < 60 and h.info["finish_reason"] == "cancelled"
        assert eng.status()["kv"]["blocks_used"] == 0
        # the slot is free again
        assert len(eng.submit([4, 5], max_new_tokens=3).result(60)) == 3
    finally:
        eng.stop()
