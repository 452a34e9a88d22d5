"""The port's decode engine at boot and in operation, on the CPU, held
against the JAX package's DecodeEngine on the same tiny GPT: boot
validation's findings (the KV-reuse knobs' and the draft model's too),
the warm phase grid's count (bucketed and re-keyed by KV reuse) and the
greedy tokens after it, `load()` and `status()`, and warmstart
artifacts."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.analysis import AnalysisError as JAnalysisError
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine

from paddle_tpu_torch.analysis import AnalysisError
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import events
from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

torch.set_num_threads(2)

# max_len 64 with buckets up to it and a pool that holds every slot at
# full length: no finding
BASE = dict(block_size=8, num_blocks=64, decode_slots=(4,),
            prefill_buckets=(8, 64), precision="f32", max_len=64)

# (case, config change, the word a level-2 raise names; None: no error)
BOOT_CASES = [
    ("clean", {}, None),
    ("pool_below_one_sequence", dict(num_blocks=4), "num_blocks"),
    ("pool_oversubscribed", dict(num_blocks=20), None),
    ("eos_outside_vocab", dict(eos_id=600), "eos_id"),
    ("bucket_above_max_len", dict(prefill_buckets=(8, 128)),
     "prefill_buckets"),
    ("largest_bucket_below_max_len", dict(prefill_buckets=(8, 16)), None),
    ("slot_count_below_one", dict(decode_slots=(0, 4)), "decode_slots"),
    # beyond GPTConfig.tiny()'s positional table of 128
    ("max_len_above_positional_table", dict(max_len=256), "max_len"),
    # KV reuse: "draft" names the draft model `_drafts` builds
    ("chunk_above_max_len", dict(prefill_chunk=128), "prefill_chunk"),
    # the chunk phase retires both bucket findings (here the oversized
    # bucket's error and the coverage warning); the pool's stays
    ("chunked_retires_bucket_findings",
     dict(prefill_chunk=8, prefill_buckets=(8, 128), num_blocks=20), None),
    ("draft_vocab_mismatch", dict(prefill_chunk=8, spec_k=2, draft="vocab"),
     "draft"),
    ("draft_max_len_below_serving",
     dict(prefill_chunk=8, spec_k=2, draft="short"), "draft"),
    ("spec_k_at_max_len", dict(spec_k=64, draft="same"), "spec_k"),
    # mixture-of-experts: "target" names the served model `_drafts`
    # builds; the MoE finding names no variable, its message says "MoE"
    ("moe_model", dict(target="moe"), "MoE"),
    ("moe_draft", dict(prefill_chunk=8, spec_k=2, draft="moe"), "draft"),
]

# the draft (and target) models of BOOT_CASES: (port params, port cfg,
# JAX params, JAX cfg), by name
_DRAFTS = {}


def _drafts(model, name):
    if name == "same":
        return model
    if name not in _DRAFTS:
        moe = 2 if name == "moe" else 0
        jcfg = jgpt.GPTConfig.tiny(n_experts=moe)
        jcfg.dtype = "float32"
        cfg = gpt.GPTConfig.tiny(n_experts=moe)
        cfg.dtype = "float32"
        if name == "vocab":
            jcfg.vocab_size = cfg.vocab_size = 513
        elif name == "short":
            jcfg.max_len = cfg.max_len = 32
        jparams, _ = jgpt.init(jax.random.key(2), jcfg)
        params = params_from_numpy(
            {k: np.asarray(v) for k, v in jparams.items()}, "cpu",
            expected=gpt.param_shapes(cfg))
        _DRAFTS[name] = (params, cfg, jparams, jcfg)
    return _DRAFTS[name]


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


def _split(model, kw):
    """BASE with a case's change, and the (port params, port cfg, JAX
    params, JAX cfg) of the target and of the draft it names (None
    without one)."""
    conf = dict(BASE, **kw)
    target = _drafts(model, conf.pop("target", "same"))
    name = conf.pop("draft", None)
    return conf, target, None if name is None else _drafts(model, name)


def engines(model, **kw):
    """The port's and the JAX package's engine on one config."""
    return port_engine(model, **kw), jax_engine(model, **kw)


def jax_engine(model, **kw):
    conf, target, draft = _split(model, kw)
    return JDecodeEngine(target[2], target[3], JDecodeConfig(**conf),
                         draft=draft and draft[2:])


def port_engine(model, **kw):
    conf, target, draft = _split(model, kw)
    return DecodeEngine(target[0], target[1], DecodeConfig(**conf),
                        draft and draft[:2], device="cpu")


@pytest.mark.parametrize("case,change,word", BOOT_CASES,
                         ids=[c[0] for c in BOOT_CASES])
def test_boot_analysis_matches_jax(model, monkeypatch, case, change, word):
    monkeypatch.delenv("PADDLE_TPU_VALIDATE", raising=False)
    t, j = engines(model, **change)
    try:
        assert t.analysis == j.analysis
        assert t.status()["analysis"] == j.status()["analysis"]
        assert (t.analysis["errors"] > 0) == (word is not None)
        assert (t.analysis == {"errors": 0, "warnings": 0, "infos": 0}) \
            == (case == "clean")
    finally:
        t.stop()
        j.stop()


@pytest.mark.parametrize("case,change,word", BOOT_CASES,
                         ids=[c[0] for c in BOOT_CASES])
def test_validate_level_2_raises_as_jax(model, monkeypatch, case, change,
                                        word):
    """At PADDLE_TPU_VALIDATE=2 an error finding refuses the boot in
    both packages, naming the same variable; warnings still boot."""
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "2")
    if word is None:
        t, j = engines(model, **change)
        t.stop()
        j.stop()
        return
    with pytest.raises(AnalysisError, match=word):
        port_engine(model, **change)
    with pytest.raises(JAnalysisError, match=word):
        jax_engine(model, **change)


@pytest.mark.parametrize("case,change,word",
                         [c for c in BOOT_CASES if c[2] is not None],
                         ids=[c[0] for c in BOOT_CASES if c[2] is not None])
def test_boot_error_below_level_2_refuses_to_serve(model, monkeypatch, case,
                                                  change, word):
    """Below PADDLE_TPU_VALIDATE=2 an engine with an error finding
    constructs, as the JAX engine does, and `status()` shows the error;
    it allocates no KV pool, and warmup(), start() and submit() raise
    naming the finding's variable."""
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "1")
    eng = port_engine(model, **change)
    try:
        assert eng.status()["analysis"]["errors"] == 1
        assert eng._pools is None
        for call in (eng.warmup, eng.start, lambda: eng.submit([1, 2, 3])):
            with pytest.raises(RuntimeError, match=word):
                call()
        assert eng._thread is None and not eng.warmed
    finally:
        eng.stop()


@pytest.mark.parametrize("buckets,want", [((8, 16), 4), ((8,), 3)])
def test_warmup_count_matches_jax(model, buckets, want):
    t, j = engines(model, decode_slots=(2, 4), prefill_buckets=buckets)
    try:
        assert not t.status()["warmed"]
        assert t.warmup() == j.warmup() == want
        assert t.status()["warmed"] and j.status()["warmed"]
    finally:
        t.stop()
        j.stop()


# the reuse grids: (config change, ready phases)
REUSE_GRIDS = [
    (dict(prefill_chunk=8), 3),
    (dict(prefill_chunk=8, prefix_cache=True, spec_k=2, draft="same"), 8),
    (dict(spec_k=2, draft="same"), 10),
]


@pytest.mark.parametrize("change,want", REUSE_GRIDS,
                         ids=["chunked", "chunked_spec", "spec_only"])
def test_reuse_warmup_count_matches_jax(model, change, want):
    """chunk@C replaces the prefill buckets; speculation adds
    draft_chunk or draft_prefill@T, draft_decode@S and verify@S."""
    t, j = engines(model, decode_slots=(2, 4), prefill_buckets=(8, 16),
                   **change)
    try:
        assert t._phase_keys() == j._phase_keys()
        assert t.warmup() == j.warmup() == want
        assert t.status()["phase_grid"] == j.status()["phase_grid"]
    finally:
        t.stop()
        j.stop()


@pytest.mark.parametrize("fn,kind", [("apply_prefill_chunk", "chunk"),
                                     ("apply_verify_step", "verify")])
def test_a_reuse_phase_that_fails_to_warm(model, monkeypatch, fn, kind):
    """A reuse phase that raises while warming is an ERROR finding under
    decode_trace naming the phase; warmup raises and the engine does
    not serve (no eager fallback)."""
    def broken(*a, **kw):
        raise ValueError(f"broken {kind}")

    monkeypatch.setattr(gpt, fn, broken)
    monkeypatch.delenv("PADDLE_TPU_VALIDATE", raising=False)
    eng = port_engine(model, prefill_chunk=8, spec_k=2, draft="same")
    try:
        with pytest.raises(ValueError, match=f"broken {kind}"):
            eng.warmup()
        assert eng.analysis["errors"] == 1 and not eng.warmed
        assert eng._findings[-1].pass_name == "decode_trace"
        assert eng._findings[-1].message.startswith(f"{kind}@")
        with pytest.raises(RuntimeError, match="warmup failed"):
            eng.start()
    finally:
        eng.stop()


def test_warmup_is_idempotent_and_precedes_start(model, monkeypatch):
    """A second warmup() runs no phase again; warmup() after start()
    raises; each phase ran once: every bucket's prefill, every slot
    count's step (on the CPU eagerly; nothing is captured)."""
    calls = []
    real_prefill, real_step = gpt.apply_prefill, gpt.apply_decode_step

    def prefill(*a, **kw):
        calls.append(("prefill", a[2].shape[1]))
        return real_prefill(*a, **kw)

    def step(*a, **kw):
        calls.append(("decode", a[2].shape[0]))
        return real_step(*a, **kw)

    monkeypatch.setattr(gpt, "apply_prefill", prefill)
    monkeypatch.setattr(gpt, "apply_decode_step", step)
    eng = port_engine(model, decode_slots=(2, 4), prefill_buckets=(8, 16))
    try:
        assert eng.warmup() == 4
        assert calls == [("prefill", 8), ("prefill", 16), ("decode", 4),
                         ("decode", 2)]
        assert eng.warmup() == 4
        assert len(calls) == 4
        eng.start()
        with pytest.raises(RuntimeError, match="before start"):
            eng.warmup()
    finally:
        eng.stop()


def test_a_phase_that_fails_to_warm(model, monkeypatch):
    """A phase that raises while warming is an ERROR finding under
    decode_trace; warmup raises (AnalysisError at level 2), and the
    engine does not serve."""
    def broken(*a, **kw):
        raise ValueError("broken decode step")

    monkeypatch.setattr(gpt, "apply_decode_step", broken)
    monkeypatch.delenv("PADDLE_TPU_VALIDATE", raising=False)
    eng = port_engine(model)
    try:
        with pytest.raises(ValueError, match="broken decode step"):
            eng.warmup()
        assert eng.analysis["errors"] == 1 and not eng.warmed
        with pytest.raises(RuntimeError, match="warmup failed"):
            eng.start()
    finally:
        eng.stop()
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "2")
    eng = port_engine(model)
    try:
        with pytest.raises(AnalysisError, match="decode_trace"):
            eng.warmup()
    finally:
        eng.stop()


def _top2_margin(jparams, jcfg, seq):
    logits = np.asarray(jgpt.apply(jparams, jcfg,
                                   jnp.asarray([seq], jnp.int32)))[0, -1]
    top = np.sort(logits.astype(np.float64))[-2:]
    return float(top[1] - top[0])


def test_warmed_greedy_tokens_match_jax(model):
    """Both engines warmed on decode_slots (2, 4) and buckets (8, 16),
    f32: 3 concurrent prompts x 12 tokens. A token may differ only at a
    near-tie of the JAX full forward (top-2 margin under 1e-4), as in
    tests/test_torch_engine.py; later tokens then follow different
    prefixes and are not compared."""
    jparams, jcfg = model[2:]
    t, j = engines(model, decode_slots=(2, 4), prefill_buckets=(8, 16))
    prompts = [list(np.random.RandomState(s).randint(0, 512, size=n))
               for s, n in ((0, 5), (1, 11), (2, 16))]
    try:
        assert t.warmup() == j.warmup() == 4
        jh = [j.submit(p, max_new_tokens=12) for p in prompts]
        th = [t.submit(p, max_new_tokens=12) for p in prompts]
        jtoks = [[int(x) for x in h.result(timeout_s=300)] for h in jh]
        ttoks = [h.result(timeout_s=300) for h in th]
        steps = t.status()["decode_steps"]
    finally:
        t.stop()
        j.stop()
    # the CPU captures nothing: every decode step ran eagerly
    assert steps["replayed"] == 0 and steps["eager"] > 0
    for prompt, want, got in zip(prompts, jtoks, ttoks):
        assert len(want) == len(got) == 12
        for i, (a, b) in enumerate(zip(want, got)):
            if a != b:
                margin = _top2_margin(jparams, jcfg, prompt + want[:i])
                assert margin < 1e-4, (
                    f"token {i} differs ({a} vs {b}) at top-2 margin "
                    f"{margin}")
                break


def test_load_and_status_keys_match_jax(model):
    t, j = engines(model, decode_slots=(2,))
    try:
        assert t.load() == j.load() == (0, 0)
        assert set(j.status()) <= set(t.status())
        assert set(t.status()["kv"]) == set(j.status()["kv"])
        assert set(t.status()["requests"]) == set(j.status()["requests"])
        # holding the scheduler's lock keeps it from admitting: three
        # submits are all queued
        with t._cv:
            handles = [t.submit([1, 2, 3], max_new_tokens=4)
                       for _ in range(3)]
            assert t.load() == (3, 0)
        for h in handles:
            assert len(h.result(timeout_s=120)) == 4
        assert t.load() == (0, 0)
        assert t.status()["requests"]["length"] == 3
    finally:
        t.stop()
        j.stop()


def _events_since(seq, kind):
    return [e for e in events.recent(1000, kind=kind) if e["seq"] > seq]


def _last_seq():
    recent = events.recent(1)
    return recent[-1]["seq"] if recent else 0


def test_warmstart_round_trip_adopts_every_phase(model, tmp_path,
                                                 monkeypatch):
    art = str(tmp_path / "decode.warmstart")
    cold = port_engine(model, decode_slots=(2, 4), prefill_buckets=(8, 16))
    try:
        assert cold.warmup() == 4
        assert cold.export_warmstart(art) == 4
    finally:
        cold.stop()
    with open(art) as f:
        doc = json.load(f)
    assert doc["format"] == "paddle_tpu_torch-decode-warmstart-v1"
    assert doc["device_name"] == "cpu" and doc["model_digest"]
    assert sorted((e["phase"], e["size"]) for e in doc["entries"]) == [
        ("decode", 2), ("decode", 4), ("prefill", 8), ("prefill", 16)]
    seq = _last_seq()
    warm = port_engine(model, decode_slots=(2, 4), prefill_buckets=(8, 16),
                       warmstart=art)
    try:
        assert warm.warmstart_adopted == 4
        assert warm.status()["warmstart_adopted"] == 4
        loads = _events_since(seq, "warmstart")
        assert [(e["action"], e.get("adopted")) for e in loads] == [
            ("load_decode", 4)]
        # adopted phases are warm: warmup() runs none of them again

        def never(*a, **kw):
            raise AssertionError("an adopted phase ran again")

        monkeypatch.setattr(gpt, "apply_prefill", never)
        monkeypatch.setattr(gpt, "apply_decode_step", never)
        assert warm.warmup() == 4
    finally:
        warm.stop()


def test_warmstart_rejects_a_foreign_digest_or_environment(model,
                                                           tmp_path):
    params, cfg = model[:2]
    art = str(tmp_path / "decode.warmstart")
    cold = port_engine(model)
    try:
        cold.warmup()
        cold.export_warmstart(art)
    finally:
        cold.stop()
    other = dict(params)
    other["ln_f.bias"] = other["ln_f.bias"] + 1.0
    seq = _last_seq()
    eng = DecodeEngine(other, cfg, DecodeConfig(**dict(BASE, warmstart=art)),
                       device="cpu")
    try:
        assert eng.warmstart_adopted == 0 and not eng.warmed
        rejects = _events_since(seq, "warmstart")
        assert len(rejects) == 1 and rejects[0]["action"] == "reject"
        assert "digest" in rejects[0]["reason"]
    finally:
        eng.stop()
    with open(art) as f:
        doc = json.load(f)
    doc["torch_version"] = "0.0"
    with open(art, "w") as f:
        json.dump(doc, f)
    seq = _last_seq()
    eng = port_engine(model)
    try:
        assert eng.load_warmstart(art) == 0
        rejects = _events_since(seq, "warmstart")
        assert "environment mismatch" in rejects[-1]["reason"]
    finally:
        eng.stop()


def test_warmstart_garbage_file_is_rejected_without_raising(model,
                                                            tmp_path):
    bad = tmp_path / "garbage.warmstart"
    bad.write_bytes(b"\x00\x01 not an artifact")
    seq = _last_seq()
    eng = port_engine(model, warmstart=str(bad))
    try:
        assert eng.warmstart_adopted == 0
        assert eng.load_warmstart(str(tmp_path / "missing")) == 0
        reasons = [e["reason"] for e in _events_since(seq, "warmstart")]
        assert len(reasons) == 2
        assert all(r.startswith("unreadable") for r in reasons)
    finally:
        eng.stop()
