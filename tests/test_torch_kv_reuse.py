"""The port's KV reuse (chunked prefill, the prefix cache with
copy-on-write, speculative decoding with a draft model) against the JAX
package's, on the CPU at GPTConfig.tiny() f32.

- The copied kv_reuse core (`hash_blocks`, `accept_length`,
  `ReuseBlockAllocator`) gives the JAX package's bytes, lengths,
  returns and `stats()`, call for call.
- Every reuse engine of the port (chunked, prefix-cached cold and
  warm, self-draft and real-draft speculation, spec-only) streams the
  same greedy tokens as the port's bucketed engine, which streams the
  JAX package's bucketed engine's tokens (the JAX package's own
  `tests/test_kv_reuse.py` prompts and engine geometry).
- Eviction composes with preemption, every refcount drains, and a
  forced share diverges onto a private copy.
- The re-keyed phase grid (chunk, draft_chunk, draft_decode, verify)
  warms, counts and round-trips through a warmstart artifact. The JAX
  package's own round-trip test fails in the reference (ROADMAP F3), so
  that test holds the port's contract alone.
"""

import json
import time

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import DecodeConfig as JDecodeConfig
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import kv_reuse as jkvr

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import kv_reuse as tkvr

torch.set_num_threads(2)

# the JAX package's test geometry (tests/test_kv_reuse.py:make_engine)
BASE = dict(block_size=8, num_blocks=64, decode_slots=(4,),
            precision="f32", max_len=64)


def _port_params(jparams, cfg):
    return params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                             "cpu", expected=gpt.param_shapes(cfg))


def _tiny(seed, layers=None):
    """(port params, port cfg, JAX params, JAX cfg) of a tiny f32 GPT."""
    jcfg = jgpt.GPTConfig.tiny()
    jcfg.dtype = "float32"
    cfg = gpt.GPTConfig.tiny()
    cfg.dtype = "float32"
    if layers is not None:
        jcfg.layers = cfg.layers = layers
    jparams, _ = jgpt.init(jax.random.key(seed), jcfg)
    return _port_params(jparams, cfg), cfg, jparams, jcfg


@pytest.fixture(scope="module")
def model():
    return _tiny(0)


@pytest.fixture(scope="module")
def draft_model():
    """A different, 1-layer draft (its own seed): proposals get
    rejected, the stream must not change."""
    return _tiny(2, layers=1)


def make_engine(model, draft=None, **kw):
    params, cfg = model[:2]
    return DecodeEngine(params, cfg, DecodeConfig(**dict(BASE, **kw)),
                        draft, device="cpu")


def _prompts():
    """The JAX package's `_prompts()`: a shared 19-token prefix with
    distinct suffixes, plus sub-chunk, chunk-aligned and block-boundary
    lengths."""
    rng = np.random.RandomState(7)
    vocab = gpt.GPTConfig.tiny().vocab_size
    shared = rng.randint(0, vocab, size=(19,)).tolist()
    return [shared + rng.randint(0, vocab, size=(n,)).tolist()
            for n in (5, 2, 13)] + [[3, 1, 4], list(range(1, 9))]


def _run(eng, prompts, n=10):
    hs = [eng.submit(p, max_new_tokens=n) for p in prompts]
    return [[int(t) for t in h.result(timeout_s=180)] for h in hs]


def _served(eng, prompts, n=10):
    eng.warmup()
    try:
        return _run(eng, prompts, n)
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def jax_reference(model):
    """The JAX package's bucketed engine's greedy streams."""
    jparams, jcfg = model[2:]
    eng = JDecodeEngine(jparams, jcfg, JDecodeConfig(
        **dict(BASE, prefill_buckets=(32,))))
    return _served(eng, _prompts())


@pytest.fixture(scope="module")
def reference(model):
    """The port's bucketed engine's greedy streams: the baseline every
    reuse configuration must reproduce."""
    return _served(make_engine(model, prefill_buckets=(32,)), _prompts())


# ---------------------------------------------------------------------------
# The copied core, call for call against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_hash_blocks_bytes_equal(bs):
    rs = np.random.RandomState(bs)
    for n in (0, 3, bs, 2 * bs + 1, 61):
        toks = rs.randint(0, 50304, size=n)
        got = tkvr.hash_blocks(toks, bs)
        assert got == jkvr.hash_blocks(toks, bs)
        assert len(got) == n // bs
        # a list input hashes as its int32 array does
        assert tkvr.hash_blocks(toks.tolist(), bs) == got


def test_accept_length_equal_over_random_drafts():
    rs = np.random.RandomState(0)
    for _ in range(300):
        k = int(rs.randint(0, 6))
        out = rs.randint(0, 4, size=k + 1)
        # a draft that agrees with the outputs for a random prefix
        draft = out[:k].copy()
        cut = int(rs.randint(0, k + 1))
        draft[cut:] = rs.randint(0, 4, size=k - cut)
        assert tkvr.accept_length(draft, out) == \
            jkvr.accept_length(draft, out)


def _apply(al, op, arg):
    """One allocator call; its return, or the exception's type."""
    try:
        return getattr(al, op)(*arg)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__


def test_reuse_allocator_random_calls_match_jax():
    """A random sequence of alloc, free, register, match_prefix, incref,
    cow_alloc and the queries on both packages' ReuseBlockAllocator:
    equal returns and equal stats() after every call."""
    kw = dict(layers=1, kv_heads=1, head_dim=2, max_len=32, block_size=4,
              num_blocks=10)
    ja = jkvr.ReuseBlockAllocator(jkv.KVCacheConfig(**kw))
    ta = tkvr.ReuseBlockAllocator(tkv.KVCacheConfig(**kw))
    rs = np.random.RandomState(3)
    seqs = [rs.randint(0, 6, size=16) for _ in range(4)]
    hashes = [h for s in seqs for h in jkvr.hash_blocks(s, 4)]
    held = []           # one entry a reference, per block
    ops = []
    for _ in range(400):
        live = sorted({b for b in held})
        r = rs.rand()
        if r < 0.25:
            call = ("alloc", (int(rs.randint(0, 4)),))
        elif r < 0.45 and held:
            b = held[int(rs.randint(len(held)))]
            call = ("free", ([b],))
        elif r < 0.6 and live:
            call = ("register", (live[int(rs.randint(len(live)))],
                                 hashes[int(rs.randint(len(hashes)))]))
        elif r < 0.75:
            s = seqs[int(rs.randint(len(seqs)))]
            call = ("match_prefix",
                    (jkvr.hash_blocks(s, 4)[:int(rs.randint(1, 5))],))
        elif r < 0.82 and live:
            call = ("incref", (live[int(rs.randint(len(live)))],))
        elif r < 0.9 and live:
            call = ("cow_alloc", (live[int(rs.randint(len(live)))],))
        else:
            call = (["can_alloc", "refcount", "is_shared"][
                int(rs.randint(3))], (int(rs.randint(0, 10)),))
        op, arg = call
        want, got = _apply(ja, op, arg), _apply(ta, op, arg)
        ops.append(op)
        assert got == want, (op, arg)
        if isinstance(got, str):
            continue
        if op == "alloc":
            held.extend(got)
        elif op == "match_prefix":
            held.extend(got)
        elif op == "free":
            held.remove(arg[0][0])
        elif op == "incref":
            held.append(arg[0])
        elif op == "cow_alloc":
            held.remove(arg[0])
            held.append(got)
        assert ta.stats(live_tokens=7) == ja.stats(live_tokens=7), op
        assert ta.cached_blocks() == ja.cached_blocks()
    # every kind of call ran, and the sequence reached the LRU's evictions
    assert set(ops) >= {"alloc", "free", "register", "match_prefix",
                        "incref", "cow_alloc"}
    assert ta.evicted_total > 0 and ta.cow_total > 0 and ta.hits_total > 0


# ---------------------------------------------------------------------------
# Engines: the port's reuse engines against the bucketed engines
# ---------------------------------------------------------------------------


def test_port_bucketed_streams_equal_jax(reference, jax_reference):
    assert reference == jax_reference


# (case, config change, draft: None, "self" or "real")
REUSE_CASES = [
    ("chunked", dict(prefill_chunk=8), None),
    ("self_draft", dict(prefill_chunk=8, prefix_cache=True, spec_k=2),
     "self"),
    ("real_draft", dict(prefill_chunk=8, spec_k=3), "real"),
    ("spec_only", dict(prefill_buckets=(32,), spec_k=2), "self"),
]


@pytest.mark.parametrize("case,change,draft", REUSE_CASES,
                         ids=[c[0] for c in REUSE_CASES])
def test_reuse_engine_streams_equal_bucketed(model, draft_model, reference,
                                             jax_reference, case, change,
                                             draft):
    d = {None: None, "self": model[:2], "real": draft_model[:2]}[draft]
    eng = make_engine(model, d, **change)
    eng.warmup()
    try:
        got = _run(eng, _prompts())
        st = eng.status()
    finally:
        eng.stop()
    assert got == reference == jax_reference
    assert st["kv"]["blocks_used"] == 0
    if draft is None:
        return
    reuse = st["kv_reuse"]
    assert reuse["spec_proposed"] > 0
    assert 0.0 <= reuse["spec_accept_rate"] <= 1.0
    if draft == "self":
        # a draft equal to the target proposes the target's own tokens
        assert reuse["spec_accept_rate"] == 1.0
    runs = st["phase_runs"]
    assert runs["verify"]["eager"] > 0 and runs["draft_decode"]["eager"] > 0


def _metric(name, **labels):
    for s in metrics.snapshot()[name]["series"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s["value"]
    return 0


def test_prefix_cache_cold_and_warm_equal_bucketed(model, reference):
    """Shared-prefix prompts resolve their common full blocks from the
    cache on the second wave, which prefills only the novel suffixes;
    both waves stream the bucketed engine's tokens."""
    hits0 = _metric("paddle_tpu_prefix_cache_total", event="hit")
    eng = make_engine(model, prefill_chunk=8, prefix_cache=True)
    eng.warmup()
    try:
        cold = _run(eng, _prompts())
        chunks_cold = eng.status()["phase_runs"]["chunk"]["eager"]
        warm = _run(eng, _prompts())
        st = eng.status()
    finally:
        eng.stop()
    assert cold == reference and warm == reference
    kv = st["kv"]
    assert kv["prefix_hits_total"] > 0 and kv["blocks_reused_total"] > 0
    assert kv["blocks_cached"] > 0 and kv["blocks_used"] == 0
    # the warm wave ran fewer chunks: its reused blocks were not prefilled
    assert st["phase_runs"]["chunk"]["eager"] - chunks_cold < chunks_cold
    assert st["kv_reuse"]["prefix_cache"] is True
    assert _metric("paddle_tpu_prefix_cache_total", event="hit") - hits0 \
        == kv["prefix_hits_total"]
    assert _metric("paddle_tpu_decode_blocks_reused") \
        >= kv["blocks_reused_total"]


def test_spec_near_max_len_demotes_to_plain_rounds(model):
    """A 59-token prompt under max_len 64 (5 new tokens at most): after
    one fully accepted round at position 59 the next span would cross
    max_len - 1, so that round demotes to the plain path (the draft in
    lockstep), and the stream equals the bucketed engine's."""
    params, cfg = model[:2]
    long_p = list(range(1, 60))
    want = _served(make_engine(model, prefill_buckets=(32, 64)),
                   [long_p], n=6)
    eng = make_engine(model, (params, cfg), prefill_chunk=8,
                      prefix_cache=True, spec_k=2)
    eng.warmup()
    try:
        got = _run(eng, [long_p], n=6)
        st = eng.status()
    finally:
        eng.stop()
    assert got == want
    assert st["phase_runs"]["decode"]["eager"] > 0
    assert st["phase_runs"]["verify"]["eager"] > 0


def test_cow_forced_share_diverges_onto_private_copy(model, reference):
    """A forced share of the block the first decode write lands in: the
    write copies it first (copy-on-write, in place), the stream is
    unchanged, the ORIGINAL block's rows are bit for bit what they
    were, and the forced reference is still accounted."""
    eng = make_engine(model, prefill_chunk=8, prefix_cache=True)
    eng.warmup()
    prompt = _prompts()[1]      # 21 tokens: position 21 is in block 2
    state = {}
    orig_pump = eng._pump_chunk

    def pump_then_share():
        orig_pump()
        for r in eng._active:
            if not state and r.pos == len(r.prompt):
                blk = r.blocks[r.pos // eng.kv_cfg.block_size]
                eng._alloc.incref(blk)
                kp, vp = eng._pools
                state["snap"] = (blk, kp[:, blk].clone(), vp[:, blk].clone(),
                                 kp.data_ptr())

    eng._pump_chunk = pump_then_share
    try:
        got = _run(eng, [prompt])[0]
        blk, k0, v0, ptr = state["snap"]
        assert got == reference[1]
        assert eng._alloc.cow_total >= 1
        assert eng.status()["kv"]["cow_total"] >= 1
        kp, vp = eng._pools
        assert kp.data_ptr() == ptr         # copied in place, not rebound
        assert torch.equal(kp[:, blk], k0) and torch.equal(vp[:, blk], v0)
        assert eng._alloc.refcount(blk) == 1
        eng._alloc.free([blk])
        assert eng._alloc.refcount(blk) == 0
    finally:
        eng._pump_chunk = orig_pump
        eng.stop()


def test_eviction_composes_with_preemption(model):
    """Pool pressure with a populated cache: LRU eviction reclaims the
    parked blocks, then recompute preemption: the tokens are the
    no-pressure run's, every refcount drains, and a cancelled request
    releases its reservation too."""
    eng = make_engine(model, block_size=4, num_blocks=12, decode_slots=(2,),
                      prefill_chunk=4, prefix_cache=True, max_len=40)
    eng.warmup()
    try:
        eng.submit(list(range(10, 19)), max_new_tokens=2).result(
            timeout_s=120)
        assert eng.status()["kv"]["blocks_cached"] >= 2
        ref_a = _run(eng, [[1, 2, 3, 4]], n=24)[0]
        ref_b = _run(eng, [[5, 6, 7]], n=24)[0]
        # two sequences growing to 28 tokens need 14 blocks of 11
        with eng._cv:
            got = [eng.submit(p, max_new_tokens=24)
                   for p in ([1, 2, 3, 4], [5, 6, 7])]
        assert [h.result(timeout_s=180) for h in got] == [ref_a, ref_b]
        st = eng.status()
        assert st["kv"]["evictions_total"] >= 2
        assert st["requests"]["preempted"] >= 1
        assert st["kv"]["blocks_used"] == 0
        h = eng.submit(list(range(20, 39)), max_new_tokens=15)
        time.sleep(0.05)
        eng.cancel(h)
        h.result(timeout_s=120)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = eng.status()
            if st["kv"]["blocks_used"] == 0 and st["active"] == 0:
                break
            time.sleep(0.01)
        assert st["kv"]["blocks_used"] == 0
        assert st["kv"]["blocks_cached"] + st["kv"]["blocks_free"] == \
            eng.kv_cfg.usable_blocks
    finally:
        eng.stop()


def test_chunked_path_admits_past_the_bucket_ceiling(model):
    """The chunk phase covers any prompt under max_len: a prompt past a
    bucketed engine's largest bucket is admitted, one of max_len is
    refused, and the bucket-coverage warning is retired."""
    bucketed = make_engine(model, prefill_buckets=(8,))
    assert bucketed.analysis["warnings"] >= 1
    with pytest.raises(ValueError, match="prefill bucket"):
        bucketed.submit([1] * 9, max_new_tokens=2)
    bucketed.stop()
    chunked = make_engine(model, prefill_chunk=8)
    assert chunked.analysis == {"errors": 0, "warnings": 0, "infos": 0}
    chunked.warmup()
    try:
        assert len(_run(chunked, [list(range(1, 40))], n=3)[0]) == 3
        with pytest.raises(ValueError, match="no room"):
            chunked.submit([1] * 64, max_new_tokens=2)
    finally:
        chunked.stop()


def test_config_validation_matches_jax(model):
    """The JAX package's test_config_validation, on both packages."""
    params, cfg, jparams, jcfg = model
    for Config in (DecodeConfig, JDecodeConfig):
        for kw in (dict(prefix_cache=True), dict(prefill_chunk=-1),
                   dict(spec_k=-2)):
            with pytest.raises(ValueError):
                Config(**kw)
    with pytest.raises(ValueError, match="draft model"):
        make_engine(model, spec_k=2, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="spec_k == 0"):
        make_engine(model, (params, cfg), prefill_buckets=(8,))


# ---------------------------------------------------------------------------
# The re-keyed phase grid and its warmstart
# ---------------------------------------------------------------------------

REUSE_KW = dict(prefill_chunk=8, prefix_cache=True, spec_k=2)


def test_reuse_grid_keys_and_status_match_jax(model):
    params, cfg, jparams, jcfg = model
    t = make_engine(model, (params, cfg), **REUSE_KW)
    j = JDecodeEngine(jparams, jcfg, JDecodeConfig(**dict(BASE, **REUSE_KW)),
                      draft=(jparams, jcfg))
    try:
        assert t._phase_keys() == j._phase_keys() == [
            ("chunk", 8), ("decode", 4), ("draft_chunk", 8),
            ("draft_decode", 4), ("verify", 4)]
        ts, js = t.status(), j.status()
        assert set(js) <= set(ts)
        assert set(ts["kv"]) == set(js["kv"])
        assert ts["kv_reuse"] == js["kv_reuse"]
        assert ts["phase_grid"] == js["phase_grid"]
        assert t.load() == j.load() == (0, 0)
    finally:
        t.stop()
        j.stop()


def test_warmstart_rekeyed_grid_roundtrip(model, tmp_path, monkeypatch):
    """chunk@C replaces every prefill@T and speculation adds the draft
    and verify phases: all five warm, export with their fingerprints,
    are adopted by a fresh engine (each re-warmed on adoption, none
    again by warmup()), and serve the same tokens."""
    params, cfg = model[:2]
    cold = make_engine(model, (params, cfg), **REUSE_KW)
    assert cold.warmup() == 5
    art = str(tmp_path / "kvreuse.warmstart")
    assert cold.export_warmstart(art) == 5
    prompt = _prompts()[0]
    try:
        cold_toks = _run(cold, [prompt], n=6)
    finally:
        cold.stop()
    with open(art) as f:
        doc = json.load(f)
    assert doc["grid"] == {"decode": [4], "chunk": 8, "spec_k": 2}
    assert sorted((e["phase"], e["size"]) for e in doc["entries"]) == [
        ("chunk", 8), ("decode", 4), ("draft_chunk", 8),
        ("draft_decode", 4), ("verify", 4)]
    calls = []
    for name in ("apply_prefill_chunk", "apply_decode_step",
                 "apply_verify_step"):
        real = getattr(gpt, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(gpt, name, counted)
    warm = make_engine(model, (params, cfg), warmstart=art, **REUSE_KW)
    try:
        assert warm.warmstart_adopted == 5
        adopted = len(calls)
        assert sorted(calls) == sorted(
            ["apply_prefill_chunk"] * 2 + ["apply_decode_step"] * 2 +
            ["apply_verify_step"])
        assert warm.warmup() == 5
        assert len(calls) == adopted            # nothing warmed twice
        assert _run(warm, [prompt], n=6) == cold_toks
    finally:
        warm.stop()
    # another chunk size is another grid: its digest refuses the artifact
    other = make_engine(model, (params, cfg),
                        **dict(REUSE_KW, prefill_chunk=16))
    try:
        assert other.load_warmstart(art) == 0
    finally:
        other.stop()


def _counts(snapshot):
    """The reuse scheduler's counters from a metrics snapshot."""
    out = {}
    for name, label in (("paddle_tpu_decode_steps_total", "phase"),
                        ("paddle_tpu_decode_tokens_total", "phase"),
                        ("paddle_tpu_prefix_cache_total", "event")):
        for s in (snapshot.get(name) or {"series": []})["series"]:
            out[(name, s["labels"][label])] = s["value"]
    return out


def test_reuse_metrics_match_jax(model):
    """The same deterministic traffic (every request queued before the
    first admission) through both packages' chunked, prefix-cached,
    self-draft engines, two waves: equal streams and equal deltas of
    the phase steps (prefill, decode, draft, verify), the tokens by
    phase and the prefix-cache events, and the same accept-rate
    gauge."""
    from paddle_tpu import observability as jobs

    params, cfg, jparams, jcfg = model
    t = make_engine(model, (params, cfg), **REUSE_KW)
    j = JDecodeEngine(jparams, jcfg, JDecodeConfig(**dict(BASE, **REUSE_KW)),
                      draft=(jparams, jcfg))
    got = {}
    try:
        for name, eng, snap in (("jax", j, jobs.snapshot),
                                ("port", t, metrics.snapshot)):
            eng.warmup()
            before = _counts(snap())
            streams = []
            for _ in range(2):
                with eng._cv:
                    hs = [eng.submit(p, max_new_tokens=10)
                          for p in _prompts()]
                streams.append([[int(x) for x in h.result(timeout_s=180)]
                                for h in hs])
            after = _counts(snap())
            got[name] = (streams, {k: after[k] - before.get(k, 0)
                                   for k in after},
                         eng.status()["kv_reuse"])
    finally:
        t.stop()
        j.stop()
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]
    deltas = got["port"][1]
    assert deltas[("paddle_tpu_decode_steps_total", "verify")] > 0
    assert deltas[("paddle_tpu_prefix_cache_total", "hit")] > 0
    assert _metric("paddle_tpu_decode_spec_accept_rate") == 1.0
