"""The port's GPT phase functions against the JAX package's, on the same
parameters (carried across with `params_from_numpy`) and the same
inputs.

Tolerances: full-forward logits within 1e-4 and KV pools within 1e-5 at
f32 (the same f32 arithmetic summed in different orders by XLA and
torch). At bf16 each layer's written K/V agrees within 2e-2 in
relative RMS: the port's tanh GELU (F.gelu) rounds to bf16 once, while
jax.nn.gelu on the CPU rounds after every elementwise op, and the
difference grows through the layers (measured here: 0 at layer 0,
about 1e-2 at layer 3, single elements off by up to 0.03125). With a
GELU that rounds per op the same way, the bf16 pools are bit-identical
to the JAX package's, which pins everything else. Sampled tokens must
be equal.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import common as jcommon
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.beam import beam_search as jbeam
from paddle_tpu.serving import kv_cache as jkv

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import common as tcommon
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.beam import beam_search as tbeam
from paddle_tpu_torch.serving import kv_cache as tkv

torch.set_num_threads(2)

BS, NB, MAXLEN = 8, 24, 64


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt.GPTConfig.tiny()
    jcfg.dtype = "float32"
    jparams, _ = jgpt.init(jax.random.key(0), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tcfg = tgpt.GPTConfig.tiny()
    tcfg.dtype = "float32"
    tparams = params_from_numpy(np_params, "cpu",
                                expected=tgpt.param_shapes(tcfg))
    return jcfg, jparams, tcfg, tparams


def _pools(cfg, dtype, seed):
    """Random (not zero) pools, so a write to a wrong slot shows."""
    rs = np.random.RandomState(seed)
    shape = (cfg.layers, NB, BS, cfg.heads, cfg.head_dim)
    return [rs.randn(*shape).astype(np.float32) for _ in range(2)]


def _close(a, b, tol):
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               b.float().numpy()))) <= tol


def _rel_rms(a, b):
    a = np.asarray(a, np.float32)
    return float(np.linalg.norm(a - b.float().numpy()) / np.linalg.norm(a))


def _gelu_per_op(x):
    """tanh GELU rounded to x's dtype after every op, as jax.nn.gelu
    computes it on the CPU."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype)
    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return c(0.5) * x * (1 + torch.tanh(inner))


@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_layer_norm_and_gelu_match_jax(eps):
    """f32 layer norm (eps 1e-12 by default, 1e-5 in GPT's blocks) and
    the tanh GELU, on f32 inputs, within 1e-5."""
    rs = np.random.RandomState(8)
    x = (rs.randn(3, 5, 64) * 4 + 1).astype(np.float32)
    scale, bias = rs.randn(64).astype(np.float32), rs.randn(64).astype(
        np.float32)
    want = jcommon.raw_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), eps)
    got = tcommon.raw_layer_norm(torch.from_numpy(x),
                                 torch.from_numpy(scale),
                                 torch.from_numpy(bias), eps)
    assert _close(want, got, 1e-5)
    assert _close(jcommon.gelu(jnp.asarray(x)),
                  tcommon.gelu(torch.from_numpy(x)), 1e-5)


def test_init_names_shapes_and_scales():
    cfg = tgpt.GPTConfig.tiny()
    params, axes = tgpt.init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    jparams, jaxes = jgpt.init(jax.random.key(0), jgpt.GPTConfig.tiny())
    assert set(params) == set(jparams) and axes == jaxes
    for k, v in params.items():
        assert tuple(v.shape) == jparams[k].shape, k
        assert v.dtype == torch.float32
    assert torch.equal(params["blk.ln1.scale"], torch.ones(4, 64))
    assert abs(float(params["wte.w"].std()) - 0.02) < 2e-3
    # an MoE config's names, shapes and axes are the JAX package's too
    moe = tgpt.GPTConfig.tiny(n_experts=2)
    params, axes = tgpt.init(torch.Generator().manual_seed(0), moe,
                             device="cpu")
    jparams, jaxes = jgpt.init(jax.random.key(0), jgpt.GPTConfig.tiny(
        n_experts=2))
    assert set(params) == set(jparams) and axes == jaxes
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in jparams.items()} == tgpt.param_shapes(moe)


def test_apply_logits_match(models):
    jcfg, jparams, tcfg, tparams = models
    ids = np.random.RandomState(0).randint(0, 512, size=(2, 24))
    want = jgpt.apply(jparams, jcfg, jnp.asarray(ids, jnp.int32))
    got = tgpt.apply(tparams, tcfg, torch.from_numpy(ids))
    assert got.shape == (2, 24, 512) and got.dtype == torch.float32
    assert _close(want, got, 1e-4)


def _prefill_both(models, dtype):
    """The same bf16/f32 prefill through both packages; returns the JAX
    and port (token, k_pool, v_pool) and the written block ids."""
    jcfg, jparams, tcfg, tparams = models
    tdt = getattr(torch, dtype)
    jp = {k: v.astype(dtype) for k, v in jparams.items()}
    tp = {k: v.to(tdt) for k, v in tparams.items()}
    kp, vp = _pools(tcfg, dtype, seed=1)
    # a 13-token prompt edge-padded to the 16 bucket, in blocks [4, 9]
    plen, T = 13, 16
    prompt = np.random.RandomState(2).randint(0, 512, size=plen)
    ids = np.concatenate([prompt, np.full(T - plen, prompt[-1])])[None]
    bt = tkv.build_block_table([4, 9], MAXLEN // BS)
    jout = jgpt.apply_prefill(
        jp, jcfg, jnp.asarray(ids, jnp.int32), jnp.int32(plen),
        jnp.asarray(kp).astype(dtype), jnp.asarray(vp).astype(dtype),
        jnp.asarray(bt), block_size=BS, eos_id=-1)
    tk, tv = torch.from_numpy(kp).to(tdt), torch.from_numpy(vp).to(tdt)
    ttok = tgpt.apply_prefill(tp, tcfg, torch.from_numpy(ids), plen, tk, tv,
                              torch.from_numpy(bt), block_size=BS,
                              eos_id=-1)
    return jout, (ttok, tk, tv), [4, 9]


def test_prefill_matches_f32(models):
    (jtok, jk, jv), (ttok, tk, tv), _ = _prefill_both(models, "float32")
    assert int(ttok[0]) == int(np.asarray(jtok)[0])
    assert _close(jk, tk, 1e-5) and _close(jv, tv, 1e-5)


def test_prefill_matches_bf16(models):
    (jtok, jk, jv), (ttok, tk, tv), blocks = _prefill_both(models,
                                                           "bfloat16")
    assert int(ttok[0]) == int(np.asarray(jtok)[0])
    for jp, tp in ((jk, tk), (jv, tv)):
        jp = np.asarray(jp, np.float32)
        assert torch.equal(torch.from_numpy(jp).to(torch.bfloat16)[0],
                           tp[0])          # layer 0: no GELU upstream
        for l in range(jp.shape[0]):
            assert _rel_rms(jp[l, blocks], tp[l, blocks]) <= 2e-2, l


def test_prefill_bf16_bit_identical_with_per_op_gelu(models, monkeypatch):
    monkeypatch.setattr(tgpt, "gelu", _gelu_per_op)
    (jtok, jk, jv), (ttok, tk, tv), _ = _prefill_both(models, "bfloat16")
    assert int(ttok[0]) == int(np.asarray(jtok)[0])
    for jp, tp in ((jk, tk), (jv, tv)):
        assert torch.equal(
            torch.from_numpy(np.asarray(jp, np.float32)).to(torch.bfloat16),
            tp)


def test_decode_steps_match(models):
    """Three decode steps over 4 slots: two live sequences (one crossing
    a block boundary), two padded slots (token 0, position 0, all-zero
    table) as the engine pads them. Tokens equal, pools within 1e-5."""
    jcfg, jparams, tcfg, tparams = models
    kp, vp = _pools(tcfg, "float32", seed=3)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    mb = MAXLEN // BS
    bts = np.stack([tkv.build_block_table([1, 2, 3], mb),
                    tkv.build_block_table([5, 6], mb),
                    np.zeros(mb, np.int32), np.zeros(mb, np.int32)])
    ids = np.array([17, 301, 0, 0], np.int32)
    pos = np.array([14, 7, 0, 0], np.int32)
    active = np.array([1, 1, 0, 0], np.int32)
    for _ in range(3):
        jtok, jk, jv = jgpt.apply_decode_step(
            jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jk, jv,
            jnp.asarray(bts), block_size=BS, eos_id=-1)
        ttok = tgpt.apply_decode_step(
            tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos),
            tk, tv, torch.from_numpy(bts), block_size=BS, eos_id=-1)
        np.testing.assert_array_equal(np.asarray(jtok, np.int64),
                                      ttok.numpy())
        assert _close(jk, tk, 1e-5) and _close(jv, tv, 1e-5)
        ids = np.where(active, ttok.numpy(), 0).astype(np.int32)
        pos = pos + active


# (prompt length, its blocks, chunk size, chunk starts): a 21-token
# prompt in three chunks of 8 (the last ragged: 5 real, 3 padded), and
# the last chunk of a 60-token prompt over a full table, whose padded
# tail (positions 64..71) runs past the table width into the null block
CHUNK_CASES = [(21, [4, 9, 2], 8, (0, 8, 16)),
               (60, [4, 9, 2, 11, 12, 13, 14, 15], 16, (56,))]


@pytest.mark.parametrize("plen,blocks,C,starts", CHUNK_CASES,
                         ids=["three_chunks", "past_table"])
def test_prefill_chunks_match(models, plen, blocks, C, starts):
    """apply_prefill_chunk, slice after slice, against the JAX
    package's: tokens equal, pools within 1e-5 after every slice."""
    jcfg, jparams, tcfg, tparams = models
    kp, vp = _pools(tcfg, "float32", seed=4)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    prompt = np.random.RandomState(5).randint(0, 512, size=plen)
    bt = tkv.build_block_table(blocks, MAXLEN // BS)
    for start in starts:
        seg = prompt[start:start + C]
        ids = np.concatenate([seg, np.full(C - len(seg), prompt[-1])])
        ids = ids[None].astype(np.int32)
        jtok, jk, jv = jgpt.apply_prefill_chunk(
            jparams, jcfg, jnp.asarray(ids), jnp.int32(start),
            jnp.int32(plen), jk, jv, jnp.asarray(bt), block_size=BS,
            eos_id=-1)
        ttok = tgpt.apply_prefill_chunk(
            tparams, tcfg, torch.from_numpy(ids),
            torch.tensor(start, dtype=torch.int32),
            torch.tensor(plen, dtype=torch.int32), tk, tv,
            torch.from_numpy(bt), block_size=BS, eos_id=-1)
        assert ttok.shape == (1,)
        assert int(ttok[0]) == int(np.asarray(jtok)[0])
        assert _close(jk, tk, 1e-5) and _close(jv, tv, 1e-5)


def test_prefill_chunks_equal_whole_prefill(models):
    """The chunked prompt's first token equals the whole-prompt
    prefill's, and its blocks hold the same K/V (the port alone)."""
    jcfg, jparams, tcfg, tparams = models
    plen, C, blocks = 21, 8, [4, 9, 2]
    prompt = np.random.RandomState(6).randint(0, 512, size=plen)
    bt = torch.from_numpy(tkv.build_block_table(blocks, MAXLEN // BS))
    pools = [torch.zeros(tcfg.layers, NB, BS, tcfg.heads, tcfg.head_dim)
             for _ in range(4)]
    ids = np.concatenate([prompt, np.full(32 - plen, prompt[-1])])[None]
    whole = tgpt.apply_prefill(tparams, tcfg, torch.from_numpy(ids), plen,
                               pools[0], pools[1], bt, block_size=BS,
                               eos_id=-1)
    for start in range(0, plen, C):
        seg = prompt[start:start + C]
        cid = np.concatenate([seg, np.full(C - len(seg), prompt[-1])])
        tok = tgpt.apply_prefill_chunk(
            tparams, tcfg, torch.from_numpy(cid[None]),
            torch.tensor(start, dtype=torch.int32),
            torch.tensor(plen, dtype=torch.int32), pools[2], pools[3], bt,
            block_size=BS, eos_id=-1)
    assert int(tok[0]) == int(whole[0])
    t = torch.arange(plen)
    blk = bt.long()[t // BS]
    for a, b in ((pools[0], pools[2]), (pools[1], pools[3])):
        assert torch.allclose(a[:, blk, t % BS], b[:, blk, t % BS],
                              atol=1e-5, rtol=0)


# (block tables, positions, ids): four slots of W = 3, two live (one
# span crossing a block boundary) and two padded as the engine pads
# them; then two slots, one whose span runs past the table width
VERIFY_CASES = [
    ([[1, 2, 3], [5, 6], [], []], [14, 7, 0, 0],
     [[17, 4, 9], [301, 33, 2], [0, 0, 0], [0, 0, 0]]),
    ([[4, 9, 2, 11, 12, 13, 14, 15], [5, 6]], [62, 3],
     [[8, 100, 7], [44, 45, 46]]),
]


@pytest.mark.parametrize("tables,pos,ids", VERIFY_CASES,
                         ids=["padded_slots", "past_table"])
def test_verify_step_matches(models, tables, pos, ids):
    """apply_verify_step against the JAX package's (tokens equal, pools
    within 1e-5), and row j's token equal to the port's own decode step
    fed ids[:, :j+1] one at a time: verify is decode."""
    jcfg, jparams, tcfg, tparams = models
    kp, vp = _pools(tcfg, "float32", seed=7)
    mb = MAXLEN // BS
    bts = np.stack([tkv.build_block_table(t, mb) for t in tables])
    ids = np.asarray(ids, np.int32)
    pos = np.asarray(pos, np.int32)
    jtok, jk, jv = jgpt.apply_verify_step(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bts), block_size=BS, eos_id=-1)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ttok = tgpt.apply_verify_step(
        tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), tk, tv,
        torch.from_numpy(bts), block_size=BS, eos_id=-1)
    assert ttok.shape == ids.shape
    np.testing.assert_array_equal(np.asarray(jtok, np.int64), ttok.numpy())
    assert _close(jk, tk, 1e-5) and _close(jv, tv, 1e-5)
    dk, dv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    # the past-table position has no decode counterpart: decode rows
    # stop at the table's last position
    for j in range(ids.shape[1]):
        p = pos + j
        keep = p < mb * BS
        dtok = tgpt.apply_decode_step(
            tparams, tcfg, torch.from_numpy(ids[:, j]),
            torch.from_numpy(np.where(keep, p, 0).astype(np.int32)), dk, dv,
            torch.from_numpy(np.where(keep[:, None], bts, 0)),
            block_size=BS, eos_id=-1)
        np.testing.assert_array_equal(dtok.numpy()[keep],
                                      ttok.numpy()[keep, j])


@pytest.mark.parametrize("eos", [-1, 5])
def test_beam_top1_and_finished_freeze(eos):
    rs = np.random.RandomState(4)
    logp = rs.randn(4, 1, 32).astype(np.float32)
    logp[2, 0, [3, 9]] = 10.0                 # a tie breaks to index 3
    pre = np.array([[1], [5], [2], [5]], np.int64)
    want = jbeam({"pre_ids": [jnp.asarray(pre)],
                  "pre_scores": [jnp.zeros((4, 1), jnp.float32)],
                  "scores": [jnp.asarray(logp)]},
                 {"beam_size": 1, "end_id": eos}, None)
    got = tbeam(torch.from_numpy(pre), torch.zeros(4, 1),
                torch.from_numpy(logp), beam_size=1, end_id=eos)
    np.testing.assert_array_equal(np.asarray(want["selected_ids"]),
                                  got["selected_ids"].numpy())
    assert int(got["selected_ids"][2, 0]) == 3
    if eos == 5:   # a finished row keeps emitting eos
        assert got["selected_ids"][[1, 3], 0].tolist() == [5, 5]


def test_beam_search_k2_matches_jax():
    rs = np.random.RandomState(6)
    scores = rs.rand(3, 2, 16).astype(np.float32)
    scores[0, 1, 4] = scores[0, 0, 2]         # tie across beams
    pre_ids = np.array([[1, 2], [7, 3], [4, 4]], np.int64)
    pre_scores = rs.randn(3, 2).astype(np.float32)
    want = jbeam({"pre_ids": [jnp.asarray(pre_ids)],
                  "pre_scores": [jnp.asarray(pre_scores)],
                  "scores": [jnp.asarray(scores)]},
                 {"beam_size": 2, "end_id": 7, "is_accumulated": False},
                 None)
    got = tbeam(torch.from_numpy(pre_ids), torch.from_numpy(pre_scores),
                torch.from_numpy(scores), beam_size=2, end_id=7,
                is_accumulated=False)
    for key in ("selected_ids", "parent_idx"):
        np.testing.assert_array_equal(np.asarray(want[key]),
                                      got[key].numpy())
    np.testing.assert_allclose(np.asarray(want["selected_scores"]),
                               got["selected_scores"].numpy(), atol=1e-6)
