"""The port's Transformer NMT against the JAX package's, on the same
parameters (carried across with `params_from_numpy`) and the same numpy
batches, on `TransformerConfig.tiny()`.

On the CPU both run attention on their plain paths (`_xla_mha` and its
mirror); the CUDA kernels are held against those plain versions on the
card (`tests/test_torch_cuda.py`, `chip_smoke.py`).

Tolerances:
- f32 `encode` and `decode` outputs within 1e-5 of the largest
  reference value (at least 1), losses within 1e-5 relative, every
  gradient within 1e-4 of its largest reference value (at least 1):
  the same f32 arithmetic through 2 + 2 layers, summed in other orders
  by XLA and torch;
- bf16 (cfg.dtype "bfloat16", f32 params): logits within 2e-2 of the
  largest reference value and losses within 2e-4 relative. bf16 rounds
  at other points in XLA and torch (jax.nn.gelu rounds after every
  elementwise op on the CPU, F.gelu once; see tests/test_torch_gpt.py),
  so activations differ by a few bf16 steps (2^-8 relative each);
  measured on three batches: logits 3.9e-3 to 5.9e-3, losses 6e-6 to
  2.8e-5 (the f32 loss averages the steps out);
- a 10-step f32 Adam(1e-4) trajectory through `make_train_step`: each
  loss within 1e-5 relative, as tests/test_torch_train.py holds BERT's;
- beam search and greedy decoding at f32: tokens exactly equal, scores
  within 1e-5 relative (sums of a few f32 log-probabilities).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import transformer as jtr
from paddle_tpu.parallel import MeshConfig, make_mesh, mesh_guard
from paddle_tpu.parallel import train as jtrain

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.parallel import train as ttrain

torch.set_num_threads(2)

B, S, T = 4, 16, 12


def _cfgs(dtype="float32"):
    jcfg, tcfg = jtr.TransformerConfig.tiny(), ttr.TransformerConfig.tiny()
    jcfg.dtype = tcfg.dtype = dtype
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams, axes = jtr.init(jax.random.key(0), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    return jcfg, jparams, tcfg, params_from_numpy(np_params, "cpu"), axes


def _batch(tcfg, seed=0, batch=B, lengths=True):
    """The port's make_batch on numpy, and the same as int32 jnp arrays."""
    tb = ttr.make_batch(np.random.RandomState(seed), tcfg, batch, S, T,
                        device="cpu")
    if not lengths:
        tb = {k: tb[k] for k in ("src_ids", "tgt_ids")}
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}
    return jb, tb


def _rel(want, got):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


def test_init_names_shapes_and_axes_match_the_jax_package():
    jparams, jaxes = jtr.init(jax.random.key(1), jtr.TransformerConfig.tiny())
    tparams, taxes = ttr.init(torch.Generator().manual_seed(1),
                              ttr.TransformerConfig.tiny(), device="cpu")
    assert list(tparams) == list(jparams)
    assert taxes == jaxes
    for name, value in tparams.items():
        assert tuple(value.shape) == tuple(jparams[name].shape), name
        assert value.dtype == torch.float32
    # init scales: dense sqrt(2/(d_in+d_out)), embeddings 0.02
    w = tparams["enc0.mlp.up.w"]
    assert abs(float(w.std()) - (2.0 / (32 + 64)) ** 0.5) < 0.02
    assert abs(float(tparams["src_emb.w"].std()) - 0.02) < 0.003
    big, jbig = ttr.TransformerConfig.big(), jtr.TransformerConfig.big()
    assert dataclasses.asdict(big) == dataclasses.asdict(jbig)
    assert big.head_dim == 64
    assert big.train_flops_per_seq(128, 128) == \
        jbig.train_flops_per_seq(128, 128)


@pytest.mark.parametrize("lengths", [True, False])
def test_encode_and_decode_match(models, lengths):
    jcfg, jparams, tcfg, tparams, _ = models
    jb, tb = _batch(tcfg, seed=1, lengths=lengths)
    jsl, tsl = jb.get("src_len"), tb.get("src_len")
    jmem = jax.jit(lambda p, ids, sl: jtr.encode(p, jcfg, ids, sl))(
        jparams, jb["src_ids"], jsl)
    tmem = ttr.encode(tparams, tcfg, tb["src_ids"], tsl)
    assert tmem.dtype == torch.float32 and tmem.shape == (B, S, tcfg.hidden)
    assert _rel(jmem, tmem) <= 1e-5
    jlog = jax.jit(lambda p, ids, mem, sl: jtr.decode(p, jcfg, ids, mem,
                                                      sl))(
        jparams, jb["tgt_ids"][:, :-1], jmem, jsl)
    tlog = ttr.decode(tparams, tcfg, tb["tgt_ids"][:, :-1], tmem, tsl)
    assert tlog.shape == (B, T, tcfg.tgt_vocab)
    assert _rel(jlog, tlog) <= 1e-5


@pytest.mark.parametrize("lengths,smoothing", [(True, 0.1), (False, 0.1),
                                               (True, 0.0)])
def test_nmt_loss_and_grads_match(models, lengths, smoothing):
    jcfg, jparams, tcfg, _, _ = models
    jb, tb = _batch(tcfg, seed=2, lengths=lengths)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.nmt_loss(p, jcfg, jb, label_smoothing=smoothing)))(
        jparams)
    tparams = params_from_numpy({k: np.asarray(v)
                                 for k, v in jparams.items()}, "cpu")
    for v in tparams.values():
        v.requires_grad_()
    tloss = ttr.nmt_loss(tparams, tcfg, tb, label_smoothing=smoothing)
    tgrads = torch.autograd.grad(tloss, list(tparams.values()))
    assert tloss.dtype == torch.float32 and tloss.ndim == 0
    assert abs(float(jloss) - tloss.item()) <= 1e-5 * abs(float(jloss))
    for (name, _), g in zip(tparams.items(), tgrads):
        assert _rel(jgrads[name], g) <= 1e-4, name


def test_bf16_loss_and_logits_match_within_bf16_steps(models):
    _, jparams, _, tparams, _ = models
    jcfg, tcfg = _cfgs("bfloat16")
    jb, tb = _batch(tcfg, seed=3)
    jmem = jtr.encode(jparams, jcfg, jb["src_ids"], jb["src_len"])
    tmem = ttr.encode(tparams, tcfg, tb["src_ids"], tb["src_len"])
    assert tmem.dtype == torch.bfloat16
    jlog = jtr.decode(jparams, jcfg, jb["tgt_ids"][:, :-1], jmem,
                      jb["src_len"])
    tlog = ttr.decode(tparams, tcfg, tb["tgt_ids"][:, :-1], tmem,
                      tb["src_len"])
    assert _rel(jlog.astype(jnp.float32), tlog) <= 2e-2
    jloss = float(jtr.nmt_loss(jparams, jcfg, jb))
    tloss = ttr.nmt_loss(tparams, tcfg, tb).item()
    assert abs(jloss - tloss) <= 2e-4 * abs(jloss)


def test_adam_trajectory_matches_the_jax_train_step(models):
    jcfg, _, tcfg, _, axes = models
    jparams, _ = jtr.init(jax.random.key(4), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    jb, tb = _batch(tcfg, seed=4)
    steps = 10
    mesh = make_mesh(MeshConfig(dp=-1), devices=jax.devices()[:1])
    want = []
    with mesh_guard(mesh):
        init, step = jtrain.make_train_step(
            lambda p, b, r: jtr.nmt_loss(p, jcfg, b, rng=r),
            optax.adam(1e-4), mesh, axes, precision="f32")
        state = init({k: jnp.asarray(v) for k, v in np_params.items()})
        for i in range(steps):
            state, loss = step(state, jb, jax.random.key(i))
            want.append(float(loss))
    tinit, tstep = ttrain.make_train_step(
        lambda p, b, g: ttr.nmt_loss(p, tcfg, b, rng=g),
        lambda ps: torch.optim.Adam(ps, lr=1e-4), device="cpu",
        precision="f32")
    tstate = tinit(params_from_numpy(np_params, "cpu"))
    got = []
    for i in range(steps):
        tstate, loss = tstep(tstate, tb, i)
        got.append(loss.item())
    for i, (w, g) in enumerate(zip(want, got)):
        assert abs(w - g) <= 1e-5 * abs(w), (i, w, g)
    assert got[-1] < got[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_search_and_greedy_match_the_jax_package(seed):
    jcfg, tcfg = _cfgs()
    jparams, _ = jtr.init(jax.random.key(10 + seed), jcfg)
    tparams = params_from_numpy({k: np.asarray(v)
                                 for k, v in jparams.items()}, "cpu")
    jb, tb = _batch(tcfg, seed=10 + seed)
    for K, L in ((4, 10), (3, 7)):
        jt, js = jtr.beam_search(jparams, jcfg, jb["src_ids"], jb["src_len"],
                                 beam_size=K, max_len=L)
        tt, ts = ttr.beam_search(tparams, tcfg, tb["src_ids"], tb["src_len"],
                                 beam_size=K, max_len=L)
        assert tt.shape == (B, K, L) and ts.shape == (B, K)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    jg = jtr.greedy_decode(jparams, jcfg, jb["src_ids"], jb["src_len"],
                           max_len=9)
    tg = ttr.greedy_decode(tparams, tcfg, tb["src_ids"], tb["src_len"],
                           max_len=9)
    np.testing.assert_array_equal(np.asarray(jg), tg.numpy())


def test_ties_break_to_the_lower_index_as_lax_top_k():
    """A beam step's candidates with a finished beam (only eos, the rest
    at -1e9) and dead beams (-1e9 + logp, which rounds to -1e9 in f32):
    most candidates tie, and the port picks among them as lax.top_k
    does, as it orders the final scores as jnp.argsort."""
    K, V, eos = 4, 16, 1
    rs = np.random.RandomState(0)
    logp = np.log(rs.dirichlet(np.ones(V), size=(2, K))).astype(np.float32)
    scores = np.array([[-3.0, -1e9, -1e9, -1e9],
                       [-2.0, -4.0, -1e9, -1e9]], np.float32)
    finished = np.array([[True, False, False, False],
                         [False, True, False, False]])
    eos_only = np.full(V, -1e9, np.float32)
    eos_only[eos] = 0.0
    step = np.where(finished[..., None], eos_only, logp)
    cand = (scores[..., None] + step).reshape(2, K * V)
    assert (cand == np.float32(-1e9)).sum() > K * V    # ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(cand), K)
    got_v, got_i = ttr.stable_top_k(torch.from_numpy(cand), K)
    np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
    np.testing.assert_array_equal(np.asarray(want_v), got_v.numpy())
    # bare topk makes no such promise; the stable sort does
    norm = np.array([[-1.0, -2.0, -1.0, -1.0]], np.float32)
    np.testing.assert_array_equal(
        np.asarray(jnp.argsort(-jnp.asarray(norm), axis=1)),
        torch.sort(-torch.from_numpy(norm), dim=1, stable=True).indices)


def test_beam_search_ties_through_a_degenerate_model():
    """Every target token but eos has the same embedding row, so every
    step's non-eos log-probabilities tie exactly in both frameworks: the
    beams pick them by index, as the JAX package's beam search does."""
    jcfg, tcfg = _cfgs()
    jparams, _ = jtr.init(jax.random.key(5), jcfg)
    np_params = {k: np.array(v) for k, v in jparams.items()}
    emb = np_params["tgt_emb.w"]
    emb[:] = emb[3]
    emb[jcfg.eos_id] *= -1.0
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    tparams = params_from_numpy(np_params, "cpu")
    jb, tb = _batch(tcfg, seed=5, batch=2)
    logits = ttr.decode(tparams, tcfg, tb["tgt_ids"][:, :4],
                        ttr.encode(tparams, tcfg, tb["src_ids"]))
    noneos = torch.cat([logits[..., :1], logits[..., 2:]], dim=-1)
    assert (noneos == noneos[..., :1]).all()            # exact ties
    jt, js = jtr.beam_search(jparams, jcfg, jb["src_ids"], jb["src_len"],
                             beam_size=4, max_len=6)
    tt, ts = ttr.beam_search(tparams, tcfg, tb["src_ids"], tb["src_len"],
                             beam_size=4, max_len=6)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


def test_beam_search_finished_beams_freeze(models):
    """Counterpart of tests/test_transformer_nmt.py's: after a beam's
    first eos, every later token is eos."""
    _, _, tcfg, tparams, _ = models
    _, tb = _batch(tcfg, seed=6)
    toks, scores = ttr.beam_search(tparams, tcfg, tb["src_ids"][:2],
                                   tb["src_len"][:2], beam_size=3,
                                   max_len=10)
    t = toks.numpy()
    for b in range(t.shape[0]):
        for k in range(t.shape[1]):
            eos_pos = np.where(t[b, k] == tcfg.eos_id)[0]
            if eos_pos.size:
                assert (t[b, k, eos_pos[0]:] == tcfg.eos_id).all()
    assert (scores[:, :-1] >= scores[:, 1:]).all()       # best first


def test_padding_mask_blocks_encoder(models):
    """Counterpart of tests/test_transformer_nmt.py's: padded source
    positions do not move the visible ones."""
    _, _, tcfg, tparams, _ = models
    src = torch.full((2, 8), 5, dtype=torch.long)
    lens = torch.tensor([4, 8])
    m1 = ttr.encode(tparams, tcfg, src, lens)
    src2 = src.clone()
    src2[0, 4:] = 7
    m2 = ttr.encode(tparams, tcfg, src2, lens)
    torch.testing.assert_close(m1[0, :4], m2[0, :4], atol=1e-6, rtol=0)
    assert not torch.allclose(m1[0, 4:], m2[0, 4:])


def test_masked_attention_takes_the_plain_path_on_cpu(models):
    """On the CPU every attention call of the model is the plain mirror
    of `_xla_mha`; no kernel wrapper runs."""
    _, _, tcfg, tparams, _ = models
    _, tb = _batch(tcfg, seed=7)
    tattn.GATE_COUNTS.clear()
    ttr.nmt_loss(tparams, tcfg, tb)
    L = tcfg.enc_layers + 2 * tcfg.dec_layers
    assert dict(tattn.GATE_COUNTS) == {"plain": L}


@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_make_batch_shapes_and_ranges(source):
    cfg = ttr.TransformerConfig.tiny()
    rng = (np.random.RandomState(0) if source == "numpy"
           else torch.Generator().manual_seed(0))
    b = ttr.make_batch(rng, cfg, 64, src_T=10, tgt_T=8, device="cpu")
    assert b["src_ids"].shape == (64, 10) and b["tgt_ids"].shape == (64, 9)
    assert all(v.dtype == torch.int64 and v.device.type == "cpu"
               for v in b.values())
    assert (b["tgt_ids"][:, 0] == cfg.bos_id).all()
    assert b["src_ids"].min() >= 2 and b["src_ids"].max() < cfg.src_vocab
    assert b["tgt_ids"][:, 1:].min() >= 2
    assert b["tgt_ids"].max() < cfg.tgt_vocab
    assert b["src_len"].min() >= 5 and b["src_len"].max() <= 10
    assert b["tgt_len"].min() >= 4 and b["tgt_len"].max() <= 8
    assert len(set(b["src_len"].tolist())) > 1      # ragged
