"""The port's BERT against the JAX package's, on the same parameters
(carried across with `params_from_numpy`) and the same numpy batches,
at f32 with dropout off (`deterministic=True`: torch cannot draw
jax.random's bits).

Tolerances: `encode` output within 1e-5, losses within 1e-5 relative,
every gradient within 1e-4 of the largest reference value (at least
1): the same f32 arithmetic through two layers, summed in other orders
by XLA and torch (measured here: about 5e-6). On the CPU both run
attention on their plain paths (`_xla_mha` and its mirror); the CUDA
kernels are held against those plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import bert as jbert
from paddle_tpu.models import common as jcommon

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import common as tcommon

torch.set_num_threads(2)

B, T = 3, 32


@pytest.fixture(scope="module")
def models():
    jcfg = jbert.BertConfig.tiny()
    jcfg.dtype = "float32"
    jparams, _ = jbert.init(jax.random.key(0), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tcfg = tbert.BertConfig.tiny()
    tcfg.dtype = "float32"
    tparams = params_from_numpy(np_params, "cpu",
                                expected=tbert.param_shapes(tcfg))
    return jcfg, jparams, tcfg, tparams


def _batch(tcfg, fmt, seed=0):
    """{name: int32 numpy} for the JAX package and the same as torch."""
    rs = np.random.RandomState(seed)
    tb = tbert.make_batch(rs, tcfg, B, T, device="cpu")
    if fmt == "dense_nsp":
        labels = np.full((B, T), -100, np.int64)
        pos = tb["masked_positions"].numpy()
        np.put_along_axis(labels, pos, tb["masked_labels"].numpy(), 1)
        labels[0, pos[0, 0]] = -100     # one masked slot left out
        tb = {"input_ids": tb["input_ids"],
              "token_type_ids": torch.from_numpy(
                  (np.arange(T) >= T // 2).astype(np.int64)[None]
                  .repeat(B, 0)),
              "mlm_labels": torch.from_numpy(labels),
              "nsp_labels": tb["nsp_labels"]}
    else:
        tb.pop("nsp_labels")
        tb["masked_labels"][1, -1] = -100   # a pad slot
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}
    return jb, tb


def _rel(want, got):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("padded", [False, True])
def test_encode_matches(models, padded):
    jcfg, jparams, tcfg, tparams = models
    jb, tb = _batch(tcfg, "gathered")
    mask = None
    if padded:  # the additive -1e9 mask path (K2's on the card)
        mask = (np.arange(T)[None] < np.array([T, 20, 9])[:, None]) \
            .astype(np.int32)
    want = jax.jit(lambda p, ids, tt, m: jbert.encode(
        p, jcfg, ids, tt, m, deterministic=True))(
        jparams, jb["input_ids"], jb["token_type_ids"],
        None if mask is None else jnp.asarray(mask))
    got = tbert.encode(tparams, tcfg, tb["input_ids"], tb["token_type_ids"],
                       None if mask is None else torch.from_numpy(mask),
                       deterministic=True)
    assert got.dtype == torch.float32 and got.shape == (B, T, tcfg.hidden)
    assert _rel(want, got) <= 1e-5


@pytest.mark.parametrize("fmt", ["gathered", "dense_nsp"])
def test_pretrain_loss_and_grads_match(models, fmt):
    jcfg, jparams, tcfg, _ = models
    jb, tb = _batch(tcfg, fmt, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jbert.pretrain_loss(p, jcfg, jb, deterministic=True)))(
        jparams)
    tparams = params_from_numpy({k: np.asarray(v)
                                 for k, v in jparams.items()}, "cpu")
    for v in tparams.values():
        v.requires_grad_()
    tloss = tbert.pretrain_loss(tparams, tcfg, tb, deterministic=True)
    tgrads = torch.autograd.grad(tloss, list(tparams.values()),
                                 allow_unused=True)
    assert tloss.dtype == torch.float32
    assert abs(float(jloss) - tloss.item()) <= 1e-5 * abs(float(jloss))
    for (name, p), g in zip(tparams.items(), tgrads):
        # params the loss does not use (pooler/nsp without nsp_labels)
        # have zero gradients in the JAX package and none here
        g = torch.zeros_like(p) if g is None else g
        assert _rel(jgrads[name], g) <= 1e-4, name


def test_mlm_logits_match(models):
    jcfg, jparams, tcfg, tparams = models
    rs = np.random.RandomState(2)
    seq = rs.randn(B, 5, tcfg.hidden).astype(np.float32)
    want = jbert.mlm_logits(jparams, jcfg, jnp.asarray(seq))
    got = tbert.mlm_logits(tparams, tcfg, torch.from_numpy(seq))
    assert got.shape == (B, 5, tcfg.vocab_size)
    assert _rel(want, got) <= 1e-5


def test_init_names_shapes_and_axes_match_the_jax_package():
    jparams, jaxes = jbert.init(jax.random.key(1), jbert.BertConfig.tiny())
    tparams, taxes = tbert.init(torch.Generator().manual_seed(1),
                                tbert.BertConfig.tiny(), device="cpu")
    shapes = tbert.param_shapes(tbert.BertConfig.tiny())
    assert list(tparams) == list(jparams)
    assert taxes == jaxes
    for name, value in tparams.items():
        assert tuple(value.shape) == tuple(jparams[name].shape) \
            == shapes[name], name
        assert value.dtype == torch.float32
    # init scales: dense sqrt(2/(d_in+d_out)), embeddings 0.02
    w = tparams["layer0.mlp.up.w"]
    assert abs(float(w.std()) - (2.0 / (64 + 128)) ** 0.5) < 0.01
    assert abs(float(tparams["embeddings.word.w"].std()) - 0.02) < 0.002
    assert float(tparams["mlm.bias"].abs().max()) == 0.0


@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_make_batch(source):
    cfg = tbert.BertConfig.tiny()
    rng = np.random.RandomState(3) if source == "numpy" else \
        torch.Generator().manual_seed(3)
    b = tbert.make_batch(rng, cfg, 4, seq_len=40, device="cpu")
    P = int(0.15 * 40) + 1
    assert set(b) == {"input_ids", "token_type_ids", "masked_positions",
                      "masked_labels", "nsp_labels"}
    assert b["masked_positions"].shape == b["masked_labels"].shape == (4, P)
    pos = b["masked_positions"]
    assert bool((pos[:, 1:] > pos[:, :-1]).all())     # sorted, distinct
    assert bool((b["input_ids"].gather(1, pos) == tbert.MASK_ID).all())
    assert int(b["input_ids"].max()) < cfg.vocab_size
    assert int(b["token_type_ids"].abs().sum()) == 0
    assert set(b["nsp_labels"].tolist()) <= {0, 1}


def test_dropout_keeps_and_scales_like_the_jax_package():
    x = torch.ones(200, 200, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    y = tcommon.dropout(g, x, 0.25, deterministic=False)
    assert y.dtype == torch.bfloat16
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    want = jcommon.dropout(jax.random.key(0), jnp.ones((64,), jnp.bfloat16),
                           0.25, False)
    assert float(y[kept][0]) == float(np.asarray(want, np.float32).max())
    for det, rate, gen in ((True, 0.25, g), (False, 0.0, g),
                           (False, 0.25, None)):
        assert tcommon.dropout(gen, x, rate, det) is x


def test_dense_casts_weights_to_the_activation_dtype():
    rs = np.random.RandomState(4)
    p = {"d.w": rs.randn(8, 3).astype(np.float32),
         "d.b": rs.randn(3).astype(np.float32)}
    x = rs.randn(2, 8).astype(np.float32)
    want = jcommon.dense({k: jnp.asarray(v) for k, v in p.items()}, "d",
                         jnp.asarray(x).astype(jnp.bfloat16))
    got = tcommon.dense({k: torch.from_numpy(v) for k, v in p.items()}, "d",
                        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(want, np.float32), got.float().numpy())
    assert tcommon.is_trainable("bn.scale") and \
        not tcommon.is_trainable("bn.mean") and \
        not tcommon.is_trainable("bn.var")
