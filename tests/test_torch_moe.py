"""The port's GPT mixture-of-experts against the JAX package's, on the
CPU: `init` and `param_shapes` for an MoE config, `_moe_mlp` (Switch
top-1 routing with capacity, tokens dropped at a small capacity), the
MoE `lm_loss` and its gradients, the expert split over an in-process
ep ring, and the decode phases' refusal of MoE configs.

Params are the JAX package's, carried across with `params_from_numpy`;
inputs are numpy from a seed. Tolerances, at f32: the routing (each
token's expert) must be equal before any value is compared; the
`_moe_mlp` output within 2e-6 of its RMS per element (measured 1.02e-6
at capacity 1.25: about 3 f32 ulps at the largest outputs, from the
expert products' sum order); the loss within
1e-6 relative; each gradient's RMS difference within 1e-5 of its RMS
(the same f32 arithmetic summed in other orders by XLA and torch:
measured at most 9.6e-7). The ep split must equal the unsplit
product bit for bit: each expert's product is its own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

GRAD_TOL = 1e-5


def _configs(n_experts, capacity_factor=1.25, **kw):
    jcfg = jgpt.GPTConfig.tiny(n_experts=n_experts)
    jcfg.dtype = "float32"
    jcfg.capacity_factor = capacity_factor
    for k, v in kw.items():
        setattr(jcfg, k, v)
    return jcfg, tgpt.GPTConfig(**vars(jcfg))


def _models(n_experts, seed=0, **kw):
    jcfg, tcfg = _configs(n_experts, **kw)
    jparams, _ = jgpt.init(jax.random.key(seed), jcfg)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, "cpu",
                                expected=tgpt.param_shapes(tcfg))
    return jcfg, jparams, tcfg, tparams


def _rel_rms(want, got):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(want - got.detach().double().numpy()) /
                 np.linalg.norm(want))


def check_loss_and_grads(jloss, jgrads, tparams, tloss):
    """The port's loss and every gradient of `tparams` against the JAX
    package's, at the module's f32 tolerances."""
    assert abs(tloss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    grads = torch.autograd.grad(tloss, list(tparams.values()))
    errs = {k: _rel_rms(jgrads[k], g) for k, g in zip(tparams, grads)}
    assert set(errs) == set(jgrads)
    assert max(errs.values()) <= GRAD_TOL, errs


def test_moe_init_names_shapes_and_axes():
    cfg = tgpt.GPTConfig.tiny(n_experts=4)
    params, axes = tgpt.init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    jparams, jaxes = jgpt.init(jax.random.key(0), jgpt.GPTConfig.tiny(
        n_experts=4))
    assert set(params) == set(jparams) and axes == jaxes
    assert "blk.router" in params and "blk.b1" not in params
    shapes = tgpt.param_shapes(cfg)
    for k, v in params.items():
        assert tuple(v.shape) == jparams[k].shape == shapes[k], k
        assert v.dtype == torch.float32
    assert axes["blk.w1"] == ("layer", "expert", "embed", "mlp")
    assert abs(float(params["blk.router"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("n", [1, 256, 1024])
def test_train_flops_per_token_matches_the_jax_package(n):
    for E in (0, 8):
        assert tgpt.GPTConfig(n_experts=E).train_flops_per_token(n) == \
            jgpt.GPTConfig(n_experts=E).train_flops_per_token(n)


def _routing(x, router):
    """Each token's expert and the smallest top-2 gap of the router
    probabilities, from the JAX package's arithmetic and the port's."""
    G = x.shape[0] * x.shape[1]
    xt = x.reshape(G, -1)
    jp = jax.nn.softmax((jnp.asarray(xt) @ jnp.asarray(router)).astype(
        jnp.float32), -1)
    tp = torch.softmax((torch.from_numpy(xt) @ torch.from_numpy(router))
                       .float(), -1)
    top2 = np.sort(np.asarray(jp), -1)[:, -2:]
    return (np.asarray(jp.argmax(-1)), tp.argmax(-1).numpy(),
            float((top2[:, 1] - top2[:, 0]).min()))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_mlp_matches_the_jax_package(capacity_factor):
    """One block's MoE MLP on [4, 32] tokens at f32; at 0.25 the
    capacity (C = 8 of 128 tokens over 4 experts) drops tokens."""
    jcfg, jparams, tcfg, tparams = _models(4, seed=3,
                                           capacity_factor=capacity_factor)
    rs = np.random.RandomState(3)
    x = rs.randn(4, 32, jcfg.hidden).astype(np.float32)
    # a wider router than init's 0.02, so that every expert is chosen
    router = (rs.randn(jcfg.hidden, 4) * 0.5).astype(np.float32)
    jlp = {k: v[0] for k, v in jparams.items() if k.startswith("blk.")}
    jlp["blk.router"] = jnp.asarray(router)
    tlp = {k: v[0] for k, v in tparams.items() if k.startswith("blk.")}
    tlp["blk.router"] = torch.from_numpy(router)
    jidx, tidx, gap = _routing(x, router)
    print(f"smallest top-2 router gap {gap:.3g}")
    assert np.array_equal(jidx, tidx)
    assert len(set(jidx.tolist())) == 4
    want = np.asarray(jgpt._moe_mlp(jlp, jnp.asarray(x), jcfg))
    got = tgpt._moe_mlp(tlp, torch.from_numpy(x), tcfg).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    rms = np.sqrt((want.astype(np.float64) ** 2).mean())
    assert np.abs(got - want).max() <= 2e-6 * rms
    # the dropped tokens' rows are 0 in both
    dropped = np.all(want == 0, -1)
    C = max(1, int(capacity_factor * 128 / 4))
    kept = sum(min(C, int((jidx == e).sum())) for e in range(4))
    assert int((~dropped).sum()) == kept
    assert np.array_equal(np.all(got == 0, -1), dropped)
    assert (kept < 128) == (capacity_factor == 0.25)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_lm_loss_and_grads_match_the_jax_package(capacity_factor):
    """The 4-layer tiny MoE (4 experts) at 4 x 32 tokens: the loss and
    every gradient against jax.value_and_grad, with tokens dropped at
    capacity 0.25 (the counterpart of the JAX package's
    test_gpt_moe_capacity_drops_tokens_gracefully)."""
    jcfg, jparams, tcfg, tparams = _models(4, capacity_factor=
                                           capacity_factor)
    ids = np.random.RandomState(0).randint(0, 512, (4, 33))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.lm_loss(p, jcfg, {"ids": jnp.asarray(ids)}))(jparams)
    for v in tparams.values():
        v.requires_grad_()
    tloss = tgpt.lm_loss(tparams, tcfg, {"ids": torch.from_numpy(ids)})
    assert torch.isfinite(tloss)
    check_loss_and_grads(jloss, jgrads, tparams, tloss)


# (experts, ep): E = 3 over ep = 2 splits unevenly (2 + 1), E = 1 over
# ep = 2 leaves one rank no expert
@pytest.mark.parametrize("E,ep", [(4, 2), (4, 4), (3, 2), (1, 2)])
def test_ep_split_equals_the_unsplit_product_bit_for_bit(E, ep):
    jcfg, jparams, tcfg, tparams = _models(E, seed=1)
    for v in tparams.values():
        v.requires_grad_()
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 512, (2, 17)))
    want = tgpt.lm_loss(tparams, tcfg, {"ids": ids})
    want_g = torch.autograd.grad(want, list(tparams.values()))
    mesh = tmesh.make_mesh(tmesh.MeshConfig(dp=1, ep=ep), devices=["cpu"] *
                           ep)
    assert mesh.rings["ep"].size == ep
    with tmesh.mesh_guard(mesh):
        got = tgpt.lm_loss(tparams, tcfg, {"ids": ids})
    got_g = torch.autograd.grad(got, list(tparams.values()))
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


def test_decode_phases_refuse_moe():
    """The four decode phases refuse an MoE config before touching the
    pools, as the JAX engine refuses MoE at boot (their JAX versions
    read the dense MLP's `blk.b1`)."""
    _, _, tcfg, tparams = _models(2)
    calls = {
        "apply_prefill": lambda: tgpt.apply_prefill(
            tparams, tcfg, None, 1, None, None, None, block_size=8,
            eos_id=0),
        "apply_decode_step": lambda: tgpt.apply_decode_step(
            tparams, tcfg, None, None, None, None, None, block_size=8,
            eos_id=0),
        "apply_prefill_chunk": lambda: tgpt.apply_prefill_chunk(
            tparams, tcfg, None, None, None, None, None, None,
            block_size=8, eos_id=0),
        "apply_verify_step": lambda: tgpt.apply_verify_step(
            tparams, tcfg, None, None, None, None, None, block_size=8,
            eos_id=0)}
    for name, call in calls.items():
        with pytest.raises(ValueError, match="mixture-of-experts"):
            call()
