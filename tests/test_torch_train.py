"""The port's train step against the JAX package's `make_train_step`
(on a one-device CPU mesh), on BERT-tiny with the same parameters and
the same numpy batches, and GPT-tiny's `lm_loss`.

Tolerances:
- f32 trajectory: each of 10 losses within 1e-5 relative (adamw 1e-4,
  clip_global_norm 1.0; the same f32 arithmetic summed in other
  orders, and Adam's update of a gradient near eps can differ by up
  to lr in one element);
- mixed_bf16 trajectory: each loss within 5e-3 relative. Both compute
  in bf16 from f32 masters; bf16 rounds at other points in XLA and
  torch (jax.nn.gelu rounds after every elementwise op, F.gelu once;
  see tests/test_torch_gpt.py), a few bf16 ulps of the activations;
- GPT-tiny lm_loss within 1e-5 relative, grads within 1e-4 of the
  largest reference value;
- accum_steps=2 against one full batch, and recompute=True against
  none: params after one SGD step at lr 1 (so, the gradients) within
  1e-5 (the same f32 sums over the batch's tokens, grouped in two
  halves) and bit-identical, respectively;
- each recompute policy's 2-step f32 trajectory (losses and params)
  against no recompute at the JAX package's own limits for that
  comparison (rtol 1e-6, atol 1e-7, tests/test_models_parallel.py), and
  its losses against the JAX package's same policy within 1e-5
  relative, as the f32 trajectory above.
"""

import collections
import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core import precision as jprecision
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel import MeshConfig, make_mesh, mesh_guard
from paddle_tpu.parallel import train as jtrain

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core import precision as tprecision
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.parallel import train as ttrain

torch.set_num_threads(2)

STEPS, B, T = 10, 4, 32


def _adamw(lr=1e-4):
    # optax.adamw(lr): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
    return lambda ps: torch.optim.AdamW(ps, lr=lr, weight_decay=1e-4)


def _bert(dtype):
    jcfg, tcfg = jbert.BertConfig.tiny(), tbert.BertConfig.tiny()
    jcfg.dtype = tcfg.dtype = dtype
    jparams, axes = jbert.init(jax.random.key(0), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    return jcfg, tcfg, np_params, axes


def _batches(tcfg, n, seed=0, batch=B):
    rs = np.random.RandomState(seed)
    return [tbert.make_batch(rs, tcfg, batch, T, device="cpu")
            for _ in range(n)]


def _jax_bert_losses(jcfg, np_params, axes, batches, precision):
    mesh = make_mesh(MeshConfig(dp=-1), devices=jax.devices()[:1])

    def loss_fn(p, b, r):
        return jbert.pretrain_loss(p, jcfg, b, rng=r, deterministic=False)

    losses = []
    with mesh_guard(mesh):
        init, step = jtrain.make_train_step(
            loss_fn, optax.adamw(1e-4), mesh, axes,
            strategy=jtrain.TrainStrategy(clip_global_norm=1.0),
            precision=precision)
        state = init({k: jnp.asarray(v) for k, v in np_params.items()})
        for i, tb in enumerate(batches):
            jb = {k: jnp.asarray(v.numpy().astype(np.int32))
                  for k, v in tb.items()}
            state, loss = step(state, jb, jax.random.key(i))
            losses.append(float(loss))
    return losses


def _torch_bert_losses(tcfg, np_params, batches, precision, **strategy):
    init, step = ttrain.make_train_step(
        lambda p, b, g: tbert.pretrain_loss(p, tcfg, b, rng=g,
                                            deterministic=False),
        _adamw(), device="cpu",
        strategy=ttrain.TrainStrategy(clip_global_norm=1.0, **strategy),
        precision=precision)
    state = init(params_from_numpy(np_params, "cpu"))
    losses = []
    for i, b in enumerate(batches):
        state, loss = step(state, b, i)
        losses.append(loss.item())
    return state, losses


@pytest.mark.parametrize("precision,dtype,tol", [
    ("f32", "float32", 1e-5), ("mixed_bf16", "bfloat16", 5e-3)])
def test_bert_trajectory_matches_the_jax_train_step(precision, dtype, tol):
    jcfg, tcfg, np_params, axes = _bert(dtype)
    batches = _batches(tcfg, 1) * STEPS    # one batch, as bench.py feeds
    want = _jax_bert_losses(jcfg, np_params, axes, batches, precision)
    state, got = _torch_bert_losses(tcfg, np_params, batches, precision)
    assert state.step == STEPS
    for i, (w, g) in enumerate(zip(want, got)):
        assert abs(w - g) <= tol * abs(w), (i, w, g)
    assert got[-1] < got[0]
    if precision == "f32":
        assert state.loss_scale is None
        assert all(v.dtype == torch.float32 for v in state.params.values())
    else:  # f32 masters, clean steps: the scale has not moved
        assert state.params["layer0.attn.q.w"].dtype == torch.float32
        assert state.loss_scale == {"scale": 2.0 ** 15,
                                    "good_steps": STEPS, "overflows": 0,
                                    "growths": 0}


def _regression():
    """The JAX package's own loss-scale test problem
    (tests/test_precision.py): a linear least-squares fit."""
    r = np.random.RandomState(1)
    params = {"w": r.rand(8, 4).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    X = r.rand(16, 8).astype(np.float32)
    batch = {"x": X, "y": (X @ r.rand(8, 4)).astype(np.float32)}
    bad = {"x": np.full((16, 8), np.inf, np.float32), "y": batch["y"]}
    return params, batch, bad


def test_loss_scale_overflow_skips_and_growth_matches_the_jax_package():
    params, batch, bad = _regression()
    kw = dict(compute_dtype="bfloat16", op_autocast=True,
              dynamic_loss_scale=True, init_loss_scale=1024.0,
              growth_interval=3)
    jpol = jprecision.PrecisionPolicy("mixed_bf16", **kw)
    kw["compute_dtype"] = torch.bfloat16
    tpol = tprecision.PrecisionPolicy("mixed_bf16", **kw)
    mesh = make_mesh(MeshConfig(dp=-1), devices=jax.devices()[:1])
    with mesh_guard(mesh):
        jinit, jstep = jtrain.make_train_step(
            lambda p, b, r: jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2),
            optax.adam(0.05), mesh, {"w": ("io", "model"), "b": ("model",)},
            precision=jpol)
        jst = jinit({k: jnp.asarray(v) for k, v in params.items()})
        tinit, tstep = ttrain.make_train_step(
            lambda p, b, g: ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean(),
            lambda ps: torch.optim.Adam(ps, lr=0.05), device="cpu",
            precision=tpol)
        tst = tinit({k: torch.from_numpy(v) for k, v in params.items()})
        sequence = [batch, bad] + [batch] * 3
        for i, b in enumerate(sequence):
            if i == 1:  # before the overflow: a snapshot of all state
                w0 = tst.params["w"].detach().clone()
                opt0 = copy.deepcopy(tst.opt_state.state_dict())
            jst, jl = jstep(jst, b, jax.random.key(i))
            tst, tl = tstep(tst, {k: torch.from_numpy(v)
                                  for k, v in b.items()}, i)
            assert tst.loss_scale == {k: v.item() for k, v in
                                      jst.loss_scale.items()}, i
            if i == 1:
                # overflow: the update is skipped, params and optimizer
                # state bit-identical, the scale halves
                assert not np.isfinite(tl.item())
                assert torch.equal(tst.params["w"], w0)
                opt1 = tst.opt_state.state_dict()
                for key, st in opt0["state"].items():
                    for name, val in st.items():
                        assert torch.equal(opt1["state"][key][name], val)
                assert tst.loss_scale["scale"] == 512.0
                assert tst.loss_scale["overflows"] == 1
            else:
                assert abs(tl.item() - float(jl)) <= 1e-2 * float(jl)
    assert tst.loss_scale["scale"] == 1024.0
    assert tst.loss_scale["growths"] == 1
    assert tprecision.LOSS_SCALE_COUNTER_KEYS == \
        jprecision.LOSS_SCALE_COUNTER_KEYS


def _one_step(tcfg, np_params, batch, **strategy):
    init, step = ttrain.make_train_step(
        lambda p, b, g: tbert.pretrain_loss(p, tcfg, b, rng=g,
                                            deterministic=False),
        lambda ps: torch.optim.SGD(ps, lr=1.0), device="cpu",
        strategy=ttrain.TrainStrategy(**strategy), precision="f32")
    state = init(params_from_numpy(np_params, "cpu"))
    state, loss = step(state, batch, 7)
    return state.params, loss.item()


def test_accum_steps_equals_one_full_batch():
    _, tcfg, np_params, _ = _bert("float32")
    batch = _batches(tcfg, 1, seed=3, batch=8)[0]
    full, lf = _one_step(tcfg, np_params, batch)
    acc, la = _one_step(tcfg, np_params, batch, accum_steps=2)
    assert abs(lf - la) <= 1e-6 * lf
    for k in full:
        assert (full[k] - acc[k]).abs().max().item() <= 1e-5, k


def test_recompute_gives_the_same_grads_with_dropout_on():
    """The recomputed forward draws the same dropout bits: the step's
    generator is made from the seed inside the checkpointed call."""
    _, tcfg, np_params, _ = _bert("float32")
    tcfg.dropout = 0.1
    batch = _batches(tcfg, 1, seed=4)[0]
    plain, lp = _one_step(tcfg, np_params, batch)
    again, la = _one_step(tcfg, np_params, batch, recompute=True)
    assert lp == la
    for k in plain:
        assert torch.equal(plain[k], again[k]), k
    _, l_other = _one_step(tcfg, np_params, batch)
    assert l_other == lp          # the same seed, the same dropout


def test_strategy_and_precision_refusals():
    for policy in ("dots", "dots_no_batch"):   # ported: the step builds
        init, step = ttrain.make_train_step(
            lambda p, b, g: 0, _adamw(), device="cpu",
            strategy=ttrain.TrainStrategy(recompute=True,
                                          recompute_policy=policy))
        assert callable(init) and callable(step)
    with pytest.raises(ValueError, match="unknown recompute_policy"):
        ttrain.make_train_step(lambda p, b, g: 0, _adamw(), device="cpu",
                               strategy=ttrain.TrainStrategy(
                                   recompute=True, recompute_policy="all"))
    with pytest.raises(ValueError, match="recompute=False"):
        ttrain.make_train_step(lambda p, b, g: 0, _adamw(), device="cpu",
                               strategy=ttrain.TrainStrategy(
                                   recompute_policy="nothing"))
    with pytest.raises(ValueError, match="unknown precision"):
        ttrain.make_train_step(lambda p, b, g: 0, _adamw(), device="cpu",
                               precision="fp8")
    assert tprecision.POLICY_NAMES == jprecision.POLICY_NAMES
    for name in tprecision.POLICY_NAMES:
        j, t = jprecision.get_policy(name), tprecision.get_policy(name)
        for field in ("cast_state", "op_autocast", "dynamic_loss_scale",
                      "init_loss_scale", "growth_interval", "incr_ratio",
                      "decr_ratio", "min_loss_scale", "max_loss_scale"):
            assert getattr(j, field) == getattr(t, field), (name, field)
        want = None if j.compute_dtype is None else str(j.compute_dtype)
        got = None if t.compute_dtype is None else \
            str(t.compute_dtype).replace("torch.", "")
        assert want == got, name


POLICIES = [None, "nothing", "dots", "dots_no_batch"]


def _jax_policy_losses(jcfg, np_params, axes, batches, policy):
    mesh = make_mesh(MeshConfig(dp=-1), devices=jax.devices()[:1])

    def loss_fn(p, b, r):
        return jbert.pretrain_loss(p, jcfg, b, rng=r, deterministic=False)

    losses = []
    with mesh_guard(mesh):
        init, step = jtrain.make_train_step(
            loss_fn, optax.adamw(1e-4), mesh, axes,
            strategy=jtrain.TrainStrategy(clip_global_norm=1.0,
                                          recompute=True,
                                          recompute_policy=policy),
            precision="f32")
        state = init({k: jnp.asarray(v) for k, v in np_params.items()})
        for i, tb in enumerate(batches):
            jb = {k: jnp.asarray(v.numpy().astype(np.int32))
                  for k, v in tb.items()}
            state, loss = step(state, jb, jax.random.key(i))
            losses.append(float(loss))
    return losses


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_recompute_policy_trajectory(policy):
    """Two steps under each recompute policy against no recompute (the
    JAX package's limits for remat against none) and against the JAX
    package's step under the same policy."""
    jcfg, tcfg, np_params, axes = _bert("float32")
    batches = _batches(tcfg, 2, seed=6)
    plain, want = _torch_bert_losses(tcfg, np_params, batches, "f32")
    state, got = _torch_bert_losses(tcfg, np_params, batches, "f32",
                                    recompute=True, recompute_policy=policy)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for k, v in plain.params.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   v.detach().numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    jlosses = _jax_policy_losses(jcfg, np_params, axes, batches, policy)
    for i, (w, g) in enumerate(zip(jlosses, got)):
        assert abs(w - g) <= 1e-5 * abs(w), (i, w, g)


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def _dot_calls(tcfg, np_params, batch, **strategy):
    init, step = ttrain.make_train_step(
        lambda p, b, g: tbert.pretrain_loss(p, tcfg, b, rng=g,
                                            deterministic=True),
        lambda ps: torch.optim.SGD(ps, lr=1.0), device="cpu",
        strategy=ttrain.TrainStrategy(**strategy), precision="f32")
    state = init(params_from_numpy(np_params, "cpu"))
    with _OpCount() as count:
        step(state, batch, 0)
    aten = torch.ops.aten
    return count.n[aten.mm.default], count.n[aten.bmm.default]


def test_recompute_policies_save_their_dots():
    """One step's dot launches (forward, recompute and backward): "dots"
    saves every dot output, so it runs no more mm or bmm than no
    recompute; "dots_no_batch" saves the denses' mm and recomputes the
    attention's batched products (bmm, on the CPU's plain attention);
    "nothing" recomputes both."""
    _, tcfg, np_params, _ = _bert("float32")
    batch = _batches(tcfg, 1, seed=8)[0]
    mm0, bmm0 = _dot_calls(tcfg, np_params, batch)
    assert mm0 > 0 and bmm0 > 0
    nothing = _dot_calls(tcfg, np_params, batch, recompute=True,
                         recompute_policy="nothing")
    dots = _dot_calls(tcfg, np_params, batch, recompute=True,
                      recompute_policy="dots")
    no_batch = _dot_calls(tcfg, np_params, batch, recompute=True,
                          recompute_policy="dots_no_batch")
    assert dots == (mm0, bmm0)
    assert no_batch[0] == mm0 and no_batch[1] > bmm0
    assert nothing[0] > mm0 and nothing[1] == no_batch[1]


def test_gpt_lm_loss_and_grads_match():
    jcfg, tcfg = jgpt.GPTConfig.tiny(), tgpt.GPTConfig.tiny()
    jcfg.dtype = tcfg.dtype = "float32"
    jparams, _ = jgpt.init(jax.random.key(2), jcfg)
    ids = np.random.RandomState(5).randint(0, jcfg.vocab_size, (2, 25))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgpt.lm_loss(p, jcfg, {"ids": jnp.asarray(ids)})))(jparams)
    tparams = params_from_numpy({k: np.asarray(v)
                                 for k, v in jparams.items()}, "cpu",
                                expected=tgpt.param_shapes(tcfg))
    for v in tparams.values():
        v.requires_grad_()
    tloss = tgpt.lm_loss(tparams, tcfg, {"ids": torch.from_numpy(ids)})
    grads = torch.autograd.grad(tloss, list(tparams.values()))
    assert abs(float(jloss) - tloss.item()) <= 1e-5 * float(jloss)
    for name, g in zip(tparams, grads):
        want = np.asarray(jgrads[name], np.float32)
        err = np.abs(want - g.numpy()).max() / max(1.0, np.abs(want).max())
        assert err <= 1e-4, name
    b = tgpt.make_batch(torch.Generator().manual_seed(0), tcfg, 3)
    assert b["ids"].shape == (3, tcfg.max_len + 1)
