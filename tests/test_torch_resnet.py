"""The port's ResNet (`models/resnet.py`) against the JAX package's, on
the same parameters (carried across with `params_from_numpy`) and the
same numpy images, on `ResNetConfig.tiny()` at f64 activations (8
images of 32 x 32), with `fused_1x1` off and on, in training and eval,
NHWC and NCHW. On the CPU the fused 1x1 path runs the plain versions of
K4 and K6; the JAX package runs its Pallas kernels in interpret mode.

Tolerances. `tests/test_fused_dense_bn.py::test_resnet_fused_1x1_matches_unfused`
holds the fused path against the unfused one inside one framework at
loss 1e-9 relative, BN updates rtol 1e-8 (atol 1e-10) and gradients
rtol 1e-6 (atol 1e-8). The port's fused path is held against its own
unfused path at exactly those limits. Against the JAX package, the BN
updates (f64 end to end) keep rtol 1e-8, but the loss and the
gradients cannot keep the rest: the model's head and its log-softmax
compute in f32 by design, and XLA and torch sum those f32 products in
other orders, so logits differ by f32 steps (6e-8 relative) and the
gradients, which the f32 parameters also round to f32, by f32 steps of
their largest element (measured: loss 1.0e-7 relative, gradients at
most 2.0e-6 of their tensor's largest value; with the head patched to
f64 the loss agrees to the last bit). So the loss is held to 1e-6
relative and each gradient to 1e-5 of its tensor's largest value. In
eval, BN normalises with the f32 running variance, so each of the 53
BN layers also takes an f32 rsqrt, whose last bit torch and XLA round
differently for many values: measured, the loss 3.8e-6 relative and
the gradients at most 1.3e-4 of their tensor's largest value (the
running variances', through that rsqrt); eval is held to 2e-5 and
1e-3. Eval runs with every BN's running statistics set to the batch's
own, so it normalises as training does. The model test prints each
gap it measures.

The training loop: 3 steps of `make_train_step(has_aux=True)` with
SGD(0.1, momentum 0.9), fused, f64 activations, against the JAX
package's `make_train_step` with `optax.sgd(0.1, momentum=0.9)` on a
one-device mesh, each step from the same state (see the test).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from paddle_tpu.models import resnet as jres
from paddle_tpu.parallel import MeshConfig, make_mesh, mesh_guard
from paddle_tpu.parallel import train as jtrain

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import common as tcommon
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.parallel import train as ttrain

torch.set_num_threads(2)

B, HW = 8, 32
# limits against the JAX package, by mode (train, eval): see the module
# docstring
LOSS_RTOL = {True: 1e-6, False: 2e-5}
GRAD_TOL = {True: 1e-5, False: 1e-3}


def _cfgs(fused=False, dtype="float64"):
    return (dataclasses.replace(jres.ResNetConfig.tiny(), dtype=dtype,
                                fused_1x1=fused),
            dataclasses.replace(tres.ResNetConfig.tiny(), dtype=dtype,
                                fused_1x1=fused))


@pytest.fixture(scope="module")
def params():
    jparams, axes = jres.init(jax.random.key(0), _cfgs()[0])
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}, axes


def _batch(fmt, seed=1):
    rs = np.random.RandomState(seed)
    img = rs.standard_normal((B, HW, HW, 3)).astype(np.float32)
    if fmt == "NCHW":
        img = np.ascontiguousarray(img.transpose(0, 3, 1, 2))
    return {"img": img, "label": rs.randint(0, 10, B)}


_JAX_CACHE = {}


def _eval_params(np_params):
    """The params with every BN's running statistics set to the batch's
    own (recovered from the JAX package's EMA updates of a training
    forward), so that eval normalises as training does: at the initial
    statistics (mean 0, var 1) the activations grow through the 16
    blocks and the logits reach the hundreds."""
    key = "eval_params"
    if key not in _JAX_CACHE:
        cfg = _cfgs()[0]
        b = {k: jnp.asarray(v) for k, v in _batch("NHWC").items()}
        _, upd = jres.apply({k: jnp.asarray(v) for k, v in np_params.items()},
                            cfg, b["img"], train=True, data_format="NHWC")
        m = cfg.bn_momentum
        _JAX_CACHE[key] = {**np_params, **{
            k: ((np.asarray(v) - m * np_params[k]) / (1 - m))
            .astype(np.float32) for k, v in upd.items()}}
    return _JAX_CACHE[key]


def _jax_run(jparams, train, fmt, fused):
    """(loss, {name: update}, {name: grad}) of the JAX package, as numpy."""
    key = (train, fmt, fused)
    if key not in _JAX_CACHE:
        jcfg = _cfgs(fused)[0]
        b = {k: jnp.asarray(v) for k, v in _batch(fmt).items()}
        fn = jax.jit(jax.value_and_grad(
            lambda p: jres.loss_fn(p, jcfg, b, None, train=train,
                                   data_format=fmt), has_aux=True))
        (loss, upd), grads = fn(jparams)
        _JAX_CACHE[key] = (float(loss),
                           {k: np.asarray(v) for k, v in upd.items()},
                           {k: np.asarray(v) for k, v in grads.items()})
    return _JAX_CACHE[key]


def _torch_run(np_params, train, fmt, fused):
    tcfg = _cfgs(fused)[1]
    ps = {k: t.requires_grad_() for k, t in
          params_from_numpy(np_params, "cpu").items()}
    b = {k: torch.from_numpy(v) for k, v in _batch(fmt).items()}
    loss, upd = tres.loss_fn(ps, tcfg, b, train=train, data_format=fmt)
    grads = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
    return (loss.item(), {k: v.detach().numpy() for k, v in upd.items()},
            {k: (torch.zeros_like(p) if g is None else g).numpy()
             for (k, p), g in zip(ps.items(), grads)})


def test_init_matches_the_jax_package():
    """Names, order, shapes, dtypes and axes of `init`, and
    `param_shapes`, for tiny() and resnet50()."""
    for name in ("tiny", "resnet50"):
        jcfg = getattr(jres.ResNetConfig, name)()
        tcfg = getattr(tres.ResNetConfig, name)()
        jp, jaxes = jres.init(jax.random.key(0), jcfg)
        tp, taxes = tres.init(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
        assert list(tp) == list(jp)
        assert taxes == jaxes
        assert tres.param_shapes(tcfg) == {k: tuple(v.shape)
                                           for k, v in jp.items()}
        for k, v in jp.items():
            assert tuple(tp[k].shape) == tuple(v.shape), k
            assert str(tp[k].dtype) == f"torch.{v.dtype}", k
    # the init scales: He-normal convs, unit BN scale and running var
    assert abs(tp["g2.b0.conv2.w"].std().item() - (2 / (9 * 256)) ** 0.5) \
        < 5e-3
    assert torch.equal(tp["stem.bn.var"], torch.ones(64))


def test_jax_params_carry_across(params):
    jparams, np_params, _ = params
    tcfg = _cfgs()[1]
    tp = params_from_numpy(np_params, "cpu",
                           expected=tres.param_shapes(tcfg))
    for k, v in np_params.items():
        assert np.array_equal(tp[k].numpy(), v), k
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in np_params.items()
                           if k != "head.b"}, "cpu",
                          expected=tres.param_shapes(tcfg))


# (kernel, stride, size): the stem 7x7/2, conv2's 3x3/2 and the
# projection's 1x1/2, at an even and an odd size, and 3x3/1
CONV_CASES = [(7, 2, 32), (7, 2, 31), (3, 2, 16), (3, 2, 15), (1, 2, 16),
              (1, 2, 15), (3, 1, 16)]


@pytest.mark.parametrize("k,stride,size", CONV_CASES)
def test_conv2d_nhwc_matches_lax_same_padding(k, stride, size):
    rs = np.random.RandomState(k * 100 + size)
    x = rs.randn(2, size, size + 1, 5)
    w = rs.randn(k, k, 5, 6)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tcommon.conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                              stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("k", [7, 3])
def test_same_padding_is_asymmetric_at_stride_2(k):
    """At an even size and stride 2, XLA pads one row fewer before than
    after: the symmetric padding k // 2 gives the same output size but
    a shifted window, and differs from the reference."""
    assert tcommon.same_pads(224, 7, 2) == (2, 3)
    assert tcommon.same_pads(56, 3, 2) == (0, 1)
    assert tcommon.same_pads(56, 1, 2) == (0, 0)
    rs = np.random.RandomState(k)
    x, w = rs.randn(1, 16, 16, 3), rs.randn(k, k, 3, 4)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                   padding=k // 2).permute(0, 2, 3, 1).numpy()
    assert sym.shape == want.shape
    assert np.abs(sym - want).max() > 1e-3
    got = tcommon.conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_conv_keeps_nhwc_contiguous_and_refuses_int8():
    x = torch.randn(2, 16, 16, 8)
    y = tcommon.conv2d_nhwc(x, torch.randn(3, 3, 8, 4), 2)
    assert y.shape == (2, 8, 8, 4) and y.is_contiguous()
    y1 = tcommon.conv2d_nhwc(x, torch.randn(1, 1, 8, 4), 1)
    assert y1.is_contiguous()
    # int8 weights take the int8 path, which needs the weight's
    # per-channel scales: without them the conv refuses the weight
    wq = torch.zeros(1, 1, 8, 4, dtype=torch.int8)
    with pytest.raises(KeyError, match="c.w@scale"):
        tcommon.conv2d_nhwc_auto({"c.w": wq}, "c", x)
    yq = tcommon.conv2d_nhwc_auto({"c.w": wq, "c.w@scale": torch.ones(4)},
                                  "c", x, 2)
    assert yq.shape == (2, 8, 8, 4) and yq.dtype == x.dtype


def _grad_ratio(got, want, tol):
    """The worst tensor's max |got - want| over `tol` times its largest
    reference value (at most 1 passes), and its name."""
    worst = (0.0, None)
    for k, w in want.items():
        scale = np.abs(w).max()
        if scale == 0:
            assert np.abs(got[k]).max() == 0, k
            continue
        r = np.abs(got[k].astype(np.float64) - w).max() / (tol * scale)
        worst = max(worst, (float(r), k), key=lambda t: t[0])
    return worst


MODEL_CASES = [(True, "NHWC", False), (True, "NHWC", True),
               (True, "NCHW", True), (False, "NHWC", False),
               (False, "NCHW", True)]


@pytest.mark.parametrize("train,fmt,fused", MODEL_CASES)
def test_model_matches_the_jax_package(params, train, fmt, fused):
    jparams, np_params, _ = params
    if not train:
        np_params = _eval_params(np_params)
        jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    jl, jupd, jgrads = _jax_run(jparams, train, fmt, fused)
    tl, tupd, tgrads = _torch_run(np_params, train, fmt, fused)
    ratio, name = _grad_ratio(tgrads, jgrads, GRAD_TOL[train])
    print(f"loss {abs(tl - jl) / abs(jl):.3g} relative, worst gradient "
          f"{ratio * GRAD_TOL[train]:.3g} of its largest value ({name})")
    assert abs(tl - jl) <= LOSS_RTOL[train] * abs(jl), (tl, jl)
    assert set(tupd) == set(jupd)
    assert bool(tupd) == train
    for k in jupd:
        assert tupd[k].dtype == np.float64
        np.testing.assert_allclose(tupd[k], jupd[k], rtol=1e-8, atol=1e-10,
                                   err_msg=k)
    assert set(tgrads) == set(jgrads)
    assert ratio <= 1.0, (ratio, name)


def test_the_f32_head_is_the_gap_to_the_jax_package(params, monkeypatch):
    """With the head's product computed in f64 on both sides (the JAX
    package's `dense` and the port's `tp_dense` patched to upcast the
    head's f32 input), the fused model's loss agrees with the JAX
    package's within 1e-8 relative and every gradient within 1e-6 of
    its tensor's largest value (measured: the loss to the last bit,
    gradients 1.2e-7, one f32 step of the f32 params), against 1.0e-7
    and 2.0e-6 with the f32 head: what remains of the gap is the f32
    rounding of the head's input and of the gradients."""
    jparams, np_params, _ = params
    jdense, tdense = jres.dense, tres.tp_dense
    monkeypatch.setattr(jres, "dense", lambda p, n, x: jdense(
        p, n, x.astype(jnp.float64)))
    monkeypatch.setattr(tres, "tp_dense", lambda p, n, x, axes: tdense(
        p, n, x.double(), axes))
    jcfg = _cfgs(True)[0]
    b = {k: jnp.asarray(v) for k, v in _batch("NHWC").items()}
    (jl, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jres.loss_fn(p, jcfg, b, None, data_format="NHWC"),
        has_aux=True))(jparams)
    tl, _, tgrads = _torch_run(np_params, True, "NHWC", True)
    assert abs(tl - float(jl)) <= 1e-8 * abs(float(jl)), (tl, float(jl))
    ratio, name = _grad_ratio(tgrads, {k: np.asarray(v) for k, v in
                                       jgrads.items()}, 1e-6)
    assert ratio <= 1.0, (ratio, name)


def test_fused_path_matches_the_unfused_path():
    """The port's fused 1x1 path against its own unfused path, in one
    framework on one device, at the reference test's limits."""
    np_params = {k: np.asarray(v) for k, v in
                 jres.init(jax.random.key(0), _cfgs()[0])[0].items()}
    (lu, uu, gu), (lf, uf, gf) = (_torch_run(np_params, True, "NHWC", f)
                                  for f in (False, True))
    assert abs(lf - lu) < 1e-9 * max(1.0, abs(lu)), (lf, lu)
    assert set(uf) == set(uu) and len(uu) == 53 * 2
    for k in uu:
        np.testing.assert_allclose(uf[k], uu[k], rtol=1e-8, atol=1e-10,
                                   err_msg=k)
    for k in gu:
        np.testing.assert_allclose(gf[k], gu[k], rtol=1e-6, atol=1e-8,
                                   err_msg=k)


def test_eval_uses_the_running_statistics():
    """In eval, BN reads `.mean` and `.var`: moving them moves the
    logits, and no update is returned."""
    tcfg = _cfgs(True)[1]
    tp, _ = tres.init(torch.Generator().manual_seed(3), tcfg, device="cpu")
    img = torch.randn(2, HW, HW, 3, dtype=torch.float64)
    logits, upd = tres.apply(tp, tcfg, img, train=False, data_format="NHWC")
    assert upd == {} and logits.shape == (2, 10) and \
        logits.dtype == torch.float32
    tp["g3.b2.bn3.mean"] += 1.0
    moved, _ = tres.apply(tp, tcfg, img, train=False, data_format="NHWC")
    assert (moved - logits).abs().max() > 1e-3


def test_make_batch():
    cfg = tres.ResNetConfig.tiny()
    b = tres.make_batch(np.random.RandomState(0), cfg, 4, hw=32,
                        data_format="NHWC", device="cpu")
    assert b["img"].shape == (4, 32, 32, 3) and b["img"].dtype == torch.float32
    assert b["label"].dtype == torch.int64
    assert int(b["label"].min()) >= 0 and int(b["label"].max()) < 10
    g = tres.make_batch(torch.Generator().manual_seed(0), cfg, 4, hw=16)
    assert g["img"].shape == (4, 3, 16, 16) and g["img"].device.type == "cpu"
    with pytest.raises(ValueError):
        tres.make_batch(np.random.RandomState(0), cfg, 4, data_format="CHW",
                        device="cpu")


def test_flops_per_image_matches_the_jax_package():
    for name in ("tiny", "resnet50"):
        assert getattr(tres.ResNetConfig, name)().flops_per_image(224) == \
            getattr(jres.ResNetConfig, name)().flops_per_image(224)
    assert abs(tres.ResNetConfig.resnet50().flops_per_image(224)
               - 24.54e9) < 1e6


STEPS = 3


def _jax_trace(state):
    """{name: momentum trace} of the JAX state's masked optax.sgd (the
    trainable params only)."""
    found = [t for t in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(t, optax.TraceState)]
    assert len(found) == 1
    return {k: np.asarray(v) for k, v in found[0].trace.items()
            if not isinstance(v, optax.MaskedNode)}


def test_sgd_momentum_trajectory_matches_the_jax_train_step(params):
    """3 fused training steps on one batch with SGD(0.1, momentum 0.9).
    Each step starts both sides from the JAX step's state (params, BN
    statistics and momentum trace): the trajectory itself is chaotic at
    this learning rate (the JAX package against itself, with every
    element of head.w moved by one f32 step, ends more than 1e-3 of the
    three steps' update apart, checked below), so a free-running
    comparison would measure that, not the step. Per step: the loss within 1e-6 relative; each trainable
    param within 1e-4 of its largest update plus one f32 step of its
    largest value (the f32 gradient noise times lr, and the rounding of
    the new value); the BN statistics, written from the step's aux,
    within 1e-6 relative (f64 updates stored in f32)."""
    jparams, np_params, axes = params
    jcfg, tcfg = _cfgs(True)
    batch = _batch("NHWC")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mesh = make_mesh(MeshConfig(dp=-1), devices=jax.devices()[:1])
    tinit, tstep = ttrain.make_train_step(
        lambda p, b, g: tres.loss_fn(p, tcfg, b, g, data_format="NHWC"),
        lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9), device="cpu",
        has_aux=True)
    losses = []
    with mesh_guard(mesh):
        init, step = jtrain.make_train_step(
            lambda p, b, r: jres.loss_fn(p, jcfg, b, r, data_format="NHWC"),
            optax.sgd(0.1, momentum=0.9), mesh, axes, has_aux=True)
        state = init({k: jnp.asarray(v) for k, v in np_params.items()})
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for i in range(STEPS):
            before = {k: np.asarray(v) for k, v in state.params.items()}
            trace = _jax_trace(state)
            state, jloss = step(state, jb, jax.random.key(i))
            after = {k: np.asarray(v) for k, v in state.params.items()}

            tstate = tinit(params_from_numpy(before, "cpu"))
            opt = tstate.opt_state
            for k, t in trace.items():
                opt.state[tstate.params[k]]["momentum_buffer"] = \
                    torch.from_numpy(t.copy())
            tstate, tloss = tstep(tstate, tb, i)
            assert abs(tloss.item() - float(jloss)) <= \
                LOSS_RTOL[True] * abs(float(jloss)), \
                (i, tloss.item(), float(jloss))
            losses.append(float(jloss))
            if i == 0:
                first = before
            for k, w in after.items():
                g = tstate.params[k].detach().numpy()
                assert g.dtype == w.dtype == np.float32, k
                if k.endswith((".mean", ".var")):
                    assert not np.array_equal(w, before[k]), k
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-10,
                                               err_msg=f"step {i} {k}")
                    continue
                err = np.abs(g.astype(np.float64) - w).max()
                lim = 1e-4 * np.abs(w.astype(np.float64) - before[k]).max() \
                    + np.spacing(np.abs(w).max())
                assert err <= lim, (i, k, err, lim)
        assert len(losses) == STEPS and all(np.isfinite(losses))
        # why each step is resynced: the same JAX steps from head.w moved
        # by one f32 step end far more than f32 noise apart
        pert = dict(np_params)
        pert["head.w"] = np.nextafter(np_params["head.w"], np.float32(np.inf))
        state = init({k: jnp.asarray(v) for k, v in pert.items()})
        for i in range(STEPS):
            state, _ = step(state, jb, jax.random.key(i))
    apart = max(np.abs(np.asarray(state.params[k], np.float64) - w).max() /
                np.abs(w.astype(np.float64) - first[k]).max()
                for k, w in after.items()
                if not k.endswith((".mean", ".var")))
    print(f"perturbed JAX trajectory: {apart:.3g} of an update apart")
    assert apart > 1e-3, apart
