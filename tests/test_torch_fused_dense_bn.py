"""The port's fused matmul+BN ops (`kernels/fused_dense_bn.py`: K4
`matmul_stats`, K5 `bn_act_matmul`, K6 `bn_act_matmul_stats`) against
the JAX package's (`ops/pallas/fused_dense_bn.py`), on the same numpy
inputs. The JAX ops run their Pallas kernels in interpret mode on the
CPU, as the JAX package's own tests run them; the port's wrappers run
their plain versions on CPU tensors. The CUDA kernels are held against
those plain versions on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).

Shapes: a ragged M (200 rows: no power-of-two tile divides it), K 24,
N 40. Gradients are taken under cotangents on every output (y, mean
and var), so a backward that dropped the statistics' cotangents would
fail.

Tolerances, per element as |got - want| <= atol + rtol |want| with
atol = rtol:
- f32, those of tests/test_fused_dense_bn.py: y 1e-5, mean 1e-4, var
  1e-3, gradients 1e-4 (the same f32 sums, taken in another order by
  XLA and torch);
- f64: 1e-10 for every output and gradient (f64 sums in another order
  over at most 200 terms);
- bf16 x and w: y within one bf16 step of the reference (rtol 2^-7:
  both round nearly the same f32 sum to bf16, which may land one step
  apart), mean and var at the f32 limits (they are f32, from the f32
  accumulator before the rounding);
- the fused bottleneck slice (matmul_stats -> fold_bn -> bn_act_matmul
  against the plain composition), that test's 2e-4 for values and 2e-3
  for gradients.

The route a CUDA call takes (`kernel_route`: the TMA kernel, its padded
copies, or the FMA kernel) is a function of shape, dtype and alignment
and is tested as one; the padded copies (`padded_operands`) are held to
compute the unpadded call's function through the plain versions: f32
within 1e-6, y at bf16 within one rounding step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_dense_bn as JF

from paddle_tpu_torch.kernels import fused_dense_bn as TF

torch.set_num_threads(2)

M, K, N = 200, 24, 40
TOL = {"float32": {"y": 1e-5, "mean": 1e-4, "var": 1e-3, "grad": 1e-4},
       "float64": {"y": 1e-10, "mean": 1e-10, "var": 1e-10, "grad": 1e-10},
       "bfloat16": {"y": 2 ** -7, "mean": 1e-4, "var": 1e-3}}
OPS = {"matmul_stats": (JF.matmul_stats, TF.matmul_stats, False, True),
       "bn_act_matmul": (JF.bn_act_matmul, TF.bn_act_matmul, True, False),
       "bn_act_matmul_stats": (JF.bn_act_matmul_stats,
                               TF.bn_act_matmul_stats, True, True)}


def _inputs(dtype, seed=0):
    """x [M, K], w [K, N] (in `dtype`), scale, shift [K] (in the
    accumulator's dtype) as numpy arrays; bf16 values are rounded
    through torch so both sides see the same numbers."""
    rs = np.random.RandomState(seed)
    acc = np.float64 if dtype == "float64" else np.float32
    x = rs.randn(M, K)
    w = rs.randn(K, N) * 0.3
    if dtype == "bfloat16":
        x, w = (torch.from_numpy(a.astype(np.float32)).bfloat16().float()
                .numpy() for a in (x, w))
    else:
        x, w = x.astype(dtype), w.astype(dtype)
    scale = (rs.rand(K) + 0.5).astype(acc)
    shift = (rs.randn(K) * 0.5).astype(acc)
    return x, w, scale, shift


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else a.dtype)


def _torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.bfloat16() if dtype == "bfloat16" else t


def _call(op, lib, args, relu):
    if lib == "jax":
        fn = OPS[op][0]
    else:
        fn = OPS[op][1]
    if OPS[op][2]:
        out = fn(*args, relu=relu)
    else:
        out = fn(args[0], args[3])
    return out if isinstance(out, tuple) else (out,)


def _close(got, want, tol, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


CASES = [(op, dtype, relu) for op in OPS
         for dtype in ("float32", "float64", "bfloat16")
         for relu in ((True, False) if OPS[op][2] else (True,))]


@pytest.mark.parametrize("op,dtype,relu", CASES)
def test_forward_matches_jax(op, dtype, relu):
    x, w, scale, shift = _inputs(dtype)
    want = _call(op, "jax", [_jax(x, dtype), jnp.asarray(scale),
                             jnp.asarray(shift), _jax(w, dtype)], relu)
    before = (TF.matmul_stats_fwd.launches, TF.bn_act_matmul_fwd.launches,
              TF.bn_act_matmul_stats_fwd.launches)
    got = _call(op, "torch", [_torch(x, dtype), torch.from_numpy(scale),
                              torch.from_numpy(shift), _torch(w, dtype)], relu)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (TF.matmul_stats_fwd.launches, TF.bn_act_matmul_fwd.launches,
            TF.bn_act_matmul_stats_fwd.launches) == before
    assert len(got) == len(want)
    tol = TOL[dtype]
    assert got[0].dtype == _torch(x, dtype).dtype
    assert got[0].shape == (M, N)
    _close(got[0], np.asarray(want[0], np.float64), tol["y"], "y")
    if len(got) == 3:
        acc = torch.float64 if dtype == "float64" else torch.float32
        assert got[1].dtype == got[2].dtype == acc
        _close(got[1], want[1], tol["mean"], "mean")
        _close(got[2], want[2], tol["var"], "var")


GRAD_CASES = [(op, dtype, relu) for op, dtype, relu in CASES
              if dtype != "bfloat16"]


@pytest.mark.parametrize("op,dtype,relu", GRAD_CASES)
def test_gradients_match_jax(op, dtype, relu):
    """Gradients of x, scale, shift and w (x and w for matmul_stats)
    under cotangents on every output."""
    x, w, scale, shift = _inputs(dtype, seed=1)
    rs = np.random.RandomState(2)
    acc = np.float64 if dtype == "float64" else np.float32
    cts = [rs.randn(M, N).astype(dtype), rs.randn(N).astype(acc),
           rs.randn(N).astype(acc)]
    prologue = OPS[op][2]
    argnums = (0, 1, 2, 3) if prologue else (0, 3)

    def jloss(*a):
        out = _call(op, "jax", list(a), relu)
        return sum((o * jnp.asarray(c)).sum() for o, c in zip(out, cts))

    want = jax.grad(jloss, argnums=argnums)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift),
        jnp.asarray(w))
    targs = [torch.from_numpy(a).requires_grad_()
             for a in (x, scale, shift, w)]
    out = _call(op, "torch", targs, relu)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cts))
    got = torch.autograd.grad(loss, [targs[i] for i in argnums])
    for i, g, wg in zip(argnums, got, want):
        assert g.dtype == targs[i].dtype
        _close(g, wg, TOL[dtype]["grad"], f"grad of input {i}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fold_bn_matches_jax(dtype):
    rs = np.random.RandomState(3)
    mean, gamma, beta = (rs.randn(16).astype(dtype) for _ in range(3))
    var = rs.rand(16).astype(dtype)
    want = JF.fold_bn(*(jnp.asarray(a) for a in (mean, var, gamma, beta)))
    got = TF.fold_bn(*(torch.from_numpy(a) for a in (mean, var, gamma, beta)))
    for g, wv in zip(got, want):
        _close(g, wv, TOL[dtype]["y"], "fold_bn")


def _bottleneck_inputs():
    rs = np.random.RandomState(4)
    Mb, C1, C2, C3 = 256, 64, 128, 64
    return [rs.randn(Mb, C1).astype(np.float32),
            (rs.randn(C1, C2) * 0.1).astype(np.float32),
            (rs.rand(C2) + 0.5).astype(np.float32),
            (rs.randn(C2) * 0.1).astype(np.float32),
            (rs.randn(C2, C3) * 0.1).astype(np.float32)], \
        rs.randn(Mb, C3).astype(np.float32)


def _fused(x, w1, gamma, beta, w2):
    y, mean, var = TF.matmul_stats(x, w1)
    scale, shift = TF.fold_bn(mean, var, gamma, beta)
    return TF.bn_act_matmul(y, scale, shift, w2, relu=True)


def _unfused(x, w1, gamma, beta, w2):
    y = x @ w1
    mean = y.mean(0)
    var = torch.clamp_min((y * y).mean(0) - mean * mean, 0.0)
    yn = (y - mean) * torch.rsqrt(var + 1e-5) * gamma + beta
    return torch.relu(yn) @ w2


def test_fused_bottleneck_slice_matches_unfused():
    """1x1 conv -> BN -> relu -> 1x1 conv: the fused composition (K4, then
    K5 with the folded BN in its prologue) against the plain one, values
    and gradients of all five inputs, as
    tests/test_fused_dense_bn.py::test_fused_bottleneck_slice_matches_unfused
    holds the JAX package's."""
    arrays, ct = _bottleneck_inputs()
    ins_f = [torch.from_numpy(a).requires_grad_() for a in arrays]
    ins_u = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out_f, out_u = _fused(*ins_f), _unfused(*ins_u)
    _close(out_f, out_u.detach().numpy(), 2e-4, "bottleneck values")
    ctt = torch.from_numpy(ct)
    gf = torch.autograd.grad((out_f * ctt).sum(), ins_f)
    gu = torch.autograd.grad((out_u * ctt).sum(), ins_u)
    for i, (a, b) in enumerate(zip(gf, gu)):
        _close(a, b.numpy(), 2e-3, f"bottleneck grad {i}")


def test_fused_bottleneck_slice_matches_jax():
    """The same fused composition against the JAX package's, values and
    gradients, at the same limits."""
    arrays, ct = _bottleneck_inputs()

    def jfused(x, w1, gamma, beta, w2):
        y, mean, var = JF.matmul_stats(x, w1)
        scale, shift = JF.fold_bn(mean, var, gamma, beta)
        return JF.bn_act_matmul(y, scale, shift, w2, relu=True)

    jins = [jnp.asarray(a) for a in arrays]
    want = jfused(*jins)
    wgrads = jax.grad(lambda *a: (jfused(*a) * jnp.asarray(ct)).sum(),
                      argnums=(0, 1, 2, 3, 4))(*jins)
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = _fused(*ins)
    _close(out, want, 2e-4, "bottleneck values")
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), ins)
    for i, (a, b) in enumerate(zip(grads, wgrads)):
        _close(a, b, 2e-3, f"bottleneck grad {i}")


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(8, 4)
    w = torch.zeros(4, 6)
    s = torch.ones(4)
    with pytest.raises(ValueError, match=r"x \[M, K\]"):
        TF.matmul_stats_fwd(x, torch.zeros(5, 6))
    with pytest.raises(ValueError, match="one dtype"):
        TF.matmul_stats_fwd(x, w.double())
    with pytest.raises(ValueError, match="one dtype"):
        TF.matmul_stats_fwd(x.int(), w.int())
    with pytest.raises(ValueError, match="scale"):
        TF.bn_act_matmul_fwd(x, torch.ones(5), s, w)
    # a device that is neither cuda nor cpu never reaches a plain version
    with pytest.raises(ValueError, match="cuda or cpu"):
        TF.bn_act_matmul_stats_fwd(x.to("meta"), s.to("meta"),
                                   s.to("meta"), w.to("meta"))


def test_none_cotangents_count_as_zero():
    """Backward through only y of matmul_stats equals backward with zero
    cotangents on mean and var."""
    x, w, _, _ = _inputs("float64", seed=5)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y, mean, var = TF.matmul_stats(xt, wt)
    g1 = torch.autograd.grad(y.sum(), (xt, wt))
    y, mean, var = TF.matmul_stats(xt, wt)
    g2 = torch.autograd.grad(y.sum() + 0 * mean.sum() + 0 * var.sum(),
                             (xt, wt))
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


# kernel_route: (K, N, dtype, x address, w address) -> route. f32 and f64
# take the FMA kernel whatever their shape; bf16 and f16 take the TMA
# kernel when K and N are multiples of 8 and both bases are 16-byte
# aligned (every ResNet-50 1x1 shape), else the padded copies
ROUTE_CASES = [(256, 64, torch.bfloat16, 0, 256, "tma"),
               (1024, 256, torch.bfloat16, 4096, 8192, "tma"),
               (64, 256, torch.float16, 16, 48, "tma"),
               (72, 40, torch.bfloat16, 0, 0, "tma"),
               (70, 36, torch.bfloat16, 0, 0, "padded"),
               (70, 40, torch.float16, 0, 0, "padded"),
               (72, 36, torch.bfloat16, 0, 0, "padded"),
               (256, 64, torch.bfloat16, 8, 0, "padded"),
               (256, 64, torch.float16, 0, 2, "padded"),
               (70, 36, torch.float32, 4, 4, "fma"),
               (256, 64, torch.float64, 0, 0, "fma")]


@pytest.mark.parametrize("K,N,dtype,x_ptr,w_ptr,route", ROUTE_CASES)
def test_kernel_route_is_a_function_of_shape_dtype_and_alignment(
        K, N, dtype, x_ptr, w_ptr, route):
    assert TF.kernel_route(K, N, dtype, x_ptr, w_ptr) == route


def test_every_resnet50_shape_takes_the_tma_route():
    """The channel counts of ResNet-50's fused 1x1 products (K4: conv1,
    K5 and K6: conv3, every stage group) are all TMA-readable."""
    for K, N in ((256, 64), (512, 128), (1024, 256), (2048, 512),
                 (64, 256), (128, 512), (256, 1024), (512, 2048)):
        assert TF.kernel_route(K, N, torch.bfloat16, 0, 0) == "tma"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", list(OPS))
def test_padded_operands_compute_the_same_function(op, dtype):
    """The padded route's copies (K 70 -> 72, N 36 -> 40) give, in their
    first N columns, the unpadded call's y, mean and var: the padded
    columns of x meet zero rows of w and come out of the prologue as 0
    (relu or not), and the partial sums are taken over the same rows."""
    global M, K, N
    saved = M, K, N
    M, K, N = 100, 70, 36
    try:
        x, w, scale, shift = _inputs(dtype, seed=7)
    finally:
        M, K, N = saved
    x, w = _torch(x, dtype), _torch(w, dtype)
    scale, shift = torch.from_numpy(scale), torch.from_numpy(shift)
    px, pw, pscale, pshift = TF.padded_operands(x, w, scale, shift)
    assert px.shape == (100, 72) and pw.shape == (72, 40)
    assert pscale.shape == pshift.shape == (72,)
    assert px.dtype == x.dtype and pw.dtype == w.dtype
    for relu in (True, False):
        want = _call(op, "torch", [x, scale, shift, w], relu)
        got = _call(op, "torch", [px, pscale, pshift, pw], relu)
        assert got[0].shape == (100, 40)
        assert torch.equal(got[0][:, 36:], torch.zeros_like(got[0][:, 36:]))
        # the same f32 sums with zero terms added: f32 to 1e-6, and y at
        # bf16 within one rounding step of its dtype
        for a, b in zip(got, want):
            tol = 2 ** -7 if a.dtype == torch.bfloat16 else 1e-6
            assert torch.allclose(a[..., :36].double(), b.double(),
                                  rtol=tol, atol=tol), (op, relu)
