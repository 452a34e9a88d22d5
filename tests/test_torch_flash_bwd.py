"""K1-bwd's plain version against the JAX package's splash backward.

`flash_attention` under grad runs the `FlashAttention` autograd
Function; on CPU tensors its forward is `flash_attention_ref` (with the
LSE) and its backward `flash_attention_bwd_ref`, the step-for-step
plain version of the backward kernels (dq with the delta pass, then
dkv) that the card holds the kernels against (tests/test_torch_cuda.py).
Here those
gradients are held against `jax.vjp` of the JAX package's
`_splash_mha(..., interpret=True)` (splash's Pallas dq/dkv kernels run
in the interpreter), and against torch autograd of the forward; the
K1-fwd LSE output (`flash_attention_with_lse`, the counterpart of K3's
forward) against `_splash_block_with_lse(interpret=True)`.

Tolerances, relative to the largest reference value (at least 1):
1e-5 at f32 (the same f32 arithmetic summed in other orders), 8e-3 at
bf16 (one bf16 rounding step, 2^-7, of a gradient element: P and dS
are rounded to bf16 at the same points as splash, so only a sum taken
in another order can move a rounding). LSE: 1e-5 absolute. Against
splash every element is also held to its own size and its tensor's
RMS, |got - want| <= rtol |want| + atol rms(want) with (rtol, atol)
(2^-7, 1e-2) at bf16 and (1e-5, 1e-5) at f32, so no rows can be wrong
under the cover of a large maximum.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import attention as pa

from paddle_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: with two, the first parallel
    `torch.exp` of a process (torch 2.13, CPU) computes part of its
    tensor at about 1e-4 relative error in a few processes of a hundred,
    which the f32 comparisons here (1e-5) would read as a fault of the
    plain version."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = {"float32": 1e-5, "bfloat16": 8e-3}
ELEM_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SCALE = 0.125


def _inputs(T, dtype, seed, B=1, N=2, H=64):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(B, T, N, H).astype(np.float32) for _ in range(4)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tt = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]
    return jx, tt


def _rel(want, got):
    want = np.asarray(want, np.float32)
    got = got.float().detach().numpy()
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


def _held(want, got, dtype):
    """The worst element's error over its ELEM_TOL limit (<= 1 passes)."""
    rtol, atol = ELEM_TOL[dtype]
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().detach().numpy() - want)
    rms = np.sqrt(np.mean(np.square(want)))
    return float((err / (rtol * np.abs(want) + atol * rms)).max())


def _function_grads(q, k, v, do, causal):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(q, k, v, SCALE, causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    return out, torch.autograd.grad(out, (q, k, v), do)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [128, 256])
def test_backward_matches_splash_vjp_interpret(T, dtype, causal):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(T, dtype, seed=T + causal)
    want_out, vjp = jax.vjp(
        lambda a, b, c: pa._splash_mha(a, b, c, SCALE, causal,
                                       interpret=True), jq, jk, jv)
    want = vjp(jdo)
    out, got = _function_grads(q, k, v, do, causal)
    assert _rel(want_out, out) <= TOL[dtype]
    assert _held(want_out, out, dtype) <= 1.0
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert g.dtype == TORCH_DT[dtype]
        assert _rel(w, g) <= TOL[dtype], name
        assert _held(w, g, dtype) <= 1.0, name


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_autograd_of_the_forward(causal):
    """At f32 the explicit backward equals torch autograd through the
    plain forward; the wrappers on CPU tensors are the plain versions
    and launch nothing."""
    _, (q, k, v, do) = _inputs(100, "float32", seed=11 + causal, B=2)
    counted = (fa.flash_attention_with_lse, fa.attention_delta,
               fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    launches = [f.launches for f in counted]
    _, got = _function_grads(q, k, v, do, causal)
    assert [f.launches for f in counted] == launches
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    ref = fa.flash_attention_ref(qa, ka, va, SCALE, causal)
    want = torch.autograd.grad(ref, (qa, ka, va), do)
    for w, g in zip(want, got):
        assert _rel(w.numpy(), g) <= 1e-5
    # the composed plain version, from the saved output and LSE
    out, lse = fa.flash_attention_ref(q, k, v, SCALE, causal, with_lse=True)
    for w, g in zip(got, fa.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                    SCALE, causal)):
        assert torch.equal(w, g)


def test_external_delta_skips_nothing_else():
    """A caller holding delta (the ring's interface) calls the dkv and
    dq steps itself and gets the gradients of the whole backward."""
    _, (q, k, v, do) = _inputs(128, "float32", seed=5)
    out, lse = fa.flash_attention_ref(q, k, v, SCALE, True, with_lse=True)
    delta = fa.attention_delta(out, do)
    assert torch.allclose(delta, (out * do).sum(-1).transpose(1, 2),
                          atol=1e-5)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, SCALE, True)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, SCALE, True)
    whole = fa.flash_attention_bwd(q, k, v, out, lse, do, SCALE, True)
    for x, y in zip(whole, (dq, dk, dv)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dq_with_o_equals_the_external_delta_form(dtype, causal):
    """dq given the forward's output in place of delta (the form whose
    bf16 and f16 kernel folds the delta pass in) returns (dq, delta):
    delta is `attention_delta_ref`'s and dq the external-delta form's,
    bit for bit, in the wrapper and the plain version; on CPU tensors
    nothing launches."""
    _, (q, k, v, do) = _inputs(100, dtype, seed=21 + causal, B=2)
    out, lse = fa.flash_attention_ref(q, k, v, SCALE, causal, with_lse=True)
    counts = (fa.attention_delta.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dq.delta_folds)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, do, lse, None, SCALE,
                                          causal, o=out)
    assert (fa.attention_delta.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dq.delta_folds) == counts
    want_delta = fa.attention_delta_ref(out, do)
    assert delta.dtype == torch.float32 and torch.equal(delta, want_delta)
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, do, lse,
                                                     want_delta, SCALE, causal))
    ref_dq, ref_delta = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, None,
                                                      SCALE, causal, o=out)
    assert torch.equal(dq, ref_dq) and torch.equal(delta, ref_delta)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_launch_backward_matches_splash_vjp_interpret(dtype, causal):
    """The backward as the kernels run it at bf16 and f16, dq first
    (computing delta from the output), then dkv from that delta, against
    jax.vjp of splash in interpret mode, at the limits above."""
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(128, dtype, seed=31 + causal)
    _, vjp = jax.vjp(
        lambda a, b, c: pa._splash_mha(a, b, c, SCALE, causal,
                                       interpret=True), jq, jk, jv)
    want = vjp(jdo)
    out, lse = fa.flash_attention_ref(q, k, v, SCALE, causal, with_lse=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, do, lse, None, SCALE,
                                          causal, o=out)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, SCALE,
                                        causal)
    for name, w, g in zip(("dq", "dk", "dv"), want, (dq, dk, dv)):
        assert g.dtype == TORCH_DT[dtype]
        assert _rel(w, g) <= TOL[dtype], name
        assert _held(w, g, dtype) <= 1.0, name


def test_dq_takes_delta_or_the_output():
    """The dq wrapper takes exactly one of delta and o, and an o of q's
    shape and dtype."""
    _, (q, k, v, do) = _inputs(16, "float32", seed=2)
    out, lse = fa.flash_attention_ref(q, k, v, SCALE, True, with_lse=True)
    delta = fa.attention_delta_ref(out, do)
    for d, o in ((delta, out), (None, None), (None, out[:, :8]),
                 (None, out.to(torch.bfloat16))):
        with pytest.raises(ValueError, match="delta|o must be"):
            fa.flash_attention_bwd_dq(q, k, v, do, lse, d, SCALE, o=o)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_forward_matches_splash_block_with_lse(dtype):
    """K3's forward: full mask, q pre-scaled (scale 1.0)."""
    (jq, jk, jv, _), (q, k, v, _) = _inputs(128, dtype, seed=3, B=2)
    want_out, want_lse = pa._splash_block_with_lse(jq, jk, jv,
                                                   interpret=True)
    out, lse = fa.flash_attention_with_lse(q, k, v)
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 128)
    assert _rel(want_out, out) <= TOL[dtype]
    assert float(np.abs(np.asarray(want_lse) - lse.numpy()).max()) <= 1e-5


def test_backward_wrappers_reject_bad_residuals():
    _, (q, k, v, do) = _inputs(16, "float32", seed=1)
    out, lse = fa.flash_attention_ref(q, k, v, SCALE, True, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, out, lse[:, :1], do, SCALE)
    with pytest.raises(ValueError, match="do"):
        fa.flash_attention_bwd_dq(q, k, v, do[:, :8], lse, lse, SCALE)
