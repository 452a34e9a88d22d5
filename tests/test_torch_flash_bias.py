"""K2's plain versions against the JAX package's K2 itself.

`flash_attention_bias` under grad runs the `FlashAttentionBias`
autograd Function; on CPU tensors its forward is
`flash_attention_bias_ref` and its backward
`flash_attention_bias_bwd_dq_ref` (computing delta from the output, as
the bf16 and f16 kernel does in its prologue) and then
`flash_attention_bias_bwd_dkv_ref` from that delta, the step-for-step
plain versions of the kernels that the card holds
the kernels against (tests/test_torch_cuda.py, chip_smoke.py). Here the
output and the gradients of q, k, v and the mask are held against
`jax.vjp` of the JAX package's `_pallas_mha` (jax's legacy Pallas
flash attention, its kernels run in TPU interpret mode on the CPU) at
the shapes it takes (T and Tk multiples of 128), and against
`_xla_mha`, what the JAX package runs at every other shape.

Tolerances, per element: |got - want| <= rtol |want| + atol rms(want).
At f32 (1e-5, 1e-5): the same f32 arithmetic summed in other orders.
At bf16 (2^-7, 2e-2), K1's bf16 limits on the card: one bf16 step of
the element, and a share of the tensor's RMS for a rounding of p or ds
that falls the other way after f32 sums in another order. Against
`_xla_mha` (f32 only): its logits are `q k^T * scale + mask` where K2's
are `(q k^T + mask) * scale`, equal where the mask is 0, and padded
keys get no weight either way.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.ops.pallas import attention as pa

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import flash_attention_bias as fb
from paddle_tpu_torch.ops import attention as ta

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module, as tests/test_torch_flash_bwd.py
    (ROADMAP.md §3): the first parallel `torch.exp` of a process is
    sometimes inexact on two threads, which the f32 limits would read as
    a fault of the plain version."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ELEM_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SCALE = 0.125


def _inputs(T, Tk, dtype, seed, B=2, N=2, H=64):
    """q, do [B, T, N, H], k, v [B, Tk, N, H] and a key-padding mask
    [B, 1, 1, Tk] (the second row padded from 2/3 of Tk on), as jnp and
    torch arrays made from the same numpy values."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(B, t, N, H).astype(np.float32) for t in (T, Tk, Tk, T)]
    lens = np.array([Tk, max(1, 2 * Tk // 3)])[:B]
    mask = np.where(np.arange(Tk)[None] < lens[:, None], 0.0, -1e9) \
        .astype(np.float32)[:, None, None, :]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs] + [jnp.asarray(mask)]
    tt = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs] + \
        [torch.from_numpy(mask)]
    return jx, tt


def _held(want, got, dtype):
    """The worst element's error over its ELEM_TOL limit (<= 1 passes)."""
    rtol, atol = ELEM_TOL[dtype]
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got.float().detach().numpy() - want)
    rms = np.sqrt(np.mean(np.square(want)))
    return float((err / (rtol * np.abs(want) + atol * rms)).max())


def _port(q, k, v, do, mask, causal):
    """out and (dq, dk, dv, dmask) through the port's Function."""
    q, k, v, mask = (t.clone().requires_grad_() for t in (q, k, v, mask))
    out = fb.flash_attention_bias(q, k, v, mask, SCALE, causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBiasBackward"
    return out, torch.autograd.grad(out, (q, k, v, mask), do)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,Tk", [(128, 128), (128, 256)])
def test_matches_pallas_flash_attention_interpret(T, Tk, dtype, causal):
    (jq, jk, jv, jdo, jm), (q, k, v, do, m) = _inputs(T, Tk, dtype,
                                                      seed=T + Tk + causal)
    # the legacy kernel's causal index maps mix int32 and int64 under
    # x64, which the test harness enables: run it as jax's default
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        want_out, vjp = jax.vjp(
            lambda a, b, c, d: pa._pallas_mha(a, b, c, d, SCALE, causal),
            jq, jk, jv, jm)
        want = vjp(jdo)
    out, got = _port(q, k, v, do, m, causal)
    assert out.dtype == TORCH_DT[dtype]
    assert _held(want_out, out, dtype) <= 1.0
    for name, w, g in zip(("dq", "dk", "dv", "dmask"), want, got):
        assert g.shape == tuple(w.shape), name
        assert _held(w, g, dtype) <= 1.0, name


@pytest.mark.parametrize("T,Tk,causal", [(100, 100, True), (100, 164, False),
                                         (32, 128, False), (16, 16, True)])
def test_matches_xla_mha_where_the_reference_refuses(T, Tk, causal):
    """Ragged T, Tq != Tk (the beam search's 32 against 128) and T = 16:
    shapes `_pallas_mha` refuses (blocks of 128), where the JAX package
    runs `_xla_mha`. That path adds the mask after the scale, K2 before
    it, so K2's mask gradient is `_xla_mha`'s times the scale."""
    (jq, jk, jv, jdo, jm), (q, k, v, do, m) = _inputs(T, Tk, "float32",
                                                      seed=T + Tk)

    def xla(a, b, c, d):
        mask = pa._merge_causal(d, T) if causal else d
        return pa._xla_mha(a, b, c, mask, SCALE)

    want_out, vjp = jax.vjp(xla, jq, jk, jv, jm)
    want = vjp(jdo)
    out, got = _port(q, k, v, do, m, causal)
    assert _held(want_out, out, "float32") <= 1.0
    want = want[:3] + (want[3] * SCALE,)
    for name, w, g in zip(("dq", "dk", "dv", "dmask"), want, got):
        assert _held(w, g, "float32") <= 1.0, name


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_autograd_of_the_plain_forward(causal):
    """At f32 the explicit backward equals torch autograd through the
    plain forward, for a full [B, N, T, Tk] bias too, within 1e-5 of the
    largest value (ds cancels to about 1e-7 where autograd gives 0);
    the wrappers on CPU tensors are the plain versions and launch
    nothing."""
    _, (q, k, v, do, _) = _inputs(100, 164 if not causal else 100,
                                  "float32", seed=3)
    rs = np.random.RandomState(4)
    bias = torch.from_numpy(rs.randn(2, 2, 100, k.shape[1])
                            .astype(np.float32))
    counted = (fb.flash_attention_bias_fwd, fa.attention_delta,
               fb.flash_attention_bias_bwd_dkv, fb.flash_attention_bias_bwd_dq)
    launches = [f.launches for f in counted]
    _, got = _port(q, k, v, do, bias, causal)
    assert [f.launches for f in counted] == launches
    qa, ka, va, ba = (t.clone().requires_grad_() for t in (q, k, v, bias))
    ref = fb.flash_attention_bias_ref(qa, ka, va, ba, SCALE, causal)[0]
    want = torch.autograd.grad(ref, (qa, ka, va, ba), do)
    for name, w, g in zip(("dq", "dk", "dv", "dbias"), want, got):
        err = (w - g).abs().max() / w.abs().max().clamp(min=1.0)
        assert err <= 1e-5, name


def test_bias_gets_a_gradient_only_when_it_requires_one():
    _, (q, k, v, do, m) = _inputs(64, 64, "float32", seed=5)
    qa = q.clone().requires_grad_()
    out = fb.flash_attention_bias(qa, k, v, m, SCALE)
    (dq,) = torch.autograd.grad(out, (qa,), do)
    assert m.grad is None and torch.isfinite(dq).all()
    # the explicit dq launch with and without the bias gradient
    o, l, mx = fb.flash_attention_bias_ref(q, k, v, m, SCALE)
    delta = fa.attention_delta(o, do)
    dq1 = fb.flash_attention_bias_bwd_dq(q, k, v, m, do, l, mx, delta, SCALE)
    dq2, ds = fb.flash_attention_bias_bwd_dq(q, k, v, m, do, l, mx, delta,
                                             SCALE, with_dbias=True)
    assert torch.equal(dq1, dq2)
    assert ds.shape == (2, 2, 64, 64) and ds.dtype == torch.float32
    # padded keys (the second row from 42 on) get no weight: ds is 0
    assert (ds[1, :, :, 42:] == 0).all()


@pytest.mark.parametrize("with_dbias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dq_with_o_equals_the_external_delta_form(dtype, with_dbias):
    """dq given the forward's output in place of delta (the form whose
    bf16 and f16 kernel folds the delta pass in) returns delta last:
    `attention_delta_ref`'s, with dq (and the bias gradient) the
    external-delta form's, bit for bit, in the wrapper and the plain
    version; on CPU tensors nothing launches."""
    _, (q, k, v, do, m) = _inputs(100, 164, dtype, seed=8)
    o, l, mx = fb.flash_attention_bias_ref(q, k, v, m, SCALE)
    counts = (fa.attention_delta.launches,
              fb.flash_attention_bias_bwd_dq.launches,
              fb.flash_attention_bias_bwd_dq.delta_folds)
    got = fb.flash_attention_bias_bwd_dq(q, k, v, m, do, l, mx, None, SCALE,
                                         with_dbias=with_dbias, o=o)
    assert (fa.attention_delta.launches,
            fb.flash_attention_bias_bwd_dq.launches,
            fb.flash_attention_bias_bwd_dq.delta_folds) == counts
    want_delta = fa.attention_delta_ref(o, do)
    want = fb.flash_attention_bias_bwd_dq(q, k, v, m, do, l, mx, want_delta,
                                          SCALE, with_dbias=with_dbias)
    want = want if with_dbias else (want,)
    assert len(got) == len(want) + 1
    assert got[-1].dtype == torch.float32 and torch.equal(got[-1], want_delta)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ref = fb.flash_attention_bias_bwd_dq_ref(
        q, k, v, m.expand(2, 2, 100, 164), do, l, mx, None, SCALE,
        with_dbias=with_dbias, o=o)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_launch_backward_matches_pallas_flash_attention(dtype, causal):
    """The backward as the kernels run it at bf16 and f16, dq first
    (computing delta from the output, with the mask's gradient), then
    dkv from that delta, against jax.vjp of `_pallas_mha` in TPU
    interpret mode, per element at the limits above."""
    (jq, jk, jv, jdo, jm), (q, k, v, do, m) = _inputs(128, 128, dtype,
                                                      seed=40 + causal)
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        _, vjp = jax.vjp(
            lambda a, b, c, d: pa._pallas_mha(a, b, c, d, SCALE, causal),
            jq, jk, jv, jm)
        want = vjp(jdo)
    o, l, mx = fb.flash_attention_bias_ref(q, k, v, m, SCALE, causal)
    dq, ds, delta = fb.flash_attention_bias_bwd_dq(
        q, k, v, m, do, l, mx, None, SCALE, causal, with_dbias=True, o=o)
    dk, dv = fb.flash_attention_bias_bwd_dkv(q, k, v, m, do, l, mx, delta,
                                             SCALE, causal)
    got = (dq, dk, dv, ds.sum_to_size(m.shape))
    for name, w, g in zip(("dq", "dk", "dv", "dmask"), want, got):
        assert g.shape == tuple(w.shape), name
        assert _held(w, g, dtype) <= 1.0, name


def test_masked_mha_on_cpu_takes_the_plain_path():
    """A masked CPU `mha` is the mirror of `_xla_mha`, not K2's plain
    version: the dispatch is by device, and CUDA tensors alone reach the
    K2 wrappers."""
    (jq, jk, jv, _, jm), (q, k, v, _, m) = _inputs(40, 40, "float32", seed=6)
    ta.GATE_COUNTS.clear()
    before = fb.flash_attention_bias_fwd.launches
    got = ta.mha(q, k, v, mask=m, scale=SCALE)
    assert dict(ta.GATE_COUNTS) == {"plain": 1}
    assert fb.flash_attention_bias_fwd.launches == before
    want = pa._xla_mha(jq, jk, jv, jm, SCALE)
    assert _held(want, got, "float32") <= 1.0


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, (q, k, v, do, m) = _inputs(16, 16, "float32", seed=7)
    with pytest.raises(ValueError, match="broadcast"):
        fb.flash_attention_bias(q, k, v, m[:, :, :, :8], SCALE)
    with pytest.raises(ValueError, match="4-d"):
        fb.flash_attention_bias(q, k, v, m[:, 0, 0], SCALE)
    o, l, mx = fb.flash_attention_bias_ref(q, k, v, m, SCALE)
    with pytest.raises(ValueError, match="delta"):
        fb.flash_attention_bias_bwd_dkv(q, k, v, m, do, l, mx, l[:, :1],
                                        SCALE)
    with pytest.raises(ValueError, match="do"):
        fb.flash_attention_bias_bwd_dq(q, k, v, m, do[:, :8], l, mx, l,
                                       SCALE)
    x = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="head_dim"):
        fb.flash_attention_bias(x, x, x, torch.zeros(1, 1, 1, 16), SCALE)
