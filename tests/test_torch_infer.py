"""The port's inference models and their int8 path against the JAX
package, on the same numpy inputs and parameters.

- `quantize_conv_weights_int8` equals the JAX package's bit for bit
  (int8 values and f32 scales), a zero output channel included (its
  scale is 1.0 and its values 0).
- `conv2d_nhwc_int8` equals the JAX package's bit for bit at f32: the
  same activation scale, the same int8 activation, an exact int32 sum
  either way, and the same f32 dequantization order. Through
  `conv2d_nhwc_auto` at bf16 both cast the same f32 result to bf16, so
  they agree within one bf16 step (2^-7 relative; measured equal).
- `int8_matmul`'s plain version and its padding route equal an int64
  numpy product exactly. The padding route runs on the card only
  (`_int_mm`); here its padding and slicing are held with a stand-in
  for `_int_mm` (an int32 product that enforces `_int_mm`'s operand
  rules), so every padded case is checked.
- `maxpool2x2_nhwc` equals the JAX package's (a max is exact).
- VGG `tiny()` at f32 and with int8 weights, and ResNet `tiny()` eval
  with int8 weights, against the JAX package on the same params. f32
  logits of the f32 VGG differ only by the order of f32 sums in the
  convs and products (measured 1.3e-6 of the largest logit; held to
  1e-5). With int8 weights every conv's integer product is exact, but
  the activations between convs carry f32 rounding of the bias, ReLU
  and BN, and a value that lands on a rounding boundary of the next
  layer's quantization moves by one int8 step: measured under 1e-5 of
  the largest logit, held to 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from paddle_tpu.models import common as jcommon
from paddle_tpu.models import resnet as jres
from paddle_tpu.models import vgg as jvgg

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import common as tcommon
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.models import vgg as tvgg
from paddle_tpu_torch.ops import int8 as tint8

torch.set_num_threads(2)

MODEL_TOL = {"f32": 1e-5, "int8": 1e-4}


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(rs, kh, kw, cin, cout, zero_channel=None):
    w = rs.normal(0, 0.2, (kh, kw, cin, cout)).astype(np.float32)
    if zero_channel is not None:
        w[..., zero_channel] = 0.0
    return w


def test_quantize_conv_weights_matches_jax_bit_for_bit():
    rs = np.random.RandomState(0)
    params = {"a.w": _weights(rs, 3, 3, 4, 6, zero_channel=2),
              "b.w": _weights(rs, 1, 1, 6, 5),
              "fc.w": rs.normal(size=(6, 3)).astype(np.float32),
              "a.b": rs.normal(size=(6,)).astype(np.float32)}
    want = jcommon.quantize_conv_weights_int8(
        {k: jnp.asarray(v) for k, v in params.items()})
    got = tcommon.quantize_conv_weights_int8(
        {k: _t(v) for k, v in params.items()})
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["a.w@scale"][2].item() == 1.0
    assert not got["a.w"][..., 2].any()


CONV_CASES = [  # (name, x NHWC, w HWIO, stride, padding)
    ("same_s1", (2, 9, 9, 5), (3, 3, 5, 7), 1, "SAME"),
    ("same_s2", (2, 10, 10, 5), (3, 3, 5, 7), 2, "SAME"),
    ("valid", (2, 9, 8, 5), (3, 3, 5, 7), 1, "VALID"),
    ("proj_1x1_s2", (2, 8, 8, 6), (1, 1, 6, 12), 2, "SAME"),
    ("stem_cin3", (2, 16, 16, 3), (7, 7, 3, 8), 2, "SAME"),
]


@pytest.mark.parametrize("name,xs,ws,stride,padding", CONV_CASES,
                         ids=[c[0] for c in CONV_CASES])
def test_conv2d_nhwc_int8_matches_jax(name, xs, ws, stride, padding):
    rs = np.random.RandomState(len(name))
    x = rs.normal(0, 1, xs).astype(np.float32)
    params = {"c.w": _weights(rs, *ws)}
    jq = jcommon.quantize_conv_weights_int8(
        {k: jnp.asarray(v) for k, v in params.items()})
    tq = tcommon.quantize_conv_weights_int8(
        {k: _t(v) for k, v in params.items()})
    want = np.asarray(jcommon.conv2d_nhwc_int8(
        jnp.asarray(x), jq["c.w"], jq["c.w@scale"], stride, padding))
    got = tcommon.conv2d_nhwc_int8(_t(x), tq["c.w"], tq["c.w@scale"],
                                   stride, padding)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # bf16 activations through the dispatching conv: one bf16 step
    wb = np.asarray(jcommon.conv2d_nhwc_auto(
        jq, "c", jnp.asarray(x, jnp.bfloat16), stride,
        padding).astype(jnp.float32))
    gb = tcommon.conv2d_nhwc_auto(tq, "c", _t(x).to(torch.bfloat16),
                                  stride, padding)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), wb, rtol=2 ** -7,
                               atol=1e-30)


class _IntMMStandIn:
    """`torch._int_mm`'s operand rules around an int32 product: records
    every call's shapes."""

    def __init__(self):
        self.calls = []

    def __call__(self, a, b):
        assert a.dtype == b.dtype == torch.int8
        M, K = a.shape
        assert M > 16 and K % 8 == 0 and b.shape[1] % 8 == 0, \
            (a.shape, b.shape)
        self.calls.append((tuple(a.shape), tuple(b.shape)))
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))


MM_SHAPES = [(5, 27, 13), (16, 147, 64), (3, 8, 8), (40, 64, 10),
             (1, 1, 1)]


@pytest.mark.parametrize("M,K,N", MM_SHAPES,
                         ids=[f"{m}x{k}x{n}" for m, k, n in MM_SHAPES])
def test_int8_matmul_padding_route_is_exact(M, K, N, monkeypatch):
    rs = np.random.RandomState(M * K + N)
    a = rs.randint(-127, 128, (M, K)).astype(np.int8)
    b = rs.randint(-127, 128, (K, N)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    plain = tint8.int8_matmul(_t(a), _t(b))
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    # the card's route, with a stand-in for _int_mm and a device check
    # that takes these CPU tensors for CUDA ones
    stand_in = _IntMMStandIn()
    monkeypatch.setattr(torch, "_int_mm", stand_in)
    monkeypatch.setattr(tint8, "_on_card", lambda t: True)
    padded = tint8.int8_matmul(_t(a), _t(b))
    assert len(stand_in.calls) == 1
    (am, ak), (bk, bn) = stand_in.calls[0]
    assert am == max(M, 17) and ak == bk == -(-K // 8) * 8 and \
        bn == -(-N // 8) * 8
    assert tuple(padded.shape) == (M, N)
    np.testing.assert_array_equal(padded.numpy(), want)


def test_conv2d_int8_groups_and_dilation_match_a_float_conv():
    """Groups and dilation (the fluid op's cases) against F.conv2d on
    the same integers in f64, which is exact at these sizes."""
    rs = np.random.RandomState(3)
    x = rs.randint(-127, 128, (2, 11, 10, 6)).astype(np.int8)
    w = rs.randint(-127, 128, (3, 3, 3, 8)).astype(np.int8)
    got = tint8.conv2d_int8(_t(x), _t(w), stride=(2, 1),
                            padding=((1, 2), (0, 1)), dilation=2, groups=2)
    xf = F.pad(_t(x).double().permute(0, 3, 1, 2), (0, 1, 1, 2))
    want = F.conv2d(xf, _t(w).double().permute(3, 2, 0, 1), stride=(2, 1),
                    dilation=2, groups=2).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.int64))


def test_maxpool2x2_matches_jax():
    x = np.random.RandomState(4).normal(size=(2, 9, 8, 3)).astype(
        np.float32)
    want = np.asarray(jcommon.maxpool2x2_nhwc(jnp.asarray(x)))
    got = tcommon.maxpool2x2_nhwc(_t(x))
    np.testing.assert_array_equal(got.numpy(), want)


def _gap(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_vgg_tiny_matches_jax(precision):
    jcfg = dataclasses.replace(jvgg.VGGConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tvgg.VGGConfig.tiny(), dtype="float32")
    jparams, _ = jvgg.init(jax.random.key(0), jcfg)
    if precision == "int8":
        jparams = jcommon.quantize_conv_weights_int8(jparams)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    g = torch.Generator().manual_seed(0)
    fresh, _ = tvgg.init(g, tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in jvgg.init(
            jax.random.key(0), jcfg)[0].items()}
    img = np.random.RandomState(5).normal(size=(3, 3, 32, 32)).astype(
        np.float32)
    want = np.asarray(jvgg.apply(jparams, jcfg, jnp.asarray(img)))
    got = tvgg.apply(tparams, tcfg, _t(img))
    assert got.dtype == torch.float32 and got.shape == want.shape
    gap = _gap(got.numpy(), want)
    print(f"vgg tiny {precision}: {gap:.3g} of the largest logit")
    assert gap <= MODEL_TOL[precision]


def test_resnet_tiny_eval_int8_matches_jax():
    jcfg = dataclasses.replace(jres.ResNetConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tres.ResNetConfig.tiny(), dtype="float32")
    jparams, _ = jres.init(jax.random.key(1), jcfg)
    jparams = jcommon.quantize_conv_weights_int8(jparams)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    img = np.random.RandomState(6).normal(size=(4, 3, 32, 32)).astype(
        np.float32)
    want, _ = jres.apply(jparams, jcfg, jnp.asarray(img), train=False)
    got, upd = tres.apply(tparams, tcfg, _t(img), train=False)
    assert not upd
    gap = _gap(got.numpy(), np.asarray(want))
    print(f"resnet tiny int8 eval: {gap:.3g} of the largest logit")
    assert gap <= MODEL_TOL["int8"]


def test_params_from_numpy_keeps_int8_weights_and_f32_scales():
    q = tcommon.quantize_conv_weights_int8(
        {"c.w": _t(_weights(np.random.RandomState(7), 3, 3, 2, 4)),
         "c.b": torch.zeros(4)})
    out = params_from_numpy({k: v.numpy() for k, v in q.items()}, "cpu",
                            dtype=torch.bfloat16)
    assert out["c.w"].dtype == torch.int8
    assert out["c.w@scale"].dtype == torch.float32
    assert out["c.b"].dtype == torch.bfloat16
    assert torch.equal(out["c.w@scale"], q["c.w@scale"])
