"""The arithmetic of the bf16/f16 Hopper kernels, emulated in plain torch
on the CPU: K1-fwd (and K3, its LSE form) in `csrc/flash_attention.cu`,
K2-fwd in `csrc/flash_attention_bias.cu`, K1-bwd's dkv and dq in
`csrc/flash_attention_bwd.cu` and K2-bwd's in
`csrc/flash_attention_bias_bwd.cu`. The kernels run only on
the card (tests/test_torch_cuda.py, `chip_smoke.py`); these tests hold
the choices of their design against the plain versions and the JAX
package, at the limits the card holds the kernels to.

What the emulations repeat of the kernels:
- K1: q scaled and rounded to its dtype; f32 scores; keys in tiles of
  128 with a running max; p = exp(s - running max) in f32; the product
  with v takes p as two 16-bit parts, hi = round(p) and lo = round(p -
  hi), because wgmma multiplies 16-bit operands only and the JAX
  package's splash multiplies its f32 p by v in f32
  (`splash_attention_kernel.py`, `v.astype(float32)` before the
  product); l sums the f32 p; out = acc / l.
- K2: f32 scores of the unscaled q plus the bias, times the scale; the
  reference's one-step softmax where the keys fit one 128-key block
  (round(p / l) @ v); beyond, an unnormalised accumulator of round(p)
  @ v rescaled by exp(m - m_next) and divided by l once, where the
  reference renormalises on every block.
- K1-bwd: P = exp(S - lse) and dS = P (dP - delta) in f32, each rounded
  to the input dtype before its product (dV += round(P)^T dO, dK +=
  round(dS)^T q_scaled, dQ += round(dS) k), as jax's splash backward
  rounds them (`p.astype`, `ds.astype`): so the 16-bit A operand of
  wgmma is its rounding exactly. The plain versions
  (`flash_attention_bwd_dkv_ref`, `flash_attention_bwd_dq_ref`) round at
  those points, and are that emulation.
- K2-bwd: p = exp(s - m) / l from the forward's l and m, ds = (dp -
  delta) p scale, each rounded to the input dtype before its products
  (dV += round(p)^T dO, dK += round(ds)^T q, dQ += round(ds) k, q
  unscaled), as jax's legacy flash backward rounds them; the products'
  sums, which the kernels take on the tensor cores in another order
  than the plain versions' f32 GEMMs, in f64 (`probe_sm90.k2_bwd_f64`).

Limits. Against the plain versions `chip_smoke.py`'s ELEM_TOL: every
element within rtol |want| + atol rms(want), (2^-7, 2e-2) at bf16 and
(2^-10, 1e-3) at f16; l within 1e-5 relative, m and the LSE within 1e-4.
Against splash, `test_torch_flash_bwd.py`'s (2^-7, 1e-2) at bf16.
The f16 attention limit where ELEM_TOL's lies below the plain
version's own f32 noise (K1-bwd's f16 gradients, K2's f16 causal case:
ROADMAP F4), `chip_smoke.py`'s ATTN_F16_TOL (2^-10, 3e-3), is shown to
fail an evaluation that rounds P and dS to bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import attention as pa

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import flash_attention_bias as fb
from paddle_tpu_torch.kernels.probe_sm90 import (bwd_f64, k2_bwd_f64,
                                                  k2_fwd_f64)

from chip_smoke import ATTN_F16_TOL

torch.set_num_threads(1)

BK = 128
ELEM_TOL = {torch.bfloat16: (2 ** -7, 2e-2), torch.float16: (2 ** -10, 1e-3)}
SPLASH_TOL = (2 ** -7, 1e-2)


def _held(got, want, tol):
    """The worst element's error over its limit (at most 1 passes)."""
    rtol, atol = tol
    want = want.float()
    err = (got.float() - want).abs()
    rms = want.square().mean().sqrt()
    return (err / (rtol * want.abs() + atol * rms)).max().item()


def _pv(p, v, split):
    """p [B, N, T, K] times v [B, K, N, H] in f32, p rounded to v's dtype
    once or as hi + lo."""
    hi = p.to(v.dtype).float()
    out = torch.einsum("bnts,bsnh->bnth", hi, v.float())
    if split:
        lo = (p - hi).to(v.dtype).float()
        out = out + torch.einsum("bnts,bsnh->bnth", lo, v.float())
    return out


def k1_emulated(q, k, v, scale, causal, split=True):
    """K1-fwd's arithmetic: (out, lse)."""
    s = fa._logits(q, k, scale, causal)
    B, N, T, Tk = s.shape
    m = torch.full((B, N, T, 1), float("-inf"))
    l = torch.zeros(B, N, T, 1)
    acc = torch.zeros(B, N, T, q.shape[-1])
    for k0 in range(0, Tk, BK):
        st = s[..., k0:k0 + BK]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        ms = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp(m - ms)
        p = torch.exp(st - ms)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _pv(p, v[:, k0:k0 + BK], split)
        m = m_new
    out = (acc / l).transpose(1, 2).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def k2_emulated(q, k, v, bias, scale, causal):
    """K2-fwd's arithmetic: (out, l, m)."""
    Tk = k.shape[1]
    if Tk <= BK:   # the reference's one-step kernel, as the kernel runs it
        return fb.flash_attention_bias_ref(q, k, v, bias, scale, causal)
    s = fb._scores(q, k, bias, scale, causal)
    B, N, T, _ = s.shape
    m = torch.full((B, N, T, 1), float("-inf"))
    l = torch.zeros(B, N, T, 1)
    acc = torch.zeros(B, N, T, q.shape[-1])
    rows = torch.arange(T)[None, None, :, None]
    for k0 in range(0, Tk, BK):
        # causal: a query block of 128 rows skips the key blocks above it
        run = (k0 < (rows // BK + 1) * BK) if causal else \
            torch.ones((), dtype=torch.bool)
        st = s[..., k0:k0 + BK]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l_new = l * alpha + p.sum(-1, keepdim=True)
        acc_new = acc * alpha + _pv(p, v[:, k0:k0 + BK], split=False)
        m, l, acc = (torch.where(run, a, b) for a, b in
                     ((m_new, m), (l_new, l), (acc_new, acc)))
    out = (acc * torch.where(l == 0, 1.0, 1.0 / l)).transpose(1, 2)
    return out.to(q.dtype), l[..., 0], m[..., 0]


def _qkv(B, T, Tk, N, H, dtype, seed):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(B, t, N, H).astype(np.float32) for t in (T, Tk, Tk)]
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


# (B, T, Tk, N, H, causal, dtype): the serving and training shapes cut
# in batch, a ragged causal T, K3's block (T = Tk = 1024, scale 1 on a
# pre-scaled q), H 128, and f16
K1_CASES = [(1, 512, 512, 2, 64, True, torch.bfloat16),
            (4, 128, 128, 2, 64, False, torch.bfloat16),
            (2, 100, 100, 2, 64, True, torch.bfloat16),
            (1, 1024, 1024, 2, 64, False, torch.bfloat16),
            (2, 300, 200, 2, 128, False, torch.bfloat16),
            (1, 1024, 1024, 2, 64, False, torch.float16),
            (2, 256, 256, 2, 64, True, torch.float16)]


@pytest.mark.parametrize("B,T,Tk,N,H,causal,dtype", K1_CASES)
def test_k1_arithmetic_matches_its_plain_version(B, T, Tk, N, H, causal,
                                                 dtype):
    _, (q, k, v) = _qkv(B, T, Tk, N, H, dtype, seed=T + H + causal)
    scale = 1.0 if T == 1024 else 0.125
    out, lse = k1_emulated(q, k, v, scale, causal)
    want, want_lse = fa.flash_attention_ref(q, k, v, scale, causal,
                                            with_lse=True)
    assert _held(out, want, ELEM_TOL[dtype]) <= 1.0
    assert (lse - want_lse).abs().max().item() <= 1e-4


def _beyond_one_step(got, want):
    """The largest error beyond one bf16 rounding step of the element,
    in units of want's RMS."""
    want = want.float()
    err = (got.float() - want).abs()
    return ((err - 2 ** -7 * want.abs()).clamp(min=0).max()
            / want.square().mean().sqrt()).item()


@pytest.mark.parametrize("causal", [False, True])
def test_split_p_keeps_the_gap_to_splash(causal):
    """At bf16 against splash in interpret mode (f32 p times v): with p
    split into hi + lo the output is within splash's limits, no element
    is more than 1e-4 of the RMS beyond one rounding step (measured:
    4e-6), and fewer than 1% of the elements differ at all (0.2%); a p
    rounded once to bf16 moves 36-41% of them, up to 4e-3 to 1e-2 of the
    RMS beyond one step (T 256 and 1024), ten times the split's gap and
    more."""
    T = 256
    arrs, (q, k, v) = _qkv(1, T, T, 2, 64, torch.bfloat16, seed=30 + causal)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    want = torch.from_numpy(np.asarray(
        pa._splash_mha(jq, jk, jv, 0.125, causal, interpret=True),
        np.float32))
    split = k1_emulated(q, k, v, 0.125, causal)[0]
    once = k1_emulated(q, k, v, 0.125, causal, split=False)[0]
    assert _held(split, want, SPLASH_TOL) <= 1.0
    gap = _beyond_one_step(split, want)
    assert gap <= 1e-4
    assert (split.float() != want).float().mean().item() < 0.01
    assert _beyond_one_step(once, want) > max(10 * gap, 1e-3)


def _bwd_unrounded(q, k, v, do, lse, delta, scale, causal):
    """K1-bwd with P and dS kept in f32 through their products: what a
    kernel that did not round at splash's points would compute."""
    p, ds = fa._p_ds(q, k, v, do, lse, delta, scale, causal)
    dt = q.dtype
    dv = torch.einsum("bnts,btnh->bsnh", p, do.float()).to(dt)
    dk = torch.einsum("bnts,btnh->bsnh", ds,
                      fa._scaled(q, scale).float()).to(dt)
    dq = torch.einsum("bnts,bsnh->btnh", ds, k.float()).to(dt)
    return fa._scaled(dq, scale), dk, dv


@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_rounds_p_and_ds_where_splash_does(causal, T):
    """At bf16 against splash's backward in interpret mode (the vjp of
    `_splash_mha`): the plain dkv and dq, which round P and dS to bf16
    before each product as the Hopper kernels feed them to wgmma, equal
    splash's dq, dk and dv on at least 99% of the elements (measured:
    99.8-100%) and stay within splash's limits; with P and dS kept in f32
    only 57-60% are equal, ten times as many elements differ and more,
    so the rounding points are splash's."""
    arrs = [np.random.RandomState(40 + T + causal + i).randn(1, T, 2, 64)
            .astype(np.float32) for i in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    _, vjp = jax.vjp(lambda a, b, c: pa._splash_mha(a, b, c, 0.125, causal,
                                                    interpret=True),
                     jq, jk, jv)
    want = [torch.from_numpy(np.asarray(g, np.float32)) for g in vjp(jdo)]
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    out, lse = fa.flash_attention_ref(q, k, v, 0.125, causal, with_lse=True)
    delta = fa.attention_delta_ref(out, do)
    dk, dv = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, 0.125,
                                            causal)
    dq = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, 0.125,
                                       causal)
    unrounded = _bwd_unrounded(q, k, v, do, lse, delta, 0.125, causal)
    for name, w, got, f32 in zip(("dq", "dk", "dv"), want, (dq, dk, dv),
                                 unrounded):
        assert _held(got, w, SPLASH_TOL) <= 1.0, name
        equal = (got.float() == w).float().mean().item()
        equal_f32 = (f32.float() == w).float().mean().item()
        assert equal >= 0.99, (name, equal)
        assert equal_f32 <= 0.8, (name, equal_f32)
        assert 1 - equal_f32 >= 10 * (1 - equal), (name, equal, equal_f32)


@pytest.mark.parametrize("T,H,causal", [(300, 64, False), (256, 128, True)])
def test_f16_backward_limit_fails_a_bf16_rounding(T, H, causal):
    """ATTN_F16_TOL keeps its power: the plain backward's arithmetic in
    f64 with P and dS rounded to f16 (the kernels' roundings, summed in
    another order than the f32 plain version) passes it against the
    plain version, and the same arithmetic with P and dS rounded to
    bf16, a kernel of lower precision, fails it on every gradient
    (measured: 0.41-0.54 and 3.1-7.9 of the limit)."""
    arrs = [np.random.RandomState(60 + T + i).randn(2, T, 2, H)
            .astype(np.float32) for i in range(4)]
    q, k, v, do = (torch.from_numpy(a).to(torch.float16) for a in arrs)
    scale = 1.0 / H ** 0.5
    out, lse = fa.flash_attention_ref(q, k, v, scale, causal, with_lse=True)
    delta = fa.attention_delta_ref(out, do)
    dk, dv = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, scale,
                                            causal)
    want = (fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, scale,
                                          causal), dk, dv)
    f16, bf16 = (bwd_f64(q, k, v, do, lse, delta, scale, causal, rounding)
                 for rounding in (torch.float16, torch.bfloat16))
    for name, w, a, b in zip(("dq", "dk", "dv"), want, f16, bf16):
        assert _held(a, w, ATTN_F16_TOL) <= 1.0, name
        assert _held(b, w, ATTN_F16_TOL) > 2.0, name


# (B, T, Tk, N, H, causal, dtype, bias): Transformer-big's encoder shape
# cut in batch (one key block), padded BERT's 512 keys, a ragged pair
# past one block, causal with a full bias at f16 and over several query
# blocks, H 128
K2_CASES = [(4, 128, 128, 2, 64, False, torch.bfloat16, "mask"),
            (2, 512, 512, 2, 64, False, torch.bfloat16, "mask"),
            (2, 100, 300, 2, 64, False, torch.bfloat16, "mask"),
            (2, 128, 128, 2, 64, True, torch.float16, "full"),
            (1, 384, 384, 2, 64, True, torch.bfloat16, "full"),
            (2, 256, 300, 2, 128, True, torch.bfloat16, "full")]


@pytest.mark.parametrize("B,T,Tk,N,H,causal,dtype,bias", K2_CASES)
def test_k2_arithmetic_matches_its_plain_version(B, T, Tk, N, H, causal,
                                                 dtype, bias):
    _, (q, k, v) = _qkv(B, T, Tk, N, H, dtype, seed=T + Tk + causal)
    rs = np.random.RandomState(T)
    if bias == "full":
        ab = torch.from_numpy(rs.randn(B, N, T, Tk).astype(np.float32))
    else:
        lens = rs.randint(Tk // 2, Tk + 1, B)
        ab = torch.from_numpy(np.where(
            np.arange(Tk)[None] < lens[:, None], 0.0, -1e9)
            .astype(np.float32)[:, None, None, :])
    out, l, m = k2_emulated(q, k, v, ab, 0.125, causal)
    want, want_l, want_m = fb.flash_attention_bias_ref(q, k, v, ab, 0.125,
                                                       causal)
    assert _held(out, want, ELEM_TOL[dtype]) <= 1.0
    assert ((l - want_l).abs() / want_l).max().item() <= 1e-5
    assert (m - want_m).abs().max().item() <= 1e-4


def _k2_bias(rs, B, N, T, Tk, bias):
    """A full [B, N, T, Tk] bias, or a key-padding mask [B, 1, 1, Tk]
    (-1e9 past lengths in [Tk / 2, Tk])."""
    if bias == "full":
        return torch.from_numpy(rs.randn(B, N, T, Tk).astype(np.float32))
    lens = rs.randint(Tk // 2, Tk + 1, B)
    return torch.from_numpy(np.where(np.arange(Tk)[None] < lens[:, None],
                                     0.0, -1e9)
                            .astype(np.float32)[:, None, None, :])


def _k2_bwd_args(B, T, Tk, N, H, causal, dtype, bias, seed):
    """The K2 backward's inputs from numpy seeds, l, m and delta from the
    plain forward: (q, k, v, bias, do, l, m, delta, scale, causal)."""
    _, (q, k, v) = _qkv(B, T, Tk, N, H, dtype, seed)
    rs = np.random.RandomState(seed + 1)
    do = torch.from_numpy(rs.randn(B, T, N, H).astype(np.float32)).to(dtype)
    ab = _k2_bias(rs, B, N, T, Tk, bias)
    out, l, m = fb.flash_attention_bias_ref(q, k, v, ab, 0.125, causal)
    delta = fa.attention_delta_ref(out, do)
    return q, k, v, ab, do, l, m, delta, 0.125, causal


@pytest.mark.parametrize("B,T,Tk,N,H,causal,dtype,bias", K2_CASES)
def test_k2_backward_arithmetic_matches_its_plain_version(B, T, Tk, N, H,
                                                          causal, dtype,
                                                          bias):
    """The Hopper K2-bwd's arithmetic (p from l and m, ds times the
    scale, both rounded to the dtype, the products summed in another
    order: f64 here) against the plain dkv and dq under ELEM_TOL."""
    args = _k2_bwd_args(B, T, Tk, N, H, causal, dtype, bias,
                        seed=T + Tk + H + causal)
    dk, dv = fb.flash_attention_bias_bwd_dkv_ref(*args)
    want = (fb.flash_attention_bias_bwd_dq_ref(*args), dk, dv)
    for name, got, w in zip(("dq", "dk", "dv"), k2_bwd_f64(*args), want):
        assert got.dtype == dtype, name
        assert _held(got, w, ELEM_TOL[dtype]) <= 1.0, name


def test_k2_backward_arithmetic_matches_pallas_interpret():
    """At bf16 with a key-padding mask (Transformer-big's encoder call,
    cut in batch and heads) against the JAX package's `_pallas_mha`
    gradient, jax's legacy flash backward run in TPU interpret mode: the
    Hopper K2-bwd's arithmetic, from the plain forward's l, m and delta,
    within the bf16 limits of `tests/test_torch_flash_bias.py`."""
    from jax.experimental.pallas import tpu as pltpu

    args = _k2_bwd_args(2, 128, 128, 2, 64, False, torch.bfloat16, "mask",
                        seed=70)
    q, k, v, ab, do = args[:5]
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        _, vjp = jax.vjp(lambda a, b, c: pa._pallas_mha(
            a, b, c, jnp.asarray(ab.numpy()), 0.125, False), jq, jk, jv)
        want = [torch.from_numpy(np.asarray(g, np.float32))
                for g in vjp(jdo)]
    for name, got, w in zip(("dq", "dk", "dv"), k2_bwd_f64(*args), want):
        assert _held(got, w, ELEM_TOL[torch.bfloat16]) <= 1.0, name


# chip_smoke.py's causal_f16 case (4 x 128 x 12 heads of 64, causal, a
# full bias), ROADMAP F4
K2_F16_CAUSAL = (4, 128, 128, 12, 64, True, torch.float16, "full")


def test_k2_f16_causal_floor_reaches_half_the_f16_limit():
    """Why K2's f16 causal case is held to ATTN_F16_TOL: K2-fwd's
    arithmetic in f64, p / l rounded to f16 as the kernel rounds it,
    reads 0.5 or more of ELEM_TOL's f16 limit against the f32 plain
    version at some of six seeds (measured: 0.56-0.88 at every seed, the
    backward's gradients 0.62-1.64), so that limit lies at the plain
    version's own f32 noise."""
    floors = []
    for seed in range(6):
        q, k, v, ab = _k2_bwd_args(*K2_F16_CAUSAL, seed=seed)[:4]
        want = fb.flash_attention_bias_ref(q, k, v, ab, 0.125, True)[0]
        floors.append(_held(k2_fwd_f64(q, k, v, ab, 0.125, True), want,
                            ELEM_TOL[torch.float16]))
    assert max(floors) >= 0.5, floors


@pytest.mark.parametrize("seed", range(6))
def test_k2_f16_causal_limit_fails_a_bf16_rounding(seed):
    """ATTN_F16_TOL at K2's f16 causal case: K2-fwd's and K2-bwd's
    arithmetic in f64 with p (and ds) rounded to f16 passes it against
    the plain versions (measured: 0.30-0.73), and the same with them
    rounded to bf16 reads more than twice it on the output and every
    gradient (4.1-7.7)."""
    args = _k2_bwd_args(*K2_F16_CAUSAL, seed=seed)
    q, k, v, ab = args[:4]
    out = fb.flash_attention_bias_ref(q, k, v, ab, 0.125, True)[0]
    dk, dv = fb.flash_attention_bias_bwd_dkv_ref(*args)
    want = (out, fb.flash_attention_bias_bwd_dq_ref(*args), dk, dv)
    for rounding, bound in ((torch.float16, None), (torch.bfloat16, 2.0)):
        got = (k2_fwd_f64(q, k, v, ab, 0.125, True, rounding),
               *k2_bwd_f64(*args, rounding))
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            ratio = _held(g, w, ATTN_F16_TOL)
            if bound is None:
                assert ratio <= 1.0, (name, ratio)
            else:
                assert ratio > bound, (name, ratio)
