"""K2: flash attention with an additive bias, forward (K2-fwd) and
backward (K2-bwd: dkv and dq launches), CUDA kernels for Hopper, and
their plain PyTorch versions.

The kernels replace the JAX package's `ops/pallas/attention.py`
`_pallas_mha`, jax's legacy Pallas `flash_attention` with its `ab`
bias: `csrc/flash_attention_bias.cu` its forward,
`csrc/flash_attention_bias_bwd.cu` its `_flash_attention_bwd_dkv` and
`_flash_attention_bwd_dq`. The backward's third step, `di =
rowsum(f32(o) * f32(do))`, is folded into the dq kernel at bf16 and f16
(given the forward's output, it computes delta in its prologue and
writes it for dkv, which runs after it; counted in `.delta_folds`) and
is K1's `attention_delta` launch at f32. Each
wrapper launches its kernel on a CUDA tensor or raises, and computes
the plain version on a CPU tensor; there is no fallback from the card
to the plain version. Each counts its kernel launches in `.launches`.

Semantics (the legacy kernel's, not splash's): scores are f32 products
of the unscaled q; the bias is added before the scale; causal positions
get `MASK_VALUE` added, not -inf; the forward's online softmax
renormalises its accumulator on every key tile and rounds the
unnormalised p to v's dtype before the product; it saves each row's
sum `l` and max `m` (f32 [B, N, T]). The backward recomputes
`p = exp(s - m) * (1/l)` and `ds = (dp - di) * p * scale`, rounds p
and ds to the input dtype before their products, takes dk from the
unscaled q, and returns `ds` itself (f32 [B, N, T, Tk]) as the bias
gradient when one is asked for. Layout `[B, T, N, H]` as `mha`
receives it, with any strides and a last-dim stride of 1; the bias is
anything that broadcasts to `[B, N, T, Tk]` (mha's `[B, 1, 1, Tk]` key
mask is read through stride-0 views, never materialised). H is 64 or
128; any T, Tk >= 1; float32, bfloat16 or float16.

`flash_attention_bias` is differentiable: under grad it runs the
`FlashAttentionBias` autograd Function, whose backward is K2-bwd on the
card and the plain versions on the CPU; the bias gets a gradient only
when it requires one.

K2-fwd has two kernels in `csrc/flash_attention_bias.cu`, and K2-bwd's
dkv and dq two each in `csrc/flash_attention_bias_bwd.cu`. bf16 and f16
run the Hopper ones, on K1's pipelines (wgmma, TMA, `csrc/sm90.cuh`)
with the bias read in the accumulator's layout (mha's key mask once a
key in dkv, by pairs of columns in dq); q, k and v (and the backward's
dO) must pass `check_tma` (a view that does not raises). The forward
rounds P to v's dtype as the reference rounds it and keeps an
unnormalised accumulator where the reference renormalises on every key
block, which moves only f32 roundings; the backward rounds p and ds to
the input dtype before each product, the reference's own roundings,
so its 16-bit wgmma operand is exact (`tests/test_torch_hopper_numerics.py`
emulates both); the plain versions are unchanged. f32 runs the FMA
kernels: wgmma has no full-f32 form, and TF32 would not pass the f32
parity gates.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .flash_attention import (_DTYPE_CODE, _check, _check_bwd, _check_o,
                              _fn, _needs_grad, _run, _strides,
                              attention_delta, attention_delta_ref,
                              check_tma)

__all__ = ["FlashAttentionBias", "flash_attention_bias",
           "flash_attention_bias_ref", "flash_attention_bias_fwd",
           "flash_attention_bias_bwd_dkv", "flash_attention_bias_bwd_dkv_ref",
           "flash_attention_bias_bwd_dq", "flash_attention_bias_bwd_dq_ref",
           "MASK_VALUE", "BLOCK_Q", "BLOCK_K"]

# jax's DEFAULT_MASK_VALUE, added to causal positions (held in f32)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the reference's blocks (jax's default BlockSizes), which the forward
# keeps: one softmax when the keys fit one block, else an online softmax
# renormalised per key block, skipping causal blocks above the diagonal
BLOCK_Q = BLOCK_K = 128
_STRIDED = [ctypes.c_longlong] * 13


# ---------------------------------------------------------------------------
# Plain versions (any device; the wrappers take them for CPU tensors)
# ---------------------------------------------------------------------------


def _scores(q, k, bias, scale, causal):
    """f32 [B, N, T, Tk]: (q k^T + bias) * scale, + MASK_VALUE above the
    diagonal when causal."""
    s = (torch.einsum("btnh,bsnh->bnts", q.float(), k.float())
         + bias.float()) * scale
    if causal:
        T, Tk = q.shape[1], k.shape[1]
        keep = torch.ones(T, Tk, dtype=torch.bool, device=q.device).tril()
        s = s + torch.where(keep, 0.0, MASK_VALUE)
    return s


def flash_attention_bias_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor,
                             scale: float, causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version of K2-fwd: (out in q's dtype, l, m), l and m
    f32 [B, N, T]. With Tk <= BLOCK_K, one softmax over the row with p
    normalised before its rounding to v's dtype; beyond, the online
    softmax over BLOCK_K key blocks, each query block skipping the
    causal key blocks wholly above it."""
    B, T, N, H = q.shape
    Tk = k.shape[1]
    s = _scores(q, k, bias, scale, causal)
    if Tk <= BLOCK_K:
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(-1)
        out = torch.einsum("bnts,bsnh->btnh", (p / l[..., None])
                           .to(v.dtype).float(), v.float())
        return out.to(q.dtype), l, m
    m = torch.full((B, N, T), float("-inf"), device=q.device)
    l = torch.zeros((B, N, T), device=q.device)
    acc = torch.zeros((B, N, T, H), device=q.device)
    key_end = (torch.arange(T, device=q.device) // BLOCK_Q + 1) * BLOCK_Q
    for k0 in range(0, Tk, BLOCK_K):
        st = s[..., k0:k0 + BLOCK_K]
        m_next = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - m_next[..., None])
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(-1) + l_corr
        inv = torch.where(l_next == 0, 1.0, 1.0 / l_next)
        o_cur = torch.einsum("bnts,bsnh->bnth", p.to(v.dtype).float(),
                             v[:, k0:k0 + BLOCK_K].float())
        acc_next = acc * (l_corr * inv)[..., None] + o_cur * inv[..., None]
        if causal:
            run = (k0 < key_end)[None, None]
            m_next = torch.where(run, m_next, m)
            l_next = torch.where(run, l_next, l)
            acc_next = torch.where(run[..., None], acc_next, acc)
        m, l, acc = m_next, l_next, acc_next
    return acc.transpose(1, 2).to(q.dtype), l, m


def _p_ds(q, k, v, bias, do, l, m, delta, scale, causal):
    """p = exp(s - m) * (1/l) and ds = (dp - delta) * p * scale, both f32
    [B, N, T, Tk], as each backward kernel recomputes them."""
    s = _scores(q, k, bias, scale, causal)
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    dp = torch.einsum("btnh,bsnh->bnts", do.float(), v.float())
    return p, (dp - delta[..., None]) * p * scale


def flash_attention_bias_bwd_dkv_ref(q, k, v, bias, do, l, m, delta,
                                     scale: float, causal: bool = False):
    """Plain version of the dkv kernel: (dk, dv) in q's dtype, from
    round(ds)^T q (the unscaled q) and round(p)^T dO."""
    dt = q.dtype
    p, ds = _p_ds(q, k, v, bias, do, l, m, delta, scale, causal)
    dv = torch.einsum("bnts,btnh->bsnh", p.to(dt).float(), do.float())
    dk = torch.einsum("bnts,btnh->bsnh", ds.to(dt).float(), q.float())
    return dk.to(dt), dv.to(dt)


def flash_attention_bias_bwd_dq_ref(q, k, v, bias, do, l, m, delta,
                                    scale: float, causal: bool = False,
                                    with_dbias: bool = False, o=None):
    """Plain version of the dq kernel: dq = round(ds) k in q's dtype, and
    with `with_dbias` (dq, ds) with ds the f32 [B, N, T, Tk] gradient of
    the bias. With the forward's output `o` in place of `delta` (None),
    delta is `attention_delta_ref(o, do)` and comes last: (dq, delta) or
    (dq, ds, delta)."""
    dt = q.dtype
    fold = delta is None
    if fold:
        delta = attention_delta_ref(o, do)
    _, ds = _p_ds(q, k, v, bias, do, l, m, delta, scale, causal)
    dq = torch.einsum("bnts,bsnh->btnh", ds.to(dt).float(),
                      k.float()).to(dt)
    return _dq_result(dq, ds, delta, with_dbias, fold)


def _dq_result(dq, ds, delta, with_dbias: bool, fold: bool):
    """dq alone, or a tuple of dq, then ds with `with_dbias`, then delta
    when it was computed (`fold`)."""
    out = (dq,) + ((ds,) if with_dbias else ()) + ((delta,) if fold else ())
    return out if len(out) > 1 else dq


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _bias_view(bias: torch.Tensor, q, k) -> torch.Tensor:
    """The bias as an f32 [B, N, T, Tk] view (stride 0 where broadcast)."""
    B, T, N, _ = q.shape
    shape = (B, N, T, k.shape[1])
    if bias.ndim != 4 or bias.device != q.device:
        raise ValueError(f"the bias must be a 4-d tensor on q's device, "
                         f"broadcastable to {shape}")
    try:
        return bias.float().expand(shape)
    except RuntimeError as e:
        raise ValueError(f"bias shape {tuple(bias.shape)} does not "
                         f"broadcast to {shape}") from e


def _args(q, k, v, ab, scale, causal):
    """The launch arguments after the pointers: sizes, dtype, strides,
    scale, causal."""
    B, T, N, H = q.shape
    return (B, N, T, k.shape[1], H, _DTYPE_CODE[q.dtype],
            *_strides(q, k, v), *ab.stride(), float(scale), int(bool(causal)))


_TAIL = [ctypes.c_int] * 6 + _STRIDED + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p]


def flash_attention_bias_fwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor,
                             scale: float, causal: bool = False):
    """(out, l, m): K2-fwd on CUDA tensors (counted in `.launches`), the
    plain version on CPU tensors."""
    _check(q, k, v)
    ab = _bias_view(bias, q, k)
    if q.device.type == "cpu":
        return flash_attention_bias_ref(q, k, v, ab, scale, causal)
    if q.dtype != torch.float32:
        check_tma(q, k, v)
    fn = _fn("flash_attention_bias", "paddle_flash_attention_bias_fwd",
             [ctypes.c_void_p] * 7 + _TAIL)
    B, T, N, H = q.shape
    out = torch.empty((B, T, N, H), dtype=q.dtype, device=q.device)
    l = torch.empty((B, N, T), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    _run("flash_attention_bias_fwd", q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ab.data_ptr(),
        out.data_ptr(), l.data_ptr(), m.data_ptr(),
        *_args(q, k, v, ab, scale, causal), stream))
    flash_attention_bias_fwd.launches += 1
    return out, l, m


def flash_attention_bias_bwd_dkv(q, k, v, bias, do, l, m, delta,
                                 scale: float, causal: bool = False):
    """(dk, dv): K2-bwd's dkv launch on CUDA tensors, the plain version
    on CPU tensors."""
    _check(q, k, v)
    _check_bwd(q, do, l=l, m=m, delta=delta)
    ab = _bias_view(bias, q, k)
    if q.device.type == "cpu":
        return flash_attention_bias_bwd_dkv_ref(q, k, v, ab, do, l, m, delta,
                                                scale, causal)
    if q.dtype != torch.float32:
        check_tma(q, k, v, do)
    fn = _fn("flash_attention_bias_bwd", "paddle_flash_attention_bias_bwd_dkv",
             [ctypes.c_void_p] * 10 + _TAIL)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _run("flash_attention_bias_bwd_dkv", q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ab.data_ptr(),
        do.data_ptr(), l.data_ptr(), m.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_args(q, k, v, ab, scale, causal),
        stream))
    flash_attention_bias_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bias_bwd_dq(q, k, v, bias, do, l, m, delta,
                                scale: float, causal: bool = False,
                                with_dbias: bool = False, o=None):
    """dq, or (dq, dbias f32 [B, N, T, Tk]) with `with_dbias`: K2-bwd's
    dq launch on CUDA tensors, the plain version on CPU tensors. With the
    forward's output `o` in place of `delta` (None), delta is computed
    too and comes last, (dq, delta) or (dq, dbias, delta): at bf16 and
    f16 by the dq kernel itself, in its prologue (the launch also counted
    in `.delta_folds`); at f32, whose FMA kernel takes delta as an input,
    by K1's `attention_delta` launch first."""
    _check(q, k, v)
    _check_o(q, o, delta)
    _check_bwd(q, do, l=l, m=m, delta=delta)
    ab = _bias_view(bias, q, k)
    if q.device.type == "cpu":
        return flash_attention_bias_bwd_dq_ref(q, k, v, ab, do, l, m, delta,
                                               scale, causal, with_dbias, o)
    fold = o is not None
    if fold and q.dtype == torch.float32:
        delta = attention_delta(o, do)
        got = flash_attention_bias_bwd_dq(q, k, v, bias, do, l, m, delta,
                                          scale, causal, with_dbias)
        dq, ds = got if with_dbias else (got, None)
        return _dq_result(dq, ds, delta, with_dbias, True)
    if q.dtype != torch.float32:
        check_tma(q, k, v, do)
    fn = _fn("flash_attention_bias_bwd", "paddle_flash_attention_bias_bwd_dq",
             [ctypes.c_void_p] * 11 + _TAIL)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # zeroed: the kernel skips causal tiles above the diagonal
    dbias = (torch.zeros(ab.shape, dtype=torch.float32, device=q.device)
             if with_dbias else None)
    if fold:
        delta = torch.empty(l.shape, dtype=torch.float32, device=q.device)
    _run("flash_attention_bias_bwd_dq", q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ab.data_ptr(),
        do.data_ptr(), l.data_ptr(), m.data_ptr(), delta.data_ptr(),
        o.data_ptr() if fold else None, dq.data_ptr(),
        dbias.data_ptr() if with_dbias else None,
        *_args(q, k, v, ab, scale, causal), stream))
    flash_attention_bias_bwd_dq.launches += 1
    if fold:
        flash_attention_bias_bwd_dq.delta_folds += 1
    return _dq_result(dq, dbias, delta, with_dbias, fold)


class FlashAttentionBias(torch.autograd.Function):
    """Attention with a K2 forward and a K2 backward: saves q, k, v, the
    bias, the output and the rows l and m. Backward: K2's dq, computing
    delta from the output (in the kernel at bf16 and f16; by K1's delta
    launch first at f32), then K2's dkv from that delta; the bias gets
    ds, summed to its own shape, only when it requires grad. CUDA
    tensors run the kernels, CPU tensors the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, causal: bool):
        out, l, m = flash_attention_bias_fwd(q, k, v, bias, scale, causal)
        ctx.save_for_backward(q, k, v, bias, out, l, m)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, l, m = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        with_dbias = ctx.needs_input_grad[3]
        *dq_ds, delta = flash_attention_bias_bwd_dq(
            q, k, v, bias, do, l, m, None, ctx.scale, ctx.causal,
            with_dbias=with_dbias, o=out.contiguous())
        dk, dv = flash_attention_bias_bwd_dkv(q, k, v, bias, do, l, m, delta,
                                              ctx.scale, ctx.causal)
        dbias = dq_ds[1].sum_to_size(bias.shape).to(bias.dtype) \
            if with_dbias else None
        return dq_ds[0], dk, dv, dbias, None, None


def flash_attention_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, scale: float,
                         causal: bool = False) -> torch.Tensor:
    """Attention over [B, T, N, H] with an additive bias broadcastable to
    [B, N, T, Tk]. Under grad, through `FlashAttentionBias` (K2-fwd, then
    K2-bwd in backward); otherwise K2-fwd alone on CUDA tensors and the
    plain version on CPU tensors."""
    _check(q, k, v)
    if _needs_grad(q, k, v, bias):
        return FlashAttentionBias.apply(q, k, v, bias, scale, causal)
    return flash_attention_bias_fwd(q, k, v, bias, scale, causal)[0]


flash_attention_bias_fwd.launches = 0
flash_attention_bias_bwd_dkv.launches = 0
flash_attention_bias_bwd_dq.launches = 0
flash_attention_bias_bwd_dq.delta_folds = 0
