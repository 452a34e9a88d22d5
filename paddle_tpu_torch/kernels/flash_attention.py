"""K1: flash attention, forward (K1-fwd, optionally with the per-row
logsumexp) and backward (K1-bwd), CUDA kernels for Hopper, and their
plain PyTorch versions.

The kernels replace the JAX package's `ops/pallas/attention.py`
splash attention: `csrc/flash_attention.cu` its forward (`_splash_mha`;
with the LSE output, splash's forward with `save_residuals`, which is
also K3, the ring's block `_splash_block_with_lse`:
`splash_block_with_lse`), and `csrc/flash_attention_bwd.cu` its dq/dkv
backward (the custom vjp of `make_splash_mha`). Each wrapper launches its kernel on a CUDA tensor
or raises, and computes the plain version on a CPU tensor; there is no
fallback from the card to the plain version. Each counts its kernel
launches in `.launches`.

Semantics (splash's): q is scaled in q's dtype before the product; the
scores, softmax, LSE and every accumulator are f32; outputs have q's
dtype. The backward rounds P and dS to q's dtype before their products
and takes `delta = rowsum(f32(o) * f32(do))` from the stored output, as
splash's vjp does; dq is the gradient through the scale multiply
(`round(dq_scaled) * scale` in q's dtype), applied inside the dq
kernel. Layout `[B, T, N, H]` as `mha` receives it; q/k/v take any
strides with a last-dim stride of 1, so the views split out of a fused
qkv projection need no copy. H is 64 or 128; any T >= 1; float32,
bfloat16 or float16.

`flash_attention` is differentiable: under grad it runs the
`FlashAttention` autograd Function, whose backward is K1-bwd on the
card and `flash_attention_bwd_ref` on the CPU. Without grad (serving,
`torch.inference_mode()`), it launches K1-fwd alone and saves nothing.

K1-fwd has two kernels in `csrc/flash_attention.cu`, and K1-bwd's dkv
and dq two each in `csrc/flash_attention_bwd.cu`. At bf16 and f16 the
backward is two launches, dq then dkv: given the forward's output, the
dq kernel computes delta in its prologue and writes it for dkv
(`flash_attention_bwd_dq(..., o=out)`, counted in `.delta_folds`); the
standalone `attention_delta` launch serves f32. bf16 and f16 run the
Hopper ones (wgmma on the tensor cores, tiles by TMA through an
mbarrier ring, one producer warp and two consumer warpgroups); they
remove the FMA kernels' limit, the products on the FP32 pipes. They
read q, k, v (and the backward's dO) in place through TMA, whose rules
`check_tma` holds before the launch (a 16-byte aligned base, strides of
16-byte multiples): a view that breaks them raises, and nothing copies
it. The backward's P and dS enter their products rounded to q's dtype,
splash's own rounding, so the 16-bit operand changes nothing there. Its P goes into the product as two 16-bit parts (hi = round(P), lo
= round(P - hi)), since splash multiplies its f32 p by v in f32 and
wgmma takes 16-bit operands only; so the plain version keeps p in f32
and needs no rounding of its own. f32 runs the FMA kernel: wgmma has no
full-f32 form, and TF32 would not pass the f32 parity gates.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from . import _build

__all__ = ["FlashAttention", "flash_attention", "flash_attention_ref",
           "flash_attention_with_lse", "flash_attention_bwd",
           "flash_attention_bwd_ref", "attention_delta",
           "attention_delta_ref", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dkv_ref", "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_ref", "splash_block_with_lse",
           "splash_block_with_lse_ref", "check_tma", "HEAD_DIMS"]

HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_STRIDED = [ctypes.c_longlong] * 9


# ---------------------------------------------------------------------------
# Plain versions (any device; the wrappers take them for CPU tensors)
# ---------------------------------------------------------------------------


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in q's dtype, as splash's caller folds the scale in."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _keep(T: int, Tk: int, device) -> torch.Tensor:
    return torch.ones(T, Tk, dtype=torch.bool, device=device).tril()


def _logits(q, k, scale, causal):
    """f32 scores of the scaled q, -inf above the diagonal when causal."""
    s = torch.einsum("btnh,bsnh->bnts", _scaled(q, scale).float(), k.float())
    if causal:
        s = s.masked_fill(~_keep(q.shape[1], k.shape[1], q.device),
                          float("-inf"))
    return s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool = True,
                        with_lse: bool = False):
    """Plain PyTorch version of K1-fwd: q pre-scaled in q.dtype, f32
    logits, causal by masking, f32 softmax. With `with_lse`, returns
    (out, lse) with lse the f32 logsumexp of each row, [B, N, T]."""
    logits = _logits(q, k, scale, causal)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnts,bsnh->btnh", probs, v.float()).to(q.dtype)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def attention_delta_ref(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(f32(o) * f32(do)), f32 [B, N, T]."""
    return torch.einsum("btnh,btnh->bnt", o.float(), do.float())


def _p_ds(q, k, v, do, lse, delta, scale, causal):
    """P = exp(S - lse) (0 where masked) and dS = (dO V^T - delta) * P,
    both f32 [B, N, T, Tk], as each backward kernel recomputes them."""
    s = torch.einsum("btnh,bsnh->bnts", _scaled(q, scale).float(), k.float())
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_keep(q.shape[1], k.shape[1], q.device), 0.0)
    dp = torch.einsum("btnh,bsnh->bnts", do.float(), v.float())
    return p, (dp - delta[..., None]) * p


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, scale: float,
                                causal: bool):
    """Plain version of the dkv kernel: (dk, dv) in q's dtype, from
    round(dS)^T Q_scaled and round(P)^T dO."""
    dt = q.dtype
    p, ds = _p_ds(q, k, v, do, lse, delta, scale, causal)
    dv = torch.einsum("bnts,btnh->bsnh", p.to(dt).float(), do.float())
    dk = torch.einsum("bnts,btnh->bsnh", ds.to(dt).float(),
                      _scaled(q, scale).float())
    return dk.to(dt), dv.to(dt)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, scale: float,
                               causal: bool, o=None):
    """Plain version of the dq kernel: round(dS) K, rounded to q's dtype,
    times the scale in q's dtype (the gradient through q * scale). With
    the forward's output `o` in place of `delta` (None), delta is
    `attention_delta_ref(o, do)` and (dq, delta) is returned, as the
    kernel folds the delta pass in."""
    dt = q.dtype
    fold = delta is None
    if fold:
        delta = attention_delta_ref(o, do)
    _, ds = _p_ds(q, k, v, do, lse, delta, scale, causal)
    dq = _scaled(torch.einsum("bnts,bsnh->btnh", ds.to(dt).float(),
                              k.float()).to(dt), scale)
    return (dq, delta) if fold else dq


def flash_attention_bwd_ref(q, k, v, o, lse, do, scale: float,
                            causal: bool = True):
    """Plain version of K1-bwd, step for step what the kernels do: dq
    with the delta pass, then dk/dv from the saved LSE and that delta
    (not autograd of the forward). Returns (dq, dk, dv) in q's dtype."""
    dq, delta = flash_attention_bwd_dq_ref(q, k, v, do, lse, None, scale,
                                           causal, o=o)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, scale,
                                         causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v):
    if not (q.ndim == k.ndim == v.ndim == 4):
        raise ValueError("flash_attention takes [B, T, N, H] tensors")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention takes float32, bfloat16 or "
                         f"float16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    B, T, N, H = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (N, H):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if H not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, "
                         f"got {H}")
    if T < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention needs T >= 1")
    if B * N > 65535:
        raise ValueError(f"B*N = {B * N} exceeds the kernel's grid limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a last-dim stride of 1")


def check_tma(*ts: torch.Tensor) -> None:
    """Raise unless TMA can read each [B, T, N, H] tensor in place, as
    the bf16 and f16 kernels do: a base address aligned to 16
    bytes and strides of 16-byte multiples (a dimension of size 1 has
    no stride that matters). No copy is made for a view that fails."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"TMA needs a 16-byte aligned base address, got "
                             f"a view at {t.data_ptr() % 16} bytes past one")
        es, shape, strides = t.element_size(), t.shape, t.stride()
        bad = [d for d in range(3) if shape[d] > 1 and
               (strides[d] * es) % 16]
        if bad:
            raise ValueError(f"TMA needs strides of 16-byte multiples, got "
                             f"{[strides[d] * es for d in bad]} bytes on "
                             f"dims {bad} of a {tuple(shape)} view")


def _fn(lib: str, name: str, argtypes):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2))


@functools.lru_cache(maxsize=64)
def _dtype_scale(scale: float, dtype: torch.dtype) -> float:
    """The scale as splash's caller holds it: rounded to q's dtype."""
    return float(torch.tensor(scale, dtype=dtype))


# the devices whose primary context each thread has made current
_bound = threading.local()


def _run(what: str, device: torch.device, launch) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        bound = getattr(_bound, "devices", None)
        if bound is None:
            bound = _bound.devices = set()
        if stream.device_index not in bound:
            # the launchers build their TMA maps through the driver API,
            # which needs the device's context current on this thread; a
            # thread whose first CUDA work is this launch has none until
            # a runtime call (this stream query) makes it current
            stream.query()
            bound.add(stream.device_index)
        rc = launch(stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _fwd_kernel(q, k, v, scale, causal, with_lse):
    """Launch K1-fwd; returns (out, lse or None)."""
    fn = _fn("flash_attention", "paddle_flash_attention_fwd",
             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + _STRIDED +
             [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p])
    if q.dtype != torch.float32:
        check_tma(q, k, v)
    B, T, N, H = q.shape
    out = torch.empty((B, T, N, H), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, N, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _run("flash_attention", q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, N, T, k.shape[1], H, _DTYPE_CODE[q.dtype], *_strides(q, k, v),
        _dtype_scale(scale, q.dtype), int(bool(causal)),
        lse.data_ptr() if with_lse else None, stream))
    return out, lse


def _forward_with_lse(q, k, v, scale, causal):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, causal, with_lse=True)
    out, lse = _fwd_kernel(q, k, v, scale, causal, with_lse=True)
    flash_attention_with_lse.launches += 1
    return out, lse


def _check_bwd(q, do, **rows):
    """do: contiguous, of q's shape, dtype and device; each of `rows`
    (lse, delta, l, m) that is not None: contiguous f32 [B, N, T] on q's
    device."""
    B, T, N, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or \
            not do.is_contiguous() or do.device != q.device:
        raise ValueError("do must be a contiguous tensor of q's shape, "
                         "dtype and device")
    for name, t in rows.items():
        if t is not None and (
                t.shape != (B, N, T) or t.dtype != torch.float32 or
                not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous f32 [B, N, T] on "
                             f"q's device")


def _check_o(q, o, delta):
    """Exactly one of `o` (the forward's output, of q's shape, dtype and
    device; on CUDA contiguous and 16-byte aligned, for the dq kernel's
    vector loads) and `delta`."""
    if (o is None) == (delta is None):
        raise ValueError("pass delta, or the forward's output o to compute "
                         "it, not both")
    if o is not None and (o.shape != q.shape or o.dtype != q.dtype or
                          o.device != q.device or
                          (o.device.type == "cuda" and
                           (not o.is_contiguous() or o.data_ptr() % 16))):
        raise ValueError("o must be a tensor of q's shape, dtype and device "
                         "(on CUDA contiguous and 16-byte aligned)")


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(f32(o) * f32(do)), f32 [B, N, T]: the standalone
    delta launch on CUDA tensors (contiguous [B, T, N, H] of one dtype;
    the f32 backward's first launch, and for a caller that wants delta
    alone), the plain version on CPU tensors. At bf16 and f16 the
    backwards fold this pass into their dq kernels instead."""
    if o.device.type == "cpu":
        return attention_delta_ref(o, do)
    if (o.shape != do.shape or o.dtype != do.dtype or o.dtype not in
            _DTYPE_CODE or not (o.is_contiguous() and do.is_contiguous())
            or o.shape[-1] not in HEAD_DIMS or do.device != o.device):
        raise ValueError("attention_delta takes contiguous [B, T, N, H] o "
                         "and do of one shape, dtype and device")
    fn = _fn("flash_attention_bwd", "paddle_flash_attention_bwd_delta",
             [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    B, T, N, H = o.shape
    delta = torch.empty((B, N, T), dtype=torch.float32, device=o.device)
    _run("attention_delta", o.device, lambda stream: fn(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, N, T, H,
        _DTYPE_CODE[o.dtype], stream))
    attention_delta.launches += 1
    return delta


# q, k, v, do, lse, delta, dk, dv; B, N, Tq, Tk, H, dtype; strides;
# scale, causal, stream (the dq launch has one output pointer fewer)
_BWD_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + _STRIDED +
             [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float,
                            causal: bool = True):
    """(dk, dv): K1-bwd's dkv launch on CUDA tensors, the plain version
    on CPU tensors."""
    _check(q, k, v)
    _check_bwd(q, do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, scale,
                                           causal)
    fn = _fn("flash_attention_bwd", "paddle_flash_attention_bwd_dkv",
             _BWD_ARGS)
    if q.dtype != torch.float32:
        check_tma(q, k, v, do)
    B, T, N, H = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _run("flash_attention_bwd_dkv", q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, N, T, k.shape[1], H, _DTYPE_CODE[q.dtype], *_strides(q, k, v),
        _dtype_scale(scale, q.dtype), int(bool(causal)), stream))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: float,
                           causal: bool = True, o=None):
    """dq (with respect to the unscaled q): K1-bwd's dq launch on CUDA
    tensors, the plain version on CPU tensors. With the forward's output
    `o` in place of `delta` (None), delta is computed too and (dq, delta)
    returned: at bf16 and f16 by the dq kernel itself, in its prologue
    (the launch also counted in `.delta_folds`); at f32, whose FMA kernel
    takes delta as an input, by an `attention_delta` launch first."""
    _check(q, k, v)
    _check_o(q, o, delta)
    _check_bwd(q, do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, scale,
                                          causal, o=o)
    fold = o is not None
    if fold and q.dtype == torch.float32:
        delta = attention_delta(o, do)
        return flash_attention_bwd_dq(q, k, v, do, lse, delta, scale,
                                      causal), delta
    fn = _fn("flash_attention_bwd", "paddle_flash_attention_bwd_dq",
             [ctypes.c_void_p] * 8 + _BWD_ARGS[8:])
    if q.dtype != torch.float32:
        check_tma(q, k, v, do)
    B, T, N, H = q.shape
    dq = torch.empty((B, T, N, H), dtype=q.dtype, device=q.device)
    if fold:
        delta = torch.empty((B, N, T), dtype=torch.float32, device=q.device)
    _run("flash_attention_bwd_dq", q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), o.data_ptr() if fold else None,
        dq.data_ptr(), B, N, T, k.shape[1], H, _DTYPE_CODE[q.dtype],
        *_strides(q, k, v), _dtype_scale(scale, q.dtype), int(bool(causal)),
        stream))
    flash_attention_bwd_dq.launches += 1
    if fold:
        flash_attention_bwd_dq.delta_folds += 1
        return dq, delta
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, scale: float,
                        causal: bool = True):
    """K1-bwd: (dq, dk, dv) from the forward's output `o` and LSE. dq
    first, computing delta from `o`, then dkv from that delta: on bf16
    and f16 CUDA tensors two launches (the dq kernel folds the delta
    pass in), on f32 three (delta, dq, dkv), each counted by its own
    wrapper; on CPU tensors, the plain versions of the same steps. A
    caller that holds delta already (f32 [B, N, T]) calls
    `flash_attention_bwd_dkv` and `flash_attention_bwd_dq` with it."""
    _check(q, k, v)
    do = do.to(q.dtype).contiguous()
    _check_bwd(q, do, lse=lse)
    dq, delta = flash_attention_bwd_dq(q, k, v, do, lse, None, scale, causal,
                                       o=o.contiguous())
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a K1 forward and a K1 backward: saves q, k, v, the
    output and the LSE, and returns (out, lse) with lse not
    differentiable. CUDA tensors run the kernels, CPU tensors the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        out, lse = _forward_with_lse(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.scale,
                                         ctx.causal)
        return dq, dk, dv, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True) -> torch.Tensor:
    """Attention over [B, T, N, H]. Under grad, through `FlashAttention`
    (K1-fwd with LSE, K1-bwd in backward); otherwise CUDA tensors launch
    K1-fwd alone (counted in `flash_attention.launches`) and CPU tensors
    take `flash_attention_ref`."""
    _check(q, k, v)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, scale, causal)[0]
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, causal)
    out, _ = _fwd_kernel(q, k, v, scale, causal, with_lse=False)
    flash_attention.launches += 1
    return out


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: float = 1.0,
                             causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse [B, N, T] f32): the K1-fwd kernel with its LSE output
    (counted in `flash_attention_with_lse.launches`): splash's forward
    as its vjp runs it, saving the LSE. Differentiable in `out` through
    `FlashAttention`. The ring's block (K3) is `splash_block_with_lse`,
    the same kernel counted on its own."""
    _check(q, k, v)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, scale, causal)
    return _forward_with_lse(q, k, v, scale, causal)


def splash_block_with_lse_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: full-mask attention of a pre-scaled q, (out
    in q's dtype, lse f32 [B, N, T])."""
    return flash_attention_ref(q, k, v, 1.0, causal=False, with_lse=True)


def splash_block_with_lse(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3, the counterpart of the JAX package's `_splash_block_with_lse`
    (`ops/pallas/attention.py:374`): one full-mask block of the ring,
    q pre-scaled, returning (out in q's dtype, lse f32 [B, N, T]).

    On CUDA tensors it launches K1-fwd with its LSE output at scale 1.0,
    non-causal (counted in `splash_block_with_lse.launches`): splash's
    forward with `save_residuals` computes that function. On CPU tensors
    it runs `splash_block_with_lse_ref`. It has no backward: the ring's
    autograd Function (`ops/ring_attention.py::RingSplash`) calls it in
    its forward, and the ring's backward is blockwise from the merged
    LSE. A call whose inputs require grad under grad raises, rather
    than return an output cut off from autograd."""
    _check(q, k, v)
    if _needs_grad(q, k, v):
        raise RuntimeError("splash_block_with_lse has no backward; call it "
                           "under torch.no_grad() or from an autograd "
                           "Function's forward (ring_splash)")
    if q.device.type == "cpu":
        return splash_block_with_lse_ref(q, k, v)
    out, lse = _fwd_kernel(q, k, v, 1.0, False, with_lse=True)
    splash_block_with_lse.launches += 1
    return out, lse


flash_attention.launches = 0
flash_attention_with_lse.launches = 0
splash_block_with_lse.launches = 0
attention_delta.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.delta_folds = 0
