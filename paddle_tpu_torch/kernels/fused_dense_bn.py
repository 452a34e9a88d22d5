"""K4, K5, K6: a matrix product with BatchNorm fused into it, CUDA
kernels for Hopper, and their plain PyTorch versions.

Counterpart of the JAX package's `ops/pallas/fused_dense_bn.py`, the
fused matmul+BN building blocks of ResNet's 1x1 convolutions (a 1x1
conv over NHWC is a [B*H*W, Cin] @ [Cin, Cout] product):

- `matmul_stats` (K4, `_mm_stats_pallas`): y = x @ w, with the
  per-column sum and sum of squares of the promoted accumulator taken
  in the kernel's epilogue, so BN's statistics pass over y never runs.
- `bn_act_matmul` (K5, `_bn_mm_pallas`): y = act(x * scale + shift)
  @ w, the producer's BN-apply (and ReLU) in the consumer product's
  prologue, so the normalised tensor is never stored.
- `bn_act_matmul_stats` (K6, `_bn_act_matmul_stats`): both at once,
  ResNet's conv3 (bn2-apply + ReLU in, bn3's statistics out).

All three are one templated kernel in `csrc/fused_dense_bn.cu`: for
bf16 and f16 a Hopper kernel (wgmma fed by TMA), for f32 and f64 an FMA
loop. `kernel_route` picks the kernel by shape, dtype and alignment
before the launch: TMA reads x and w in place when K and N are
multiples of 8 and both bases are 16-byte aligned (every ResNet-50
shape); any other bf16 or f16 call runs the same kernel on zero-padded
copies. The kernel writes per-row-block partial sums ([gm, N], in the
accumulator's dtype); the wrappers finish them as the reference does
outside its kernel: mean = s / M and var = max(ss / M - mean^2, 0).
Each wrapper
(`matmul_stats_fwd`, `bn_act_matmul_fwd`, `bn_act_matmul_stats_fwd`)
launches its kernel on a CUDA tensor or raises, computes the plain
version on a CPU tensor, and counts its launches in `.launches`.

Semantics (the reference's): the product accumulates in the promoted
dtype (`_acc_dt`: f32 for bf16, f16 and f32, f64 for f64) and y is
that accumulator rounded to x's dtype; mean and var come from the
accumulator before the rounding. The prologue computes x * scale +
shift in the scale's dtype (a product and a sum, each rounded, never
fused into one FMA), applies the ReLU, and rounds to x's dtype before
the product. On the card the scale and shift must already be in the
accumulator's dtype (f32, or f64 for f64 x), as ResNet's `fold_bn`
makes them.

None of the three has a backward kernel, in the reference or here:
each public op is a `torch.autograd.Function` that saves its raw
inputs and whose backward is the autograd of the plain version,
recomputed from them, with the cotangents of all its outputs (the
reference's `jax.custom_vjp` around the vjp of its XLA version).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .flash_attention import _fn, _run

__all__ = ["mm_stats_ref", "bn_mm_ref", "bn_mm_stats_ref", "fold_bn",
           "matmul_stats_fwd", "bn_act_matmul_fwd", "bn_act_matmul_stats_fwd",
           "matmul_stats", "bn_act_matmul", "bn_act_matmul_stats",
           "MatmulStats", "BnActMatmul", "BnActMatmulStats", "block_m",
           "kernel_route", "padded_operands"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}
# rows of one block of the kernel, and so of one partial sum: the Hopper
# kernel (bf16, f16) takes 128, the FMA kernel (f32, f64) 64
_BLOCK_M = {0: 64, 1: 128, 2: 128, 3: 64}


def _acc_dt(dtype: torch.dtype) -> torch.dtype:
    """The accumulator's dtype: f32, or f64 for f64 (jnp.promote_types
    with f32)."""
    return torch.promote_types(dtype, torch.float32)


def _max0(x: torch.Tensor) -> torch.Tensor:
    """jnp.maximum(x, 0.0), whose gradient at a tie is split in half, as
    torch.maximum's is."""
    return torch.maximum(x, x.new_zeros(()))


def kernel_route(K: int, N: int, dtype: torch.dtype, x_ptr: int,
                 w_ptr: int) -> str:
    """The kernel a CUDA call with x [M, K] and w [K, N] of `dtype` at
    addresses x_ptr and w_ptr (of the contiguous operands) takes: "fma"
    for f32 and f64; "tma" for bf16 and f16 that TMA reads in place (K
    and N multiples of 8, so rows are multiples of 16 bytes, and both
    bases 16-byte aligned); "padded" for any other bf16 or f16 call,
    which runs the TMA kernel on zero-padded copies of x, w, scale and
    shift. A function of its arguments alone, chosen before any
    launch."""
    if dtype in (torch.float32, torch.float64):
        return "fma"
    if K % 8 or N % 8 or x_ptr % 16 or w_ptr % 16:
        return "padded"
    return "tma"


def padded_operands(x, w, scale=None, shift=None):
    """The "padded" route's operands: zero-padded copies of x [M, K8],
    w [K8, N8] and (when given) scale and shift [K8], K8 and N8 being K
    and N rounded up to multiples of 8. The padded columns of x meet zero
    rows of w, and scale = shift = 0 keeps them 0 after the prologue, so
    the first N columns of y and of its sums are the unpadded call's."""
    K, N = w.shape
    K8, N8 = -(-K // 8) * 8, -(-N // 8) * 8
    pad = torch.nn.functional.pad
    return (pad(x, (0, K8 - K)), pad(w, (0, N8 - N, 0, K8 - K)),
            None if scale is None else pad(scale, (0, K8 - K)),
            None if shift is None else pad(shift, (0, K8 - K)))


def block_m(dtype: torch.dtype) -> int:
    """Rows of the kernel's block for x of `dtype`: the partial sums are
    [ceil(M / block_m), N]."""
    return _BLOCK_M[_DTYPE_CODE[dtype]]


# ---------------------------------------------------------------------------
# Plain versions (any device; the wrappers take them for CPU tensors)
# ---------------------------------------------------------------------------


def _stats(y_acc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass (mean, biased var) over the rows of the accumulator."""
    mean = y_acc.mean(0)
    return mean, _max0((y_acc * y_acc).mean(0) - mean * mean)


def _bn_act(x, scale, shift, relu: bool) -> torch.Tensor:
    xn = x.to(scale.dtype) * scale + shift
    return _max0(xn) if relu else xn


def mm_stats_ref(x: torch.Tensor, w: torch.Tensor):
    """Plain version of K4 (`_mm_stats_ref`): (y in x's dtype, mean, var
    in the accumulator's dtype)."""
    acc = _acc_dt(x.dtype)
    y_acc = torch.matmul(x.to(acc), w.to(acc))
    return (y_acc.to(x.dtype),) + _stats(y_acc)


def bn_mm_ref(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
              w: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Plain version of K5 (`_bn_mm_ref`): act(x * scale + shift), rounded
    to x's dtype, @ w, accumulated in the scale's dtype, in x's dtype."""
    xn = _bn_act(x, scale, shift, relu).to(x.dtype)
    return torch.matmul(xn.to(scale.dtype), w.to(scale.dtype)).to(x.dtype)


def bn_mm_stats_ref(x: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, w: torch.Tensor, relu: bool = True):
    """Plain version of K6 (`_bn_mm_stats_ref`): K5's prologue and
    product, accumulated in the promoted dtype, with K4's statistics of
    the accumulator before its rounding to x's dtype."""
    acc = _acc_dt(x.dtype)
    xn = _bn_act(x, scale, shift, relu).to(x.dtype)
    y_acc = torch.matmul(xn.to(acc), w.to(acc))
    return (y_acc.to(x.dtype),) + _stats(y_acc)


def fold_bn(mean, var, gamma, beta, eps: float = 1e-5):
    """(mean, var, gamma, beta) -> (scale, shift) for the prologue:
    scale = gamma / sqrt(var + eps), shift = beta - mean * scale."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, w: torch.Tensor, scale=None, shift=None):
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_dense_bn takes x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"fused_dense_bn takes float32, bfloat16, float16 "
                         f"or float64 x and w of one dtype, got "
                         f"{x.dtype}/{w.dtype}")
    if w.device != x.device or x.device.type not in ("cuda", "cpu"):
        raise ValueError("x and w must be on one device, cuda or cpu")
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None and (t.shape != (x.shape[1],) or
                              t.device != x.device):
            raise ValueError(f"{name} must be a [K] tensor on x's device, "
                             f"got {tuple(t.shape)} on {t.device}")


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _launch(what: str, x, w, scale, shift, relu: bool, stats: bool):
    """One launch of the kernel: y, and with `stats` the finished
    (mean, var)."""
    M, K = x.shape
    N = w.shape[1]
    if min(M, K, N) < 1:
        raise ValueError(f"{what}: empty operand {(M, K, N)}")
    acc = _acc_dt(x.dtype)
    prologue = scale is not None
    if prologue and not (scale.dtype == shift.dtype == acc):
        raise ValueError(f"{what} on cuda takes scale and shift in {acc} "
                         f"for {x.dtype} x, got {scale.dtype}/{shift.dtype}")
    x, w = x.contiguous(), w.contiguous()
    if prologue:
        scale, shift = scale.contiguous(), shift.contiguous()
    n_out = N
    if kernel_route(K, N, x.dtype, x.data_ptr(), w.data_ptr()) == "padded":
        x, w, scale, shift = padded_operands(x, w, scale, shift)
        K, N = w.shape
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ps = pss = None
    if stats:
        gm = -(-M // block_m(x.dtype))
        ps = torch.empty((gm, N), dtype=acc, device=x.device)
        pss = torch.empty_like(ps)
    fn = _fn("fused_dense_bn", "paddle_fused_dense_bn", _ARGTYPES)
    _run(what, x.device, lambda stream: fn(
        x.data_ptr(), scale.data_ptr() if prologue else None,
        shift.data_ptr() if prologue else None, w.data_ptr(), y.data_ptr(),
        ps.data_ptr() if stats else None, pss.data_ptr() if stats else None,
        M, K, N, _DTYPE_CODE[x.dtype], int(prologue), int(stats),
        int(bool(relu)), stream))
    if N != n_out:
        y = y[:, :n_out].contiguous()
        if stats:
            ps, pss = ps[:, :n_out], pss[:, :n_out]
    if not stats:
        return y
    mean = ps.sum(0) / M
    return y, mean, _max0(pss.sum(0) / M - mean * mean)


def matmul_stats_fwd(x: torch.Tensor, w: torch.Tensor):
    """(y, mean, var): K4 on CUDA tensors (counted in `.launches`), the
    plain version on CPU tensors."""
    _check(x, w)
    if x.device.type == "cpu":
        return mm_stats_ref(x, w)
    out = _launch("matmul_stats", x, w, None, None, False, True)
    matmul_stats_fwd.launches += 1
    return out


def bn_act_matmul_fwd(x: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, w: torch.Tensor,
                      relu: bool = True) -> torch.Tensor:
    """y: K5 on CUDA tensors (counted in `.launches`), the plain version
    on CPU tensors."""
    _check(x, w, scale, shift)
    if x.device.type == "cpu":
        return bn_mm_ref(x, scale, shift, w, relu)
    out = _launch("bn_act_matmul", x, w, scale, shift, relu, False)
    bn_act_matmul_fwd.launches += 1
    return out


def bn_act_matmul_stats_fwd(x: torch.Tensor, scale: torch.Tensor,
                            shift: torch.Tensor, w: torch.Tensor,
                            relu: bool = True):
    """(y, mean, var): K6 on CUDA tensors (counted in `.launches`), the
    plain version on CPU tensors."""
    _check(x, w, scale, shift)
    if x.device.type == "cpu":
        return bn_mm_stats_ref(x, scale, shift, w, relu)
    out = _launch("bn_act_matmul_stats", x, w, scale, shift, relu, True)
    bn_act_matmul_stats_fwd.launches += 1
    return out


matmul_stats_fwd.launches = 0
bn_act_matmul_fwd.launches = 0
bn_act_matmul_stats_fwd.launches = 0


# ---------------------------------------------------------------------------
# Autograd: the kernels forward, the plain version's autograd backward
# ---------------------------------------------------------------------------


def _vjp(plain, inputs: Sequence[torch.Tensor], cts, needs: Sequence[bool]):
    """Gradients of `plain(*inputs)` under cotangents `cts` (None counts
    as zero) for the inputs flagged in `needs`, None for the others."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = plain(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cts = [torch.zeros_like(o) if c is None else c
               for o, c in zip(outs, cts)]
        wanted = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(outs, wanted, cts,
                                         allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)


class MatmulStats(torch.autograd.Function):
    """K4 forward; saves x and w."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul_stats_fwd(x, w)

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        return _vjp(mm_stats_ref, ctx.saved_tensors, (gy, gmean, gvar),
                    ctx.needs_input_grad)


class BnActMatmul(torch.autograd.Function):
    """K5 forward; saves x, scale, shift and w."""

    @staticmethod
    def forward(ctx, x, scale, shift, w, relu: bool):
        ctx.save_for_backward(x, scale, shift, w)
        ctx.relu = relu
        return bn_act_matmul_fwd(x, scale, shift, w, relu)

    @staticmethod
    def backward(ctx, gy):
        relu = ctx.relu
        return _vjp(lambda *a: bn_mm_ref(*a, relu), ctx.saved_tensors,
                    (gy,), ctx.needs_input_grad[:4]) + (None,)


class BnActMatmulStats(torch.autograd.Function):
    """K6 forward; saves x, scale, shift and w."""

    @staticmethod
    def forward(ctx, x, scale, shift, w, relu: bool):
        ctx.save_for_backward(x, scale, shift, w)
        ctx.relu = relu
        return bn_act_matmul_stats_fwd(x, scale, shift, w, relu)

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        relu = ctx.relu
        return _vjp(lambda *a: bn_mm_stats_ref(*a, relu), ctx.saved_tensors,
                    (gy, gmean, gvar), ctx.needs_input_grad[:4]) + (None,)


def matmul_stats(x: torch.Tensor, w: torch.Tensor):
    """y = x @ w with per-column (mean, biased var) of the product, the
    statistics taken in the product's epilogue. x [M, K], w [K, N] ->
    (y [M, N] in x's dtype, mean [N], var [N] in the accumulator's
    dtype). Differentiable in all three outputs."""
    return MatmulStats.apply(x, w)


def bn_act_matmul(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  w: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """y = act(x * scale + shift) @ w, the normalisation applied in the
    product's prologue. Callers fold BN into (scale, shift) with
    `fold_bn`. x [M, K], scale and shift [K], w [K, N]."""
    return BnActMatmul.apply(x, scale, shift, w, bool(relu))


def bn_act_matmul_stats(x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, w: torch.Tensor,
                        relu: bool = True):
    """K5's prologue and K4's statistics in one product: (y, mean, var)
    of act(x * scale + shift) @ w. ResNet's conv3: bn2-apply + ReLU in,
    bn3's statistics out."""
    return BnActMatmulStats.apply(x, scale, shift, w, bool(relu))
