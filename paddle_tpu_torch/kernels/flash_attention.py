"""K1-fwd: causal (or full) flash-attention forward, a CUDA kernel for
Hopper, and its plain PyTorch version.

The kernel (`csrc/flash_attention.cu`) replaces the JAX package's
`ops/pallas/attention.py::_splash_mha`, jax's Pallas splash-attention
forward. `flash_attention` is its wrapper: on a CUDA tensor it launches
the kernel or raises; on a CPU tensor it computes `flash_attention_ref`.
There is no fallback from the card to the plain version.

Semantics (splash's): q is scaled in q's dtype before the product, the
scores, softmax and accumulation are f32, and the output has q's dtype.
Layout `[B, T, N, H]` as `mha` receives it; any strides with a last-dim
stride of 1, so the q/k/v views split out of a fused qkv projection
need no copy. H is 64 or 128; any T >= 1.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_ref", "HEAD_DIMS"]

HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: q pre-scaled
    in q.dtype, f32 logits, causal by masking, f32 softmax."""
    qs = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)).float()
    logits = torch.einsum("btnh,bsnh->bnts", qs, k.float())
    if causal:
        T, Tk = q.shape[1], k.shape[1]
        keep = torch.ones(T, Tk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnts,bsnh->btnh", probs, v.float()).to(q.dtype)


def _bind(lib: ctypes.CDLL):
    fn = lib.paddle_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
                       [ctypes.c_longlong] * 9 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if not (q.ndim == k.ndim == v.ndim == 4):
        raise ValueError("flash_attention takes [B, T, N, H] tensors")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True) -> torch.Tensor:
    """Attention over [B, T, N, H]. CUDA tensors launch the K1-fwd
    kernel on the current stream (counted in `flash_attention.launches`);
    CPU tensors take `flash_attention_ref`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    fn = _bind(_build.load("flash_attention"))
    B, T, N, H = q.shape
    out = torch.empty((B, T, N, H), dtype=q.dtype, device=q.device)
    # splash's caller multiplies by the scale held in q's dtype
    s = float(torch.tensor(scale, dtype=q.dtype))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, N, T, k.shape[1], H, _DTYPE_CODE[q.dtype],
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                s, int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
