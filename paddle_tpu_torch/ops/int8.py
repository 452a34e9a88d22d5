"""The int8 product of the inference path: int8 x int8 -> int32.

Both int8 paths of the JAX package rest on one primitive, an int8
product accumulated in int32 (`models/common.py`'s `conv2d_nhwc_int8`,
and `ops/quant.py`'s `quantized_mul`, `quantized_matmul` and
`quantized_conv2d`, where XLA runs `dot_general` and
`conv_general_dilated` with `preferred_element_type=int32`). No Pallas
kernel lies under them; this is their counterpart, as XLA's int8
product is there:

- `int8_matmul(a, b)`: `a` [M, K] and `b` [K, N] int8 -> [M, N] int32.
  On CUDA it is `torch._int_mm` (cuBLASLt's int8 tensor-core product).
  `_int_mm` takes M > 16 and K, N multiples of 8, so smaller or ragged
  operands are zero-padded (M to 17, K and N up to a multiple of 8) and
  the result sliced back: zero rows and columns add nothing to an int32
  sum, so the result stays exact. A shape `_int_mm` still refuses
  raises; there is no float fallback. On the CPU the plain version is
  an int32 `torch.matmul`.
- `im2col_nhwc`: the conv's windows over a padded NHWC tensor, as one
  [N * Ho * Wo, kh * kw * C] matrix (`as_strided`, then one copy; none
  for a 1x1 stride-1 window), columns in HWIO's (kh, kw, C) order.
- `conv2d_int8`: `im2col_nhwc` then the product against the HWIO
  weight as a [kh * kw * Cin, Cout] matrix, one product per group.
- `matrix_operand` and `conv_operands`: a weight's product operands,
  zero-padded and laid out column-major, kept on the weight tensor, so
  a product copies no weight. The weights are laid out when they are
  loaded (`models.common.quantize_conv_weights_int8`, and the
  Predictor's state through `ops.quant.lay_out_weight`); `int8_matmul`
  and `conv2d_int8` find the operands there, and lay out a weight they
  meet first (a one-off `b`) at its first product and keep it too.
  Column-major ([N, K] contiguous, cuBLASLt's int8 "TN" form):
  `_int_mm` refuses a row-major weight at some padded shapes and runs
  it 2-5x slower at K >= 1152 on an H100.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["int8_matmul", "im2col_nhwc", "conv2d_int8", "conv_pads",
           "matrix_operand", "conv_operands", "gemm_operand", "MIN_M"]

# `_int_mm`'s operand rules on CUDA: M > 16, K and N multiples of 8.
MIN_M = 17
_ALIGN = 8

_KEPT_ATTR = "_int8_operands"

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
Pair = Union[int, Sequence[int]]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pair(v: Pair) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else \
        (int(v[0]), int(v[1]))


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def gemm_operand(b: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 as `_int_mm`'s right operand: on CUDA zero-padded to
    multiples of 8, column-major; on the CPU `b` itself."""
    if not _on_card(b):
        return b
    K, N = b.shape
    Kp, Np = _round_up(K, _ALIGN), _round_up(N, _ALIGN)
    if (Kp, Np) != (K, N):
        b = F.pad(b, (0, Np - N, 0, Kp - K))
    return b.t().contiguous().t()


def _product(a: torch.Tensor, bp: torch.Tensor, n: int) -> torch.Tensor:
    """a [M, K] int8 @ bp (a `gemm_operand`, N columns kept) -> int32."""
    if not _on_card(a):
        return torch.matmul(a.to(torch.int32), bp.to(torch.int32))
    M, K = a.shape
    Mp, Kp = max(M, MIN_M), bp.shape[0]
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    out = torch._int_mm(a.contiguous(), bp)
    return out if tuple(out.shape) == (M, n) else out[:M, :n]


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32, exact."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    bp, n = matrix_operand(b)
    return _product(a, bp, n)


def _kept(w: torch.Tensor, key, matrices: Callable[[], List[torch.Tensor]]
          ) -> List[Tuple[torch.Tensor, int]]:
    """[(operand, N)] for the [K, N] int8 matrices `matrices()` makes of
    weight `w`, as `gemm_operand` lays them out, kept on `w` under `key`
    and laid out again when `w` is written in place. An inference tensor
    keeps no version count; it can be written in place only inside
    inference mode, where no weight is. On the CPU nothing is copied or
    kept."""
    if not _on_card(w):
        return [(m, int(m.shape[1])) for m in matrices()]
    tag = (key, None if w.is_inference() else w._version)
    kept = getattr(w, _KEPT_ATTR, None)
    if kept is not None and kept[0] == tag:
        return kept[1]
    ops = [(gemm_operand(m), int(m.shape[1])) for m in matrices()]
    setattr(w, _KEPT_ATTR, (tag, ops))
    return ops


def matrix_operand(b: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(operand, N) of the [K, N] int8 matrix `b`, kept on `b`."""
    (op,) = _kept(b, ("mm",), lambda: [b])
    return op


def conv_operands(wq: torch.Tensor, groups: int = 1,
                  owner: torch.Tensor = None
                  ) -> List[Tuple[torch.Tensor, int]]:
    """[(operand, N)] of the HWIO int8 conv weight `wq`, one a group,
    each [kh * kw * Cin/groups, Cout/groups], kept on `owner` (default
    `wq`; a caller passing a view of its weight, as the OIHW fluid op
    does, names the weight itself)."""
    kh, kw, cg, cout = wq.shape
    og = cout // groups
    return _kept(wq if owner is None else owner,
                 ("conv", groups, tuple(wq.stride())), lambda: [
        wq[..., g * og:(g + 1) * og].reshape(kh * kw * cg, og)
        for g in range(groups)])


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    # XLA's SAME, as models.common.same_pads (the odd one after)
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_pads(padding, hw: Tuple[int, int], khw: Tuple[int, int],
              stride: Pair = 1, dilation: Pair = 1) -> Pads:
    """((top, bottom), (left, right)) for "SAME" (XLA's, on the dilated
    window), "VALID", or explicit pairs."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding != "SAME":
            raise ValueError(f"padding must be SAME, VALID or pairs, got "
                             f"{padding!r}")
        s, d = _pair(stride), _pair(dilation)
        return tuple(_same(hw[i], (khw[i] - 1) * d[i] + 1, s[i])
                     for i in range(2))
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


def im2col_nhwc(x: torch.Tensor, kh: int, kw: int, stride: Pair = 1,
                pads: Pads = ((0, 0), (0, 0)), dilation: Pair = 1
                ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """(cols [N * Ho * Wo, kh * kw * C], (N, Ho, Wo)) of NHWC `x` padded
    with zeros by `pads`."""
    (t, b), (l, r) = pads
    if t or b or l or r:
        x = F.pad(x, (0, 0, l, r, t, b))
    x = x.contiguous()
    N, H, W, C = x.shape
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    Ho = (H - (kh - 1) * dh - 1) // sh + 1
    Wo = (W - (kw - 1) * dw - 1) // sw + 1
    if Ho < 1 or Wo < 1:
        raise ValueError(f"im2col: a {kh}x{kw} window does not fit "
                         f"{H}x{W}")
    sN, sH, sW, sC = x.stride()
    win = x.as_strided((N, Ho, Wo, kh, kw, C),
                       (sN, sH * sh, sW * sw, sH * dh, sW * dw, sC))
    return win.reshape(N * Ho * Wo, kh * kw * C), (N, Ho, Wo)


def conv2d_int8(xq: torch.Tensor, wq: torch.Tensor, stride: Pair = 1,
                padding="SAME", dilation: Pair = 1, groups: int = 1,
                owner: torch.Tensor = None) -> torch.Tensor:
    """NHWC int8 `xq` conv HWIO int8 `wq` -> NHWC int32, as XLA's
    conv_general_dilated with preferred_element_type=int32 (`padding`
    "SAME", "VALID" or ((top, bottom), (left, right)); `dilation` the
    kernel's). The weight's operands are `conv_operands(wq, groups,
    owner)`."""
    kh, kw, cg, cout = wq.shape
    groups = int(groups)
    if xq.shape[-1] != cg * groups or cout % groups:
        raise ValueError(f"conv2d_int8: input channels {xq.shape[-1]}, "
                         f"weight {tuple(wq.shape)}, groups {groups}")
    pads = conv_pads(padding, tuple(xq.shape[1:3]), (kh, kw), stride,
                     dilation)
    ops = conv_operands(wq, groups, owner)
    outs = []
    for g, (bp, n) in enumerate(ops):
        xg = xq if groups == 1 else xq[..., g * cg:(g + 1) * cg]
        cols, (N, Ho, Wo) = im2col_nhwc(xg, kh, kw, stride, pads, dilation)
        outs.append(_product(cols, bp, n).reshape(N, Ho, Wo, n))
        del cols
    return outs[0] if groups == 1 else torch.cat(outs, dim=-1)

