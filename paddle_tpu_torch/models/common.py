"""Shared building blocks of the model zoo, in PyTorch.

Counterpart of the JAX package's `models/common.py`. Params are flat
dicts {name: tensor} keyed by the same names and held in the same
layouts (`x @ w` with w `[in, out]`), so parameters carry across by
name (see `convert.params_from_numpy`).

The Megatron helpers (`tp_dense`, `vocab_embed`, `vocab_logits`,
`vocab_log_softmax`) and `dp_sum` carry tp and dp on the current mesh's
in-process rings (`parallel/mesh.py`), where the JAX package has GSPMD
split by its `shard()` constraints. Each reads the split from
`current_rules()` and the param's logical axes: a weight whose output
axis ("heads", "mlp", "vocab") maps to a ring is column-parallel (each
rank's product on its slice of the columns, the slices joined), one
whose input axis does is row-parallel (each rank's partial product,
summed by `ring.all_reduce`), and the vocab axis of an embedding is
split by rows (ids outside a rank's rows masked, the lookups summed).
A rule of None for the axis keeps the param whole. A param axis other
than those three that the rules map to a mesh axis larger than 1 (for
example "embed" -> "tp") raises: no helper splits it. So do a spec
that maps one mesh axis onto two dims of a param (VGG's `fc2.w`,
("mlp", "mlp"), under rules that map "mlp" to "tp") and a split dim
that its ring does not divide, where the JAX package's placement
refuses them. Each helper holds
whole tensors on the ring and returns the whole result, so a model's
math is the same with or without a mesh, up to the order of the sums.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import math

import torch
import torch.nn.functional as F

from ..ops.int8 import conv2d_int8, conv_operands
from ..parallel.mesh import current_mesh
from ..parallel.sharding import (axis_ring, check_param_spec, current_rules,
                                 in_manual_region)

Params = Dict[str, torch.Tensor]
ParamAxes = Dict[str, Tuple[Optional[str], ...]]

__all__ = ["ParamStore", "Params", "raw_layer_norm", "layer_norm", "gelu",
           "dense", "dropout", "is_trainable", "same_pads", "conv2d_nhwc",
           "conv2d_nhwc_auto", "maxpool2x2_nhwc",
           "quantize_conv_weights_int8", "conv2d_nhwc_int8", "TP_AXES",
           "axis_ring", "batch_ring", "dp_sum", "dp_mean", "tp_linear",
           "tp_dense", "vocab_embed", "vocab_logits", "vocab_log_softmax"]


class ParamStore:
    """Accumulates params and their logical axes during init. Random
    values come from the caller's `torch.Generator`, on the generator's
    device, and are then moved to `device`."""

    def __init__(self, generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.device = device
        self.dtype = dtype
        self.params: Params = {}
        self.axes: ParamAxes = {}

    def normal(self, shape, scale: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.generator,
                        device=self.generator.device, dtype=self.dtype)
        return (x * scale).to(self.device)

    def add(self, name: str, value: torch.Tensor,
            axes: Tuple[Optional[str], ...]) -> torch.Tensor:
        if name in self.params:
            raise ValueError(f"duplicate param {name}")
        if value.ndim != len(axes):
            raise ValueError(f"{name}: shape {tuple(value.shape)} does not "
                             f"match axes {axes}")
        self.params[name] = value
        self.axes[name] = axes
        return value

    def dense(self, name: str, d_in: int, d_out: int,
              axes=("embed", "mlp")):
        """`{name}.w` [d_in, d_out] (normal, scale sqrt(2/(d_in+d_out)))
        and a zero `{name}.b` [d_out]."""
        scale = math.sqrt(2.0 / (d_in + d_out))
        self.add(f"{name}.w", self.normal((d_in, d_out), scale), axes)
        self.add(f"{name}.b", torch.zeros(d_out, dtype=self.dtype,
                                          device=self.device), (axes[1],))

    def layer_norm(self, name: str, dim: int, axis: Optional[str] = None):
        self.add(f"{name}.scale", torch.ones(dim, dtype=self.dtype,
                                             device=self.device), (axis,))
        self.add(f"{name}.bias", torch.zeros(dim, dtype=self.dtype,
                                             device=self.device), (axis,))

    def embedding(self, name: str, vocab: int, dim: int,
                  axes=("vocab", "embed"), scale: float = 0.02):
        self.add(f"{name}.w", self.normal((vocab, dim), scale), axes)

    def conv(self, name: str, kh: int, kw: int, cin: int, cout: int,
             axes=(None, None, None, "conv_out")):
        """`{name}.w` [kh, kw, cin, cout] (HWIO), normal with scale
        sqrt(2 / fan_in)."""
        scale = math.sqrt(2.0 / (kh * kw * cin))
        self.add(f"{name}.w", self.normal((kh, kw, cin, cout), scale), axes)

    def bn(self, name: str, dim: int):
        """BatchNorm: trainable `.scale` (ones) and `.bias` (zeros) in the
        store's dtype, and the running statistics `.mean` (zeros) and
        `.var` (ones) in f32, state kept in the same dict (see
        `is_trainable`)."""
        for key, fill, dtype in (("scale", 1.0, self.dtype),
                                 ("bias", 0.0, self.dtype),
                                 ("mean", 0.0, torch.float32),
                                 ("var", 1.0, torch.float32)):
            self.add(f"{name}.{key}", torch.full((dim,), fill, dtype=dtype,
                                                 device=self.device), (None,))


def is_trainable(name: str) -> bool:
    """False for running statistics (BN `.mean`/`.var`), which sit in the
    same dict but are state, not parameters."""
    return not (name.endswith(".mean") or name.endswith(".var"))


def dense(params: Params, name: str, x: torch.Tensor,
          act=None) -> torch.Tensor:
    """`x @ w + b` with w and b cast to x's dtype, then `act`."""
    y = x @ params[f"{name}.w"].to(x.dtype)
    b = params.get(f"{name}.b")
    if b is not None:
        y = y + b.to(y.dtype)
    return act(y) if act is not None else y


# -- tp and dp on the mesh's in-process rings --------------------------

# the logical axes of a param that the Megatron helpers split
TP_AXES = ("heads", "mlp", "vocab")


def batch_ring():
    """The ring that carries "batch" (dp), None inside a manual region:
    the pipeline hands each stage call its dp shard already."""
    return None if in_manual_region() else axis_ring("batch")


def dp_sum(x: torch.Tensor, dims=None) -> torch.Tensor:
    """`x` summed over `dims` (all of them by default), dim 0 being the
    batch: over a dp ring that divides it, each rank sums its shard of
    the batch and `ring.all_reduce` adds the ranks' sums, as
    `jax.lax.psum` over 'dp' adds the shards' under GSPMD. The global
    batch's sum, so a mean taken from it is the global mean."""
    ring = batch_ring()
    if ring is None or x.shape[0] % ring.size:
        return x.sum() if dims is None else x.sum(tuple(dims))
    dims = tuple(range(x.ndim)) if dims is None else tuple(dims)
    return ring.all_reduce([p.sum(dims) for p in ring.split(x, 0)])[0]


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of all of `x`, from `dp_sum` over a dp ring."""
    return x.mean() if batch_ring() is None else dp_sum(x) / x.numel()


def _param_split(name: str, axes, shape) -> Tuple[Optional[int], object]:
    """(dim, ring) of the one dim of param `name` (logical `axes`, of
    `shape`) that the rules split over a ring larger than 1, or (None,
    None). A spec that maps one mesh axis onto two dims raises
    ValueError whatever the axis's size (`check_param_spec`, as the JAX
    package's placement refuses it), and so does a split dim that its
    ring does not divide."""
    m = current_mesh()
    if m is None:
        return None, None
    rules = current_rules()
    found = (None, None)
    for d, a in enumerate(axes):
        ax = rules.mesh_axis(a)
        if ax is None or m.shape.get(ax, 1) == 1:
            continue
        if a not in TP_AXES:
            raise NotImplementedError(
                f"the rule {a!r} -> {ax!r} splits {name} along {a!r}, "
                f"which no helper of the port splits (they split "
                f"{list(TP_AXES)}); map {a!r} to None")
        if shape[d] % m.shape[ax]:
            raise ValueError(
                f"dim {d} ({a!r}) of {name}, of size {shape[d]}, does not "
                f"split over mesh axis {ax!r} of {m.shape[ax]}")
        found = (d, m.rings[ax])
    check_param_spec(name, axes, rules)
    return found


def tp_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              name: str, axes, act=None) -> torch.Tensor:
    """`act(x @ w + b)` with `w` ([in, out], logical `axes`, called
    `name`) split by the rules: column-parallel on a split out axis
    (the bias split with it, `act` on each rank's slice), row-parallel
    on a split in axis (x's last dim split with it, the partial
    products all-reduced, the bias added once), whole with neither."""
    d, ring = _param_split(name, axes, w.shape)
    w = w.to(x.dtype)
    if ring is None:
        y = x @ w
    elif d == 1:
        bs = ring.split(b, 0) if b is not None else [None] * ring.size
        ys = []
        for w_r, b_r in zip(ring.split(w, 1), bs):
            y = x @ w_r
            y = y if b_r is None else y + b_r.to(y.dtype)
            ys.append(act(y) if act is not None else y)
        return ring.join(ys, -1)
    else:
        y = ring.all_reduce([x_r @ w_r for x_r, w_r in zip(
            ring.split(x, x.ndim - 1), ring.split(w, 0))])[0]
    if b is not None:
        y = y + b.to(y.dtype)
    return act(y) if act is not None else y


def tp_dense(params: Params, name: str, x: torch.Tensor, axes,
             act=None) -> torch.Tensor:
    """`dense` by `tp_linear`, `{name}.w` having logical `axes`."""
    return tp_linear(x, params[f"{name}.w"], params.get(f"{name}.b"),
                     f"{name}.w", axes, act)


def vocab_embed(w: torch.Tensor, ids: torch.Tensor, name: str,
                axes) -> torch.Tensor:
    """`w[ids]`, with the vocab rows of `w` split over their ring: rank
    r looks up the ids inside its rows (zeros elsewhere) and
    `ring.all_reduce` adds the ranks' lookups, each id's row coming
    from the one rank that holds it."""
    _, ring = _param_split(name, axes, w.shape)
    if ring is None:
        return w[ids]
    parts = ring.split(w, 0)
    n = parts[0].shape[0]
    outs = []
    for r, w_r in enumerate(parts):
        local = ids - r * n
        inside = (local >= 0) & (local < n)
        outs.append(torch.where(inside[..., None],
                                w_r[local.clamp(0, n - 1)],
                                torch.zeros((), dtype=w.dtype,
                                            device=w.device)))
    return ring.all_reduce(outs)[0]


def vocab_logits(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor], name: str,
                 axes) -> torch.Tensor:
    """`x @ w.T (+ bias)` for a tied embedding `w` [vocab, embed]: on a
    split vocab, each rank's logits over its rows, joined."""
    _, ring = _param_split(name, axes, w.shape)
    wt = w.to(x.dtype)
    if ring is None:
        y = x @ wt.T
        return y if bias is None else y + bias.to(y.dtype)
    bs = ring.split(bias, 0) if bias is not None else [None] * ring.size
    ys = []
    for w_r, b_r in zip(ring.split(wt, 0), bs):
        y = x @ w_r.T
        ys.append(y if b_r is None else y + b_r.to(y.dtype))
    return ring.join(ys, -1)


def vocab_log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """log_softmax over the last (vocab) axis; on a split vocab from the
    ranks' slices: the global max by an all-reduce of max, the global
    sum of exp by an all-reduce of sum, as Megatron's vocab-parallel
    cross entropy."""
    ring = axis_ring("vocab")
    if ring is None:
        return F.log_softmax(logits, dim=-1)
    parts = ring.split(logits, logits.ndim - 1)
    m = ring.all_reduce([p.detach().amax(-1, keepdim=True) for p in parts],
                        "max")[0]
    s = ring.all_reduce([torch.exp(p - m).sum(-1, keepdim=True)
                         for p in parts])[0]
    lse = m + torch.log(s)
    return ring.join([p - lse for p in parts], -1)


def dropout(generator: Optional[torch.Generator], x: torch.Tensor,
            rate: float, deterministic: bool) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate) in x's dtype. The identity when
    deterministic, at rate 0 or without a generator. The bits come from
    `generator` (on x's device), so they are not jax.random's bits."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def raw_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-12) -> torch.Tensor:
    """Layer norm over the last axis, computed in f32 and cast back to
    x's dtype (population variance, as jnp.var)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm(params: Params, name: str, x: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    return raw_layer_norm(x, params[f"{name}.scale"], params[f"{name}.bias"],
                          eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form, as jax.nn.gelu(approximate=True)."""
    return F.gelu(x, approximate="tanh")


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after), with
    total = max((ceil(size / stride) - 1) * stride + k - size, 0) and
    the odd one after. Asymmetric at stride 2 on an even size, where
    a symmetric k // 2 would shift the window."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding="SAME") -> torch.Tensor:
    """NHWC conv with HWIO weights, as jax.lax.conv_general_dilated with
    ("NHWC", "HWIO", "NHWC"). `padding` is "SAME" (XLA's) or "VALID".
    The input goes to the conv as an NCHW view of NHWC memory
    (channels_last), so the result, permuted back, is contiguous NHWC
    again: no transpose is copied."""
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        (top, bottom), (left, right) = (same_pads(x.shape[1], kh, stride),
                                        same_pads(x.shape[2], kw, stride))
    elif padding == "VALID":
        top = bottom = left = right = 0
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    if top == bottom and left == right:
        conv_pad = (top, left)
    else:
        x = F.pad(x, (0, 0, left, right, top, bottom))
        conv_pad = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=conv_pad)
    return y.permute(0, 2, 3, 1)


def maxpool2x2_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool at stride 2, VALID (odd edges dropped), NHWC, as the
    JAX package's reduce_window."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


# -- the int8 serving path: int8 convs with per-output-channel weight
#    scales and a dynamic per-tensor activation scale, accumulated in
#    int32 (ops/int8.py) ------------------------------------------------


def quantize_conv_weights_int8(params: Params) -> Params:
    """Per-output-channel symmetric int8 for every 4-D HWIO conv weight
    '*.w': scale amax / 127 (1.0 where a channel is all zeros), values
    round(w / scale) (half to even) clipped to +-127; adds '<k>@scale'
    [O] f32 and leaves everything else untouched. The result feeds the
    same model apply(): conv2d_nhwc_auto dispatches on the weight
    dtype. On the card each int8 weight's product operand is laid out
    here, once (`ops.int8.conv_operands`)."""
    out = dict(params)
    for k, v in params.items():
        if k.endswith(".w") and v.ndim == 4:
            w = v.float()
            amax = w.abs().amax(dim=(0, 1, 2))
            scale = torch.where(amax > 0, amax / 127.0,
                                torch.ones_like(amax))
            out[k] = torch.clamp(torch.round(w / scale), -127,
                                 127).to(torch.int8)
            conv_operands(out[k])
            out[k + "@scale"] = scale
    return out


def conv2d_nhwc_int8(x: torch.Tensor, wq: torch.Tensor,
                     w_scale: torch.Tensor, stride: int = 1,
                     padding="SAME") -> torch.Tensor:
    """int8 x int8 -> int32 conv (`ops.int8.conv2d_int8`); the
    activation is quantized per tensor (scale max(|x|max, 1e-8) / 127),
    the result dequantized per output channel by xs * w_scale, the
    scales multiplied first as the JAX package does. Returns f32."""
    xf = x.float()
    xs = torch.clamp(xf.abs().max(), min=1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    del xf
    acc = conv2d_int8(xq, wq, stride, padding)
    del xq
    return acc.float() * (xs * w_scale.reshape(1, 1, 1, -1))


def conv2d_nhwc_auto(params: Params, name: str, x: torch.Tensor,
                     stride: int = 1, padding="SAME") -> torch.Tensor:
    """The conv the model zoo shares: int8 weights (from
    quantize_conv_weights_int8) take the int8 path with their
    '{name}.w@scale', anything else the plain conv with `{name}.w` cast
    to x's dtype. Output in x's dtype either way."""
    w = params[f"{name}.w"]
    if w.dtype == torch.int8:
        return conv2d_nhwc_int8(x, w, params[f"{name}.w@scale"], stride,
                                padding).to(x.dtype)
    return conv2d_nhwc(x, w.to(x.dtype), stride, padding)
