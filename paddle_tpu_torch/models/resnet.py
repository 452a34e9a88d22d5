"""ResNet v1.5 (50/101/152), the ImageNet CNN of the ladder, in PyTorch.

Counterpart of the JAX package's `models/resnet.py`: `ResNetConfig`
(`resnet50`, `tiny`, `flops_per_image`, `fused_1x1`), `init` (the same
param names, shapes, axes and order), `apply` (NHWC or NCHW input,
train or eval), `loss_fn` -> (loss, BN running-stat updates) and
`make_batch`. Activations stay NHWC, as in the reference: a conv takes
them as a channels_last NCHW view (`models.common.conv2d_nhwc`, with
XLA's SAME padding), so every activation is contiguous NHWC and a 1x1
conv's input is a [B*H*W, C] matrix without a copy.

BatchNorm is explicit scale/shift math with one-pass batch statistics
in the promoted dtype (f32, or f64 for f64 activations). With
`fused_1x1` in training, every bottleneck's 1x1 convs run on the fused
matmul+BN kernels (`kernels/fused_dense_bn.py`): conv1 as
`matmul_stats` (K4, bn1's statistics in the product's epilogue), conv3
as `bn_act_matmul_stats` (K6: bn2's apply + ReLU in its prologue, bn3's
statistics in its epilogue), on a single device only: under a mesh of
more than one rank `fused_1x1` is off, as the JAX package's gate turns
it off there (its kernels have no GSPMD rule).

Under dp (12c, sync BN), the batch statistics are the global batch's:
each dp rank sums its shard of the batch and its squares, the ranks'
sums are all-reduced (`models/common.py::dp_sum`), and the mean and
variance come from the totals, as `BuildStrategy.sync_batch_norm`
reduces them and GSPMD gives the JAX package. The EMA and the loss are
then the global batch's too. Under tp the head (`SPLIT_AXES`, which
`init` records) is column-parallel over the classes ("vocab"), as
GSPMD splits it for the JAX package, and `loss_fn`'s log-softmax runs
over the class ranks (`vocab_log_softmax`), in f32 as with no mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import fused_dense_bn as FB
from ..parallel.mesh import current_mesh
from .common import (ParamAxes, Params, ParamStore, batch_ring,
                     conv2d_nhwc_auto, dp_mean, dp_sum, tp_dense,
                     vocab_log_softmax)

__all__ = ["DEPTHS", "SPLIT_AXES", "ResNetConfig", "init", "param_shapes",
           "apply", "loss_fn", "make_batch"]

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

# the logical axes of the head, which `init` records and `apply` hands
# to `tp_dense`: one source for both
SPLIT_AXES = {"head": ("embed", "vocab")}


@dataclasses.dataclass
class ResNetConfig:
    depth: int = 50
    n_classes: int = 1000
    width: int = 64
    dtype: str = "bfloat16"      # activation dtype
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    # the bottleneck 1x1 convs on the fused matmul+BN kernels (K4, K6),
    # in training only
    fused_1x1: bool = False

    @staticmethod
    def resnet50() -> "ResNetConfig":
        return ResNetConfig(50)

    @staticmethod
    def tiny() -> "ResNetConfig":
        return ResNetConfig(depth=50, n_classes=10, width=8)

    def flops_per_image(self, hw: int = 224) -> float:
        """Training FLOPs per image, the JAX package's accounting: 8.18
        GFLOP forward at width 64 and 224 x 224 (4.089 G multiply-adds),
        x3 for forward, input and weight gradients, scaled
        quadratically in width and resolution."""
        base = 8.18e9 * (self.width / 64) ** 2 * (hw / 224) ** 2
        return 3 * base * (1 if self.depth == 50 else self.depth / 50)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _blocks(cfg: ResNetConfig):
    """(group, block, prefix, cin, mid, cout) of every bottleneck."""
    cin = cfg.width
    for gi, n in enumerate(DEPTHS[cfg.depth]):
        mid = cfg.width * 2 ** gi
        for bi in range(n):
            yield gi, bi, f"g{gi}.b{bi}", cin, mid, mid * 4
            cin = mid * 4


def init(generator: torch.Generator, cfg: ResNetConfig, device=None
         ) -> Tuple[Params, ParamAxes]:
    """Random f32 params with the JAX package's names, shapes, axes,
    order and scales (not its values: torch and jax draw different
    numbers). `device` defaults to cuda (see `resolve_device`)."""
    from .. import resolve_device

    s = ParamStore(generator, resolve_device(device))
    s.conv("stem", 7, 7, 3, cfg.width)
    s.bn("stem.bn", cfg.width)
    for _, bi, p, cin, mid, cout in _blocks(cfg):
        s.conv(f"{p}.conv1", 1, 1, cin, mid)
        s.bn(f"{p}.bn1", mid)
        s.conv(f"{p}.conv2", 3, 3, mid, mid)
        s.bn(f"{p}.bn2", mid)
        s.conv(f"{p}.conv3", 1, 1, mid, cout)
        s.bn(f"{p}.bn3", cout)
        if bi == 0:
            s.conv(f"{p}.proj", 1, 1, cin, cout)
            s.bn(f"{p}.proj.bn", cout)
    s.dense("head", cout, cfg.n_classes, axes=SPLIT_AXES["head"])
    return s.params, s.axes


def param_shapes(cfg: ResNetConfig) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of the params, in `init`'s order."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(name, k, cin, cout):
        shapes[f"{name}.w"] = (k, k, cin, cout)

    def bn(name, dim):
        for key in ("scale", "bias", "mean", "var"):
            shapes[f"{name}.{key}"] = (dim,)

    conv("stem", 7, 3, cfg.width)
    bn("stem.bn", cfg.width)
    for _, bi, p, cin, mid, cout in _blocks(cfg):
        conv(f"{p}.conv1", 1, cin, mid)
        bn(f"{p}.bn1", mid)
        conv(f"{p}.conv2", 3, mid, mid)
        bn(f"{p}.bn2", mid)
        conv(f"{p}.conv3", 1, mid, cout)
        bn(f"{p}.bn3", cout)
        if bi == 0:
            conv(f"{p}.proj", 1, cin, cout)
            bn(f"{p}.proj.bn", cout)
    shapes["head.w"] = (cout, cfg.n_classes)
    shapes["head.b"] = (cfg.n_classes,)
    return shapes


def _bn_ema(params, upd, name, mean, var, cfg):
    """The running-stat EMA updates for batch stats (mean, var)."""
    m = cfg.bn_momentum
    upd[f"{name}.mean"] = m * params[f"{name}.mean"] + (1 - m) * mean
    upd[f"{name}.var"] = m * params[f"{name}.var"] + (1 - m) * var


def _bn_stats(x: torch.Tensor):
    """One-pass batch stats over N, H and W in the promoted dtype:
    (E[x], max(E[x^2] - E[x]^2, 0)); under dp from the ranks' all-reduced
    sums of x and x^2 over their shards of the batch."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    ring = batch_ring()
    if ring is None or x.shape[0] % ring.size:
        mean = xf.mean((0, 1, 2))
        return mean, FB._max0((xf * xf).mean((0, 1, 2)) - mean * mean)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    mean = dp_sum(xf, (0, 1, 2)) / n
    return mean, FB._max0(dp_sum(xf * xf, (0, 1, 2)) / n - mean * mean)


def _bn(params, upd, name, x, cfg, train: bool):
    """BatchNorm in the promoted dtype, cast back to x's: batch stats
    (and their EMA into `upd`) in training, the running stats in eval."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if train:
        mean, var = _bn_stats(x)
        _bn_ema(params, upd, name, mean, var, cfg)
    else:
        mean, var = params[f"{name}.mean"], params[f"{name}.var"]
    inv = torch.rsqrt(var + cfg.bn_eps) * params[f"{name}.scale"]
    return ((xf - mean) * inv + params[f"{name}.bias"]).to(x.dtype)


def _fused_1x1_ok(params, p, cfg, train: bool) -> bool:
    """The fused 1x1 path: opt-in, training mode, floating weights
    (int8 weights keep conv2d_nhwc_auto's int8 path, whose per-channel
    scales the fused kernels do not apply), and no mesh of more than one
    rank, as the JAX package's gate."""
    if not (cfg.fused_1x1 and train):
        return False
    if params[f"{p}.conv1.w"].dtype == torch.int8 or \
            params[f"{p}.conv3.w"].dtype == torch.int8:
        return False
    m = current_mesh()
    return m is None or math.prod(m.shape.values()) == 1


def _fused_block_tail(params, upd, p, x, cfg):
    """conv1 with bn1's statistics in its epilogue (K4), then bn1's
    apply and ReLU; returns the input of conv2."""
    B, H, W, C = x.shape
    w1 = params[f"{p}.conv1.w"].to(x.dtype).reshape(C, -1)
    h1, m1, v1 = FB.matmul_stats(x.reshape(-1, C), w1)
    _bn_ema(params, upd, f"{p}.bn1", m1, v1, cfg)
    s1, b1 = FB.fold_bn(m1, v1, params[f"{p}.bn1.scale"],
                        params[f"{p}.bn1.bias"], cfg.bn_eps)
    h1 = FB._max0(h1.to(s1.dtype) * s1 + b1).to(x.dtype)
    return h1.reshape(B, H, W, -1)


def _fused_conv3(params, upd, p, h2raw, cfg):
    """bn2's apply and ReLU (prologue), conv3, bn3's statistics
    (epilogue) in one kernel (K6); h2raw is conv2's raw output. Returns
    the block's bn3-normalised output."""
    B, H, W, C = h2raw.shape
    m2, v2 = _bn_stats(h2raw)
    _bn_ema(params, upd, f"{p}.bn2", m2, v2, cfg)
    s2, b2 = FB.fold_bn(m2, v2, params[f"{p}.bn2.scale"],
                        params[f"{p}.bn2.bias"], cfg.bn_eps)
    w3 = params[f"{p}.conv3.w"].to(h2raw.dtype).reshape(C, -1)
    h3, m3, v3 = FB.bn_act_matmul_stats(h2raw.reshape(-1, C), s2, b2, w3,
                                        relu=True)
    _bn_ema(params, upd, f"{p}.bn3", m3, v3, cfg)
    s3, b3 = FB.fold_bn(m3, v3, params[f"{p}.bn3.scale"],
                        params[f"{p}.bn3.bias"], cfg.bn_eps)
    h3 = (h3.to(s3.dtype) * s3 + b3).to(h2raw.dtype)
    return h3.reshape(B, H, W, -1)


def apply(params: Params, cfg: ResNetConfig, img: torch.Tensor,
          train: bool = False, data_format: str = "NCHW"
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """img -> (f32 logits [B, n_classes], bn_updates). NHWC is the native
    layout; an NCHW input is transposed (and copied) to NHWC first, as
    the reference's in-graph transpose."""
    adt = cfg.torch_dtype
    if data_format == "NCHW":
        x = img.permute(0, 2, 3, 1).to(adt).contiguous()
    elif data_format == "NHWC":
        x = img.to(adt)
    else:
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    upd: Dict[str, torch.Tensor] = {}
    x = conv2d_nhwc_auto(params, "stem", x, stride=2)
    x = F.relu(_bn(params, upd, "stem.bn", x, cfg, train))
    # the reference pads with zeros, then takes a VALID 3x3/2 window
    x = F.pad(x, (0, 0, 1, 1, 1, 1))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    for gi, bi, p, *_ in _blocks(cfg):
        stride = 2 if (bi == 0 and gi > 0) else 1
        sc = x
        if bi == 0:
            sc = conv2d_nhwc_auto(params, f"{p}.proj", x, stride=stride)
            sc = _bn(params, upd, f"{p}.proj.bn", sc, cfg, train)
        if _fused_1x1_ok(params, p, cfg, train):
            h = _fused_block_tail(params, upd, p, x, cfg)
            h2raw = conv2d_nhwc_auto(params, f"{p}.conv2", h, stride=stride)
            h = _fused_conv3(params, upd, p, h2raw, cfg)
        else:
            h = F.relu(_bn(params, upd, f"{p}.bn1",
                           conv2d_nhwc_auto(params, f"{p}.conv1", x), cfg,
                           train))
            h = F.relu(_bn(params, upd, f"{p}.bn2",
                           conv2d_nhwc_auto(params, f"{p}.conv2", h,
                                            stride=stride), cfg, train))
            h = _bn(params, upd, f"{p}.bn3",
                    conv2d_nhwc_auto(params, f"{p}.conv3", h), cfg, train)
        x = F.relu(h + sc)
    x = x.mean((1, 2))                   # global average pool
    return tp_dense(params, "head", x.float(), SPLIT_AXES["head"]), upd


def loss_fn(params: Params, cfg: ResNetConfig, batch, rng=None,
            train: bool = True, data_format: str = "NCHW"):
    """Mean softmax cross-entropy of batch["img"] against
    batch["label"]: (loss, bn_updates). `rng` is unused, as in the
    reference."""
    logits, upd = apply(params, cfg, batch["img"], train=train,
                        data_format=data_format)
    labels = batch["label"].reshape(-1).long()
    logp = vocab_log_softmax(logits.float())
    return -dp_mean(logp.gather(1, labels[:, None])), upd


def make_batch(rng: Union[torch.Generator, np.random.RandomState],
               cfg: ResNetConfig, batch_size: int, hw: int = 224,
               data_format: str = "NCHW", device=None
               ) -> Dict[str, torch.Tensor]:
    """Synthetic batch: f32 images, standard normal, [B, 3, hw, hw] (NCHW)
    or [B, hw, hw, 3] (NHWC), and int64 labels uniform in
    [0, n_classes), as the reference draws them (not its numbers). On
    the generator's device for a torch.Generator, else on `device`
    (default cuda)."""
    from .. import resolve_device

    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    shape = (batch_size, 3, hw, hw) if data_format == "NCHW" \
        else (batch_size, hw, hw, 3)
    if isinstance(rng, torch.Generator):
        dev = rng.device
        img = torch.randn(shape, generator=rng, device=dev)
        label = torch.randint(0, cfg.n_classes, (batch_size,), generator=rng,
                              device=dev)
        target = resolve_device(dev if device is None else device)
    else:
        img = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        label = torch.from_numpy(rng.randint(0, cfg.n_classes, batch_size))
        target = resolve_device(device)
    return {"img": img.to(target), "label": label.long().to(target)}
