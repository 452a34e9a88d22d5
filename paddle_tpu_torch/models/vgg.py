"""VGG-16, in PyTorch: the reference's headline float16 inference model
(paddle/contrib/float16/float16_benchmark.md: VGG16 ImageNet on a
V100), as the JAX package's `models/vgg.py` builds it.

NHWC convs in the config's dtype with the bias added after the conv,
2x2 max pools, and the fc head with f32 logits. Conv weights quantized
by `quantize_conv_weights_int8` run the int8 path
(`common.conv2d_nhwc_auto`). Params carry the JAX package's names,
shapes and scales (not its values: torch and jax draw different
numbers), so JAX params load through `convert.params_from_numpy`.

Under a mesh the fc layers split by their `init` axes (`SPLIT_AXES`,
through `models/common.py::tp_dense`). Under the default rules
`fc2.w` ("mlp", "mlp") maps "tp" onto both of its dims, which the JAX
package's placement refuses (`DuplicateSpecError`) and the port's
`check_param_spec` too, so VGG trains on a mesh only under rules that
map "mlp" to None: there `fc1` and `fc2` are whole and the head is
column-parallel over the classes ("vocab"), on its f32 input. Under dp
the model has no reduction over the batch of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .common import (ParamAxes, Params, ParamStore, conv2d_nhwc_auto,
                     maxpool2x2_nhwc, tp_dense)

__all__ = ["BLOCKS", "SPLIT_AXES", "VGGConfig", "init", "apply"]

# the logical axes of the fc weights, which `init` records and `apply`
# hands to `tp_dense`: one source for both
SPLIT_AXES = {"fc1": ("embed", "mlp"), "fc2": ("mlp", "mlp"),
              "head": ("mlp", "vocab")}

# channels per conv block (VGG-16: 2-2-3-3-3 convs)
BLOCKS = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]


@dataclasses.dataclass
class VGGConfig:
    n_classes: int = 1000
    dtype: str = "bfloat16"
    width_mult: float = 1.0     # channel scale (tiny testing configs)
    image_hw: int = 224         # fc1's fan-in is fixed by the input size

    @staticmethod
    def vgg16():
        return VGGConfig()

    @staticmethod
    def tiny():
        return VGGConfig(n_classes=10, width_mult=0.125, image_hw=32)

    def channels(self, c):
        return max(8, int(c * self.width_mult))

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init(generator: torch.Generator, cfg: VGGConfig, device=None
         ) -> Tuple[Params, ParamAxes]:
    """Random f32 params with the JAX package's names, shapes, axes and
    order. `device` defaults to cuda (see `resolve_device`)."""
    from .. import resolve_device

    dev = resolve_device(device)
    s = ParamStore(generator, dev)
    cin = 3
    for bi, (n_convs, cout) in enumerate(BLOCKS):
        cout = cfg.channels(cout)
        for ci in range(n_convs):
            s.conv(f"b{bi}.c{ci}", 3, 3, cin, cout)
            s.add(f"b{bi}.c{ci}.b", torch.zeros(cout, device=dev), (None,))
            cin = cout
    feat_hw = cfg.image_hw // 32        # 5 stride-2 pools
    fc_dim = max(64, int(4096 * cfg.width_mult))
    s.dense("fc1", cin * feat_hw * feat_hw, fc_dim, axes=SPLIT_AXES["fc1"])
    s.dense("fc2", fc_dim, fc_dim, axes=SPLIT_AXES["fc2"])
    s.dense("head", fc_dim, cfg.n_classes, axes=SPLIT_AXES["head"])
    return s.params, s.axes


def apply(params: Params, cfg: VGGConfig, img: torch.Tensor) -> torch.Tensor:
    """img [B, 3, cfg.image_hw, cfg.image_hw] (the reference's NCHW)
    -> f32 logits [B, n_classes]. The input size is fixed by fc1's
    fan-in."""
    if not img.shape[2] == img.shape[3] == cfg.image_hw:
        raise ValueError(
            f"VGG built for {cfg.image_hw}x{cfg.image_hw} inputs, got "
            f"{img.shape[2]}x{img.shape[3]} (fc1 fan-in is size-bound)")
    adt = cfg.torch_dtype
    x = img.permute(0, 2, 3, 1).to(adt).contiguous()     # NHWC
    for bi, (n_convs, _) in enumerate(BLOCKS):
        for ci in range(n_convs):
            x = conv2d_nhwc_auto(params, f"b{bi}.c{ci}", x)
            x = F.relu(x + params[f"b{bi}.c{ci}.b"].to(adt))
        x = maxpool2x2_nhwc(x)
    x = x.reshape(x.shape[0], -1)
    x = F.relu(tp_dense(params, "fc1", x, SPLIT_AXES["fc1"]))
    x = F.relu(tp_dense(params, "fc2", x, SPLIT_AXES["fc2"]))
    return tp_dense(params, "head", x.float(), SPLIT_AXES["head"])
