"""paddle_tpu_torch: the PyTorch/CUDA port of the JAX package, for
NVIDIA Hopper.

It serves GPT token generation (`serving.DecodeEngine`,
`serving.Server`), trains BERT, GPT, Transformer NMT and ResNet
(`parallel.train.make_train_step`) and beam-searches the Transformer,
through the same entry points as the JAX package, with attention on
hand-written CUDA kernels (`kernels/flash_attention.py`,
`kernels/flash_attention_bias.py`) and ResNet's fused 1x1 convs on the
hand-written matmul+BN kernels (`kernels/fused_dense_bn.py`). Under a
mesh with an `sp` ring (`parallel/mesh.py`), attention runs as ring
attention over the sequence (`ops/ring_attention.py`), full-mask blocks
on the K3 kernel. It imports torch and never jax, and nothing of the
JAX package.

Devices are explicit: every entry point runs on `cuda` unless the
caller passes `device="cpu"`, and raises when asked for `cuda` on a
machine without a GPU. There is no silent fallback to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means `cuda`. Raises when CUDA
    is asked for and not available (pass device="cpu" to run on the
    CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on cuda by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
