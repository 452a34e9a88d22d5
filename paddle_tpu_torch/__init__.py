"""paddle_tpu_torch: the PyTorch/CUDA port of the JAX package, for
NVIDIA Hopper.

It serves GPT token generation (`serving.DecodeEngine`) and bucketed
batch inference of saved fluid models (`inference.Predictor` behind
`serving.Engine` and its `Batcher`, at f32, bf16 and post-training int8
from `slim.calibrate_and_quantize`), both over HTTP (`serving.Server`:
POST /v1/generate and /v1/predict); runs VGG-16 and ResNet-50 inference
at bf16 and with int8 conv weights (`models.vgg`, `models.resnet`, the
int8 product in `ops/int8.py`); trains BERT, GPT, Transformer NMT and
ResNet (`parallel.train.make_train_step`) and beam-searches the
Transformer,
through the same entry points as the JAX package, with attention on
hand-written CUDA kernels (`kernels/flash_attention.py`,
`kernels/flash_attention_bias.py`) and ResNet's fused 1x1 convs on the
hand-written matmul+BN kernels (`kernels/fused_dense_bn.py`). Under a
mesh with an `sp` ring (`parallel/mesh.py`), attention runs as ring
attention over the sequence (`ops/ring_attention.py`), full-mask blocks
on the K3 kernel. It imports torch and never jax, and nothing of the
JAX package.

It also carries the JAX package's fluid surface, for what is ported:
Programs built with `layers` under `program_guard`, `append_backward`
and `gradients`, the `optimizer` classes, an `Executor` that runs a
Program op by op on the op registry's torch kernels (`core/`, `ops/`),
model dirs in the JAX package's format (`io`), and the program
analysis passes (`analysis`).

Devices are explicit: every entry point runs on `cuda` unless the
caller passes `device="cpu"`, and raises when asked for `cuda` on a
machine without a GPU. There is no silent fallback to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "Program", "Block", "Operator", "Variable",
           "Parameter", "program_guard", "default_main_program",
           "default_startup_program", "unique_name", "in_dygraph_mode",
           "Executor", "global_scope", "scope_guard", "Scope",
           "append_backward", "gradients", "CPUPlace", "CUDAPlace",
           "TPUPlace", "XPUPlace", "is_compiled_with_cuda", "layers",
           "initializer", "regularizer", "clip", "optimizer",
           "param_attr", "ParamAttr", "WeightNormParamAttr", "nets",
           "get_flags", "set_flags", "set_global_seed", "io", "save",
           "load", "save_inference_model", "load_inference_model",
           "inference", "AnalysisConfig", "create_paddle_predictor"]

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


# The fluid namespace, as the JAX package's `__init__` exports it, for
# what is ported. Imported after `resolve_device`, which its modules use.
from . import ops  # noqa: E402  populate the op registry before any layer builds
from .core import framework  # noqa: E402
from .core.framework import (  # noqa: E402
    Program,
    Block,
    Operator,
    Variable,
    Parameter,
    program_guard,
    default_main_program,
    default_startup_program,
    unique_name,
    in_dygraph_mode,
)
from .core.executor import Executor, global_scope, scope_guard, Scope  # noqa: E402
from .core.backward import append_backward, gradients  # noqa: E402
from .core import places  # noqa: E402
from .core.places import (CPUPlace, CUDAPlace, TPUPlace, XPUPlace,  # noqa: E402
                          is_compiled_with_cuda)
from . import layers  # noqa: E402
from . import initializer  # noqa: E402
from . import regularizer  # noqa: E402
from . import clip  # noqa: E402
from . import optimizer  # noqa: E402
from . import param_attr  # noqa: E402
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: E402
from . import nets  # noqa: E402
from . import backward  # noqa: E402
from .core.flags import get_flags, set_flags  # noqa: E402
from . import io  # noqa: E402
from .io import (save, load, save_inference_model,  # noqa: E402
                 load_inference_model)
from . import inference  # noqa: E402
from .inference import AnalysisConfig, create_paddle_predictor  # noqa: E402


def set_global_seed(seed: int):
    """Seed program-level RNG (reference: fluid.Program.random_seed)."""
    framework.set_global_seed(seed)
