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
analysis passes (`analysis`); the trainer's front end (every
optimizer of the JAX package, SelectedRows sparse gradients,
`amp.decorate`, `metrics`, `DataFeeder`, `DataLoader` / `PyReader`
with prefetch to the card, `Executor.run_stream` and
`train_from_dataset`); eager mode (`dygraph`: the tracer on torch
autograd, the layer zoo, the eager optimizers, `TracedLayer` and
dygraph checkpoints, on the card unless `guard(CPUPlace())`); data parallelism on in-process ranks
(`CompiledProgram.with_data_parallel`, `ParallelExecutor`, and
`parallel.SPMDRunner` with the `GradAllReduce` / `LocalSGD` transpilers
and the fleet facade); and the top-level conveniences (`fluid.data`,
`fluid.embedding`, `fluid.one_hot`, `cpu_places`, `cuda_places`, ...).

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
           "inference", "AnalysisConfig", "create_paddle_predictor",
           "CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "ParallelExecutor", "CUDAPinnedPlace", "is_compiled_with_tpu",
           "parallel", "incubate", "fluid", "data", "embedding", "one_hot",
           "name_scope", "cpu_places", "cuda_places", "device_guard",
           "memory_optimize", "release_memory", "create_lod_tensor",
           "load_op_library", "require_version", "__version__", "metrics",
           "data_feeder", "DataFeeder", "reader", "DataLoader", "PyReader",
           "amp", "trainer", "dygraph", "enable_dygraph",
           "disable_dygraph", "debugger", "contrib", "TPUPinnedPlace",
           "backward_module", "models", "serving", "profiler", "ps",
           "slim"]

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
                          CUDAPinnedPlace, TPUPinnedPlace, cpu_places,
                          cuda_places, is_compiled_with_cuda,
                          is_compiled_with_tpu)
from .core.compiler import (CompiledProgram, BuildStrategy,  # noqa: E402
                            ExecutionStrategy, ParallelExecutor)
from . import parallel  # noqa: E402
from . import layers  # noqa: E402
from . import initializer  # noqa: E402
from . import regularizer  # noqa: E402
from . import clip  # noqa: E402
from . import optimizer  # noqa: E402
from . import param_attr  # noqa: E402
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: E402
from . import nets  # noqa: E402
from . import backward  # noqa: E402
from . import backward as backward_module  # noqa: E402
from .core.flags import get_flags, set_flags  # noqa: E402
from . import io  # noqa: E402
from .io import (save, load, save_inference_model,  # noqa: E402
                 load_inference_model)
from . import inference  # noqa: E402
from .inference import AnalysisConfig, create_paddle_predictor  # noqa: E402
from . import incubate  # noqa: E402
from . import metrics  # noqa: E402
from . import data_feeder  # noqa: E402
from .data_feeder import DataFeeder  # noqa: E402
from . import reader  # noqa: E402
from .reader import DataLoader, PyReader  # noqa: E402
from . import amp  # noqa: E402
from . import trainer  # noqa: E402
from . import dygraph  # noqa: E402
from .dygraph.base import enable_dygraph, disable_dygraph  # noqa: E402
from . import debugger  # noqa: E402
from . import contrib  # noqa: E402
from . import slim  # noqa: E402
from . import models  # noqa: E402
from . import serving  # noqa: E402
from . import profiler  # noqa: E402
from . import ps  # noqa: E402

__version__ = "0.1.0"   # the JAX package's (paddle_tpu/version.py)

# `paddle_tpu_torch.fluid`-style alias so reference code reads naturally.
import sys as _sys  # noqa: E402

fluid = _sys.modules[__name__]

# Top-level conveniences the reference exposes on the fluid package, as
# the JAX package's `__init__` has them. fluid.embedding / fluid.one_hot
# are the V2 ops (lookup_table_v2 / one_hot_v2: no trailing-1 squeeze),
# unlike layers.embedding / layers.one_hot.


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """reference: input.py `embedding` -> lookup_table_v2 (keeps the id
    tensor's shape: ids [N, 1] -> out [N, 1, D], unlike layers.embedding
    whose v1 op squeezes the trailing 1)."""
    from .layer_helper import LayerHelper

    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    pidx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(type="lookup_table_v2",
                     inputs={"W": w, "Ids": input},
                     outputs={"Out": out},
                     attrs={"padding_idx": pidx, "is_sparse": is_sparse,
                            "is_distributed": is_distributed})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    """reference: input.py `one_hot` -> one_hot_v2 (appends the depth dim
    to the unchanged input shape: [N, 1] -> [N, 1, depth], unlike
    layers.one_hot whose v1 op replaces a trailing 1)."""
    from .layer_helper import LayerHelper

    helper = LayerHelper("one_hot_v2")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot_v2", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"depth": depth,
                            "allow_out_of_range": allow_out_of_range})
    return out


import contextlib as _contextlib  # noqa: E402


@_contextlib.contextmanager
def name_scope(prefix: str = ""):
    """reference: framework.name_scope, a cosmetic op-name grouping for
    graph visualization. Ops are anonymous in the IR, so the scope is
    for source compatibility only."""
    yield


def data(name, shape, dtype="float32", lod_level=0):
    """reference: fluid/data.py `fluid.data`: the new-style feed var
    whose `shape` includes the batch dim (None/-1 for dynamic), unlike
    layers.data, which prepends one."""
    shape = [(-1 if s is None else int(s)) for s in shape]
    return layers.data(name=name, shape=shape, dtype=dtype,
                       append_batch_size=False, lod_level=lod_level)


def device_guard(device=None):
    """reference: framework.device_guard, a per-op placement hint. Every
    op runs on the executor's place here; accepted for source
    compatibility."""
    return _contextlib.nullcontext()


def memory_optimize(*args, **kwargs):
    """Deprecated in the reference (io.py memory_optimize: 'has no
    effect'); the CUDA caching allocator reuses memory here. No-op."""
    import warnings as _w

    _w.warn("memory_optimize is deprecated and has no effect "
            "(the caching allocator reuses memory)", DeprecationWarning)


def release_memory(*args, **kwargs):
    """Deprecated reference API; no-op (see memory_optimize)."""
    import warnings as _w

    _w.warn("release_memory is deprecated and has no effect",
            DeprecationWarning)


def create_lod_tensor(*args, **kwargs):
    """LoD tensors are a documented refusal, as in the JAX package:
    variable length is padded batches and explicit lengths or masks."""
    raise NotImplementedError(
        "LoDTensor is not supported: the fluid path runs padded batches. "
        "Migrate to padded batches + a `length`/mask tensor")


def load_op_library(path):
    """reference: framework.load_op_library (a custom C++/CUDA op .so).
    Custom ops here are torch kernels registered in Python."""
    raise NotImplementedError(
        "custom op libraries are not loadable; register a torch kernel "
        "instead: paddle_tpu_torch.core.registry.register_op (a "
        "hand-written CUDA kernel goes behind it, as kernels/ does)")


def require_version(min_version: str, max_version=None):
    """reference: framework.require_version — raise when the installed
    version falls outside [min_version, max_version]. Components are
    zero-padded to equal length before comparison ("0.1" == "0.1.0");
    non-numeric suffixes participate as strings so "0.1.0rc1" != "0.1.0"."""
    def parse(v, width):
        parts = []
        for p in str(v).split("."):
            num = "".join(ch for ch in p if ch.isdigit())
            parts.append((int(num) if num else 0,
                          "".join(ch for ch in p if not ch.isdigit())))
        parts += [(0, "")] * (width - len(parts))
        return tuple(parts)

    width = max(len(str(v).split(".")) for v in
                (__version__, min_version, max_version or "0"))
    cur = parse(__version__, width)
    if parse(min_version, width) > cur:
        raise RuntimeError(
            f"installed version {__version__} < required {min_version}")
    if max_version is not None and parse(max_version, width) < cur:
        raise RuntimeError(
            f"installed version {__version__} > allowed {max_version}")


def set_global_seed(seed: int):
    """Seed program-level RNG (reference: fluid.Program.random_seed)."""
    framework.set_global_seed(seed)
