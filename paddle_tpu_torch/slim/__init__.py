"""Model compression (reference: python/paddle/fluid/contrib/slim, the
quantization, pruning, NAS and distillation toolkit): everything the
JAX package's `slim/` holds. Post-training int8 quantization
(`quantization.py`: weight-only PTQ and the calibrated rewrite to the
int8 runtime ops), quantization-aware training (`qat.py`: the transform
that inserts the fake-quant ops and the freeze pass), magnitude pruning
with sensitivity analysis (`prune.py`), knowledge distillation
(`distillation.py`: the teacher merge and the soft-label, L2 and FSP
losses), simulated-annealing NAS with a TCP controller server
(`nas.py`), the half-precision inference transpiler (`float16.py`,
bfloat16 by default) and the config-driven `Compressor` that schedules
them over epochs (`core.py`; a YAML config needs PyYAML, a dict does
not)."""

from .quantization import (  # noqa: F401
    PostTrainingQuantization,
    calibrate_and_quantize,
    load_quantized_vars,
    quantize_inference_model,
)
from .qat import (  # noqa: F401
    QuantizationFreezePass, QuantizationTransformPass,
)
from .prune import Pruner, SensitivePruneStrategy  # noqa: F401
from . import distillation  # noqa: F401
from .nas import ControllerServer, SAController, SearchAgent  # noqa: F401
from .float16 import float16_transpile  # noqa: F401

__all__ = ["ControllerServer", "PostTrainingQuantization", "Pruner",
           "QuantizationFreezePass", "QuantizationTransformPass",
           "SAController", "SearchAgent", "SensitivePruneStrategy",
           "calibrate_and_quantize", "distillation", "float16_transpile",
           "load_quantized_vars", "quantize_inference_model"]
