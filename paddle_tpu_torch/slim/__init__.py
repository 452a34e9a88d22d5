"""Model compression, for what is ported: post-training int8
quantization (`quantization.py`: weight-only PTQ and the calibrated
rewrite to the int8 runtime ops). Quantization-aware training, pruning,
distillation, NAS and the float16 transpiler are still to port (ROADMAP
item 15)."""

from .quantization import (  # noqa: F401
    PostTrainingQuantization,
    calibrate_and_quantize,
    load_quantized_vars,
    quantize_inference_model,
)

__all__ = ["PostTrainingQuantization", "calibrate_and_quantize",
           "load_quantized_vars", "quantize_inference_model"]
