"""Automatic mixed precision of the fluid path (reference:
python/paddle/fluid/contrib/mixed_precision/): `decorate` (copied from
the JAX package, `decorator.py`) wraps an optimizer and pins the loss's
program to the `mixed_bf16` (or `mixed_f16`, with a static loss scale)
precision policy of `core/precision.py`, whose op autocast reads the
white and black lists of `fp16_lists.py`; `decorate(..., rewrite=True)`
inserts the cast ops into the program instead."""

from .decorator import decorate, OptimizerWithMixedPrecision
from .fp16_lists import AutoMixedPrecisionLists

__all__ = ["decorate", "OptimizerWithMixedPrecision", "AutoMixedPrecisionLists"]
