# Copied from the JAX package: paddle_tpu/backward.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Module alias: `paddle_tpu_torch.backward` mirrors the reference's
python/paddle/fluid/backward.py public surface."""

from .core.backward import append_backward, gradients  # noqa: F401

__all__ = ["append_backward", "gradients"]
