# Copied from the JAX package's paddle_tpu/incubate/fleet/collective/__init__.py; nothing else differs.

"""reference: incubate/fleet/collective/__init__.py — the collective
(GSPMD data-parallel) fleet singleton + optimizer wrapper + strategy."""

from ....parallel.fleet import (DistributedOptimizer,  # noqa: F401
                                Fleet, fleet)
from ....parallel.strategy import DistributedStrategy  # noqa: F401

__all__ = ["fleet", "Fleet", "DistributedOptimizer", "DistributedStrategy"]
