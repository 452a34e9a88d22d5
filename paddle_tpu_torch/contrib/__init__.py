"""fluid.contrib utility surface (reference: python/paddle/fluid/contrib/
memory_usage_calc.py, op_frequence.py, model_stat.py — the three
analysis helpers alongside the slim/AMP/quant toolkits, which live in
paddle_tpu_torch.slim / paddle_tpu_torch.amp here)."""

from .utils import memory_usage, op_freq_statistic, summary  # noqa: F401

__all__ = ["memory_usage", "op_freq_statistic", "summary"]
