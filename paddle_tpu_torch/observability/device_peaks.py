# Copied from the JAX package: paddle_tpu/observability/device_peaks.py
# (stdlib only). Keep it in step with that file; its one change
# adds the H100 rows at the head of PEAKS.
"""Per-device-kind peak-throughput table — the ONE MFU denominator.

Before this module, the v5e peak lived hardcoded in three places
(bench.py PEAK_FLOPS, tools/rn50_bytes_table.py PEAK_TF/PEAK_BW,
tools/rn50_roofline.py) and a fourth consumer (the live
`paddle_tpu_mfu` gauge, observability/perfwatch.py) was about to add
one more. Bench-time MFU and serve-time MFU must divide by the SAME
number or the acceptance comparison between them is meaningless, so
the table lives here and everything imports it.

Numbers are public per-chip peak dense bf16 matmul throughput, HBM
bandwidth and capacity. `ici_bytes_per_s` is a one-direction aggregate
inter-chip figure used only for the collective-time ESTIMATE in the
step-time breakdown — it is labeled an estimate everywhere it
surfaces.

Stdlib-only by contract: perfwatch (imported by core/executor.py at
module load) pulls this in, and tools/obsdump.py loads observability
modules standalone by file path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

__all__ = ["DevicePeak", "PEAKS", "DEFAULT_PEAK", "PLATFORM_PEAK_FLOPS",
           "lookup", "peak_flops", "platform_peak_flops"]


class DevicePeak(NamedTuple):
    """Peak per-chip figures. flops is dense bf16 (the training/serving
    number every MFU in this repo is quoted against)."""
    flops: float             # peak bf16 matmul FLOP/s per chip
    hbm_bytes_per_s: float   # HBM bandwidth
    hbm_bytes: float         # HBM capacity
    ici_bytes_per_s: float   # approx one-direction inter-chip aggregate


# Keyed by a lowercase substring of jax's device_kind ("TPU v5 lite",
# "TPU v4", ...). Order matters: first match wins, so more specific
# kinds precede generic ones.
PEAKS = (
    # NVIDIA cards, keyed by substrings of torch.cuda.get_device_name()
    # ("NVIDIA H100 PCIe", "NVIDIA H100 80GB HBM3"): public per-card
    # dense bf16, HBM bandwidth, HBM capacity and one-direction NVLink
    # (half the bidirectional figure). PCIe before SXM: more specific.
    ("h100 pcie", DevicePeak(756e12, 2.0e12, 80e9, 300e9)),
    ("h100 sxm", DevicePeak(989e12, 3.35e12, 80e9, 450e9)),
    ("h100 80gb hbm3", DevicePeak(989e12, 3.35e12, 80e9, 450e9)),
    ("v5 lite", DevicePeak(197e12, 819e9, 16e9, 186e9)),   # v5e
    ("v5e", DevicePeak(197e12, 819e9, 16e9, 186e9)),
    ("v5p", DevicePeak(459e12, 2765e9, 95e9, 600e9)),
    ("v6 lite", DevicePeak(918e12, 1640e9, 32e9, 448e9)),  # v6e / Trillium
    ("v6e", DevicePeak(918e12, 1640e9, 32e9, 448e9)),
    ("v4", DevicePeak(275e12, 1228e9, 32e9, 268e9)),
    ("v3", DevicePeak(123e12, 900e9, 32e9, 70e9)),
    ("v2", DevicePeak(45e12, 700e9, 16e9, 62e9)),
)

# Unknown hardware (CPU test rigs, emulators): a deliberately generous
# 1 TF/s strawman so MFU stays finite and obviously-not-a-TPU numbers
# read as such instead of flattering anyone.
DEFAULT_PEAK = DevicePeak(1e12, 100e9, 8e9, 10e9)

# bench.py's historical platform-level map (it resolves by jax platform
# string before any device_kind is known). tpu maps to the v5e figure —
# the chip every BASELINE.json target is quoted for.
PLATFORM_PEAK_FLOPS = {"tpu": 197e12, "cpu": 1e12, "gpu": 100e12}


def lookup(device_kind: Optional[str]) -> DevicePeak:
    """Peak figures for a jax device_kind string (case-insensitive
    substring match); DEFAULT_PEAK when unknown."""
    dk = (device_kind or "").lower()
    for key, peak in PEAKS:
        if key in dk:
            return peak
    return DEFAULT_PEAK


def peak_flops(device_kind: Optional[str]) -> float:
    return lookup(device_kind).flops


def platform_peak_flops(platform: Optional[str]) -> float:
    """bench.py's denominator: jax platform string -> peak FLOP/s."""
    return PLATFORM_PEAK_FLOPS.get(platform or "", DEFAULT_PEAK.flops)
