"""Pipeline parallelism: the GPipe schedule over the `pp` mesh axis.

Counterpart of the JAX package's `parallel/pipeline.py`
(`pipeline_apply`, `last_stream_info`). There, a `shard_map` over `pp`
runs a `lax.scan` of n_micro + S - 1 ticks: on each tick every stage
runs its layers on the activation it holds (stage 0 injects microbatch
t), the results move one stage on by `ppermute`, and the last stage's
outputs are kept. Here the same ticks run over the mesh's `pp` ring
(`core/ring.py`): each tick calls every rank's stage, then one
`hop` moves the results on.

On an in-process ring the S virtual ranks run in turn on one device.
A rank skips its stage call on a tick where it holds no microbatch
(the schedule's bubble): the JAX package computes those ticks on zeros
and discards them, so the outputs are equal either way. The stage calls
run inside `parallel/sharding.py::manual_region()`, as the JAX
package's run inside its manual `shard_map` region. Gradients come from
autograd through the ticks: a hop of the in-process ring is the
identity to autograd.

Under `dp` > 1 each microbatch's batch dim is split over the dp ring
when dp divides it, as the JAX package manualizes `data_axis`: every
(pp, dp) rank calls its stage on its own shard and the shards travel
the pp ring side by side. A stage's math that depends on how many rows
it holds sees the shard's: GPT-MoE's capacity C comes from a
microbatch's dp shard of tokens, in both packages. When dp does not
divide it the microbatch stays whole, as there.

The schedule's bubble is (S - 1) / (n_micro + S - 1), as GPipe's; on
one device it costs nothing (its ticks are skipped). The loop runs
every rank's stage in this one process, so it runs on the in-process
ring only: a process ring runs the same ticks, but one rank a process,
and ROADMAP item 20a rewrites the loop per rank for it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..observability import telemetry as _telemetry
from .sharding import manual_region

__all__ = ["pipeline_apply", "last_stream_info"]

# The last call's stream dtype. The JAX package streams f32 for a bf16
# input on CPU meshes (an XLA partitioner bug) and reports that as
# `cpu_f32_shim`; the port always streams the input's dtype.
_last_dtype: Optional[str] = None

# schedule signatures seen: (axis, S, n_micro, microbatch shape, dtype),
# the counterpart of a retrace of the JAX package's pipeline
_signatures = set()


def last_stream_info() -> Dict[str, Optional[object]]:
    """{'dtype': str|None, 'cpu_f32_shim': False} of the most recent
    `pipeline_apply` call (dtype None before any call)."""
    return {"dtype": _last_dtype, "cpu_f32_shim": False}


def _record(axis: str, S: int, x: torch.Tensor) -> None:
    """Set the gauges on every call; tick PIPELINE_TRACES only on a new
    schedule signature."""
    global _last_dtype
    n_micro = int(x.shape[0])
    sig = (axis, S, n_micro, tuple(x.shape[1:]), x.dtype)
    if sig not in _signatures:
        _signatures.add(sig)
        _telemetry.PIPELINE_TRACES.inc(axis=axis)
    _telemetry.PIPELINE_STAGES.set(S, axis=axis)
    _telemetry.PIPELINE_MICROBATCHES.set(n_micro, axis=axis)
    _telemetry.PIPELINE_BUBBLE_FRACTION.set(
        (S - 1) / max(1, n_micro + S - 1), axis=axis)
    _last_dtype = str(x.dtype).replace("torch.", "")


def _stage(stage_params, s: int):
    return {k: v[s] for k, v in stage_params.items()}


def pipeline_apply(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                   x: torch.Tensor, mesh, axis: str = "pp",
                   data_axis: str = "dp") -> torch.Tensor:
    """Run the GPipe pipeline; returns [n_micro, mb, ...] outputs.

    `stage_fn(stage_params_s, xmb) -> ymb` runs one stage on one
    microbatch; `stage_params` is a flat dict whose tensors are stacked
    [S, ...] along the stages; `x` is [n_micro, mb, ...], whose mb
    splits over `data_axis` when pp > 1 and dp divides it. pp stays in-process
    (ROADMAP items 20a and 20e)."""
    S = mesh.shape[axis]
    n_micro = x.shape[0]
    _record(axis, S, x)
    if S == 1:
        # no manual region, as the JAX package's one-stage scan
        lp = _stage(stage_params, 0)
        return torch.stack([stage_fn(lp, x[m]) for m in range(n_micro)])
    D = mesh.shape.get(data_axis, 1)
    xs = mesh.rings[data_axis].split(x, 1) \
        if D > 1 and x.shape[1] % D == 0 else [x]
    ring = mesh.rings[axis]
    local = [_stage(stage_params, s) for s in range(S)]
    # what each (dp, pp) rank received on the last hop
    state = [[None] * S for _ in xs]
    outputs = [[None] * n_micro for _ in xs]
    with manual_region():
        for t in range(n_micro + S - 1):
            ys = [[None] * S for _ in xs]
            for s in range(S):
                # rank s holds microbatch t - s on tick t
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                for d, xd in enumerate(xs):
                    ys[d][s] = stage_fn(local[s],
                                        xd[m] if s == 0 else state[d][s])
            for d in range(len(xs)):
                if ys[d][S - 1] is not None:
                    outputs[d][t - (S - 1)] = ys[d][S - 1]
            state = list(ring.hop(*ys))
    return torch.stack([torch.cat([outputs[d][m] for d in range(len(xs))])
                        for m in range(n_micro)]).to(x.dtype)
