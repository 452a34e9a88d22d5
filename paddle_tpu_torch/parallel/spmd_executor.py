"""SPMD (per-rank graph) program execution: the collective-transpiler
runtime, the JAX package's `parallel/spmd_executor.py` on an in-process
dp ring.

Reference execution model: transpiler/collective.py rewrites the
single-device program with explicit c_allreduce ops, then each process
runs its own graph and the collectives synchronize (multi-process NCCL2
mode, SURVEY §2.5).

The JAX package runs the program under `shard_map` with the dp axis
manual. The port runs one copy of the program per rank of the mesh's
ring, in lockstep (`core/lockstep.py`, SPMD mode): each rank on its
dim-0 shard of every feed, persistable state replicated, and the
program's explicit `c_*` ops (`ops/collective.py`) reducing over the
ring, inside a `cond` branch too (LocalSGD's every-k average). As
there:

- each rank's rng stream is folded from the step's state and its rank
  (`mix_seed`, the port's `fold_in`), and the global state advances
  the same on every rank;
- a scalar fetch (declared shape (), [1] or unknown) is averaged over
  the ranks in f32 and cast back (`reduce="first"`: rank 0's); any
  other fetch comes back joined along dim 0;
- a written var whose ranks diverged (LocalSGD between its averages)
  keeps every rank's value for the next step while the scope holds
  rank 0's, as a JAX array keeps each device's buffer (its host read is
  device 0's). A value the caller sets in the scope replaces them all;
- telemetry: `record_spmd_step(axis, wall, collectives)` with the
  program's static `c_*` census, and a perfwatch "spmd" step sample.
  The port has no cost analysis, so its FLOPs are None, and the ranks
  share one device, so no collective crosses a link (the estimate is
  0).

The mesh is the port's `make_mesh(MeshConfig(dp=S), devices=[dev] * S)`.
Only the runner's axis may be larger than 1; a process ring raises
(ROADMAP item 20a).
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from ..core import lowering
from ..core import precision as _precision
from ..core.executor import (RNG_STATE_VAR, Scope, _as_fetch_name,
                             _finish_fetches, _health_scan,
                             _normalize_feed, _on_device, _split_rng,
                             global_scope)
from ..core.framework import Program
from ..core.registry import mix_seed
from ..observability import health as _health
from ..observability import perfwatch as _perfwatch
from ..observability import telemetry as _telemetry
from ..observability import tracing as _tracing
from ..core.lockstep import SPMD, RankStep
from ..core.ring import InProcessRing


def _indexed(device) -> torch.device:
    """`device` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


class SPMDRunner:
    """Run a (collective-transpiled) Program over the ranks of the
    mesh's `axis` ring (module docstring)."""

    def __init__(self, program: Program, mesh, axis: str = "dp",
                 reduce: str = "mean"):
        self.program = program
        self.axis = axis
        self.reduce = reduce
        self._cache: Dict[Any, RankStep] = {}
        # scope -> {var: (the value in the scope, every rank's value)}
        self._ranked: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._set_mesh(mesh)

    def _set_mesh(self, mesh):
        axis_size = mesh.shape.get(self.axis)
        if not axis_size:
            raise ValueError(f"mesh has no axis '{self.axis}'")
        wide = [a for a, s in mesh.shape.items() if s > 1 and a != self.axis]
        if wide:
            raise NotImplementedError(
                f"SPMDRunner splits the '{self.axis}' axis alone; the "
                f"mesh's axes {wide} are larger than 1")
        ring = mesh.rings.get(self.axis, InProcessRing(axis_size))
        if not isinstance(ring, InProcessRing):
            raise NotImplementedError(
                "SPMDRunner over a process ring is not ported (ROADMAP "
                "item 20a); it runs the in-process ring of "
                "make_mesh(config, devices=[device] * S)")
        self.mesh, self.ring = mesh, ring
        self.device = _indexed(mesh.devices[0])

    def resize(self, mesh) -> "SPMDRunner":
        """Point the runner at a re-formed mesh (elastic scale-in/out):
        a new mesh drops the prepared steps and the ranks' values."""
        if mesh is not self.mesh:
            self._set_mesh(mesh)
            self._cache.clear()
            self._ranked.clear()
        return self

    def run(self, executor, feed=None, fetch_list=None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            sync: bool = True):
        # the timer covers feed normalization, the cache lookup and the
        # step, matching Executor.run's span
        t0 = time.perf_counter()
        host0 = _telemetry.HOST_BLOCKED_SECONDS.total()
        program = self.program
        scope = scope if scope is not None else global_scope()
        feed = dict(feed or {})
        fetch_names = tuple(_as_fetch_name(f) for f in (fetch_list or []))
        if _indexed(executor.device) != self.device:
            raise ValueError(f"the executor runs on {executor.device}, the "
                             f"mesh's ranks on {self.device}")

        policy = _precision.resolve(program)
        norm_feed = _normalize_feed(program, feed, policy, self.device)
        sig = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                           for k, v in norm_feed.items()))
        key = (program._version, sig, fetch_names, policy.name)
        step = self._cache.get(key)
        if step is None:
            step = self._build(tuple(norm_feed), fetch_names, policy)
            self._cache[key] = step

        rng = executor._get_rng(scope, program)
        with _tracing.step_span("spmd.step", cat="step", axis=self.axis):
            fetches, new_rng = self._step(step, scope, norm_feed, rng)
        scope.set_var(RNG_STATE_VAR, new_rng)
        level = _health.check_level()
        if level:
            # a NaN produced on any rank reaches the reduced or joined
            # fetch, so this one scan attributes it to the fetched var
            _health_scan("spmd_fetch", zip(fetch_names, fetches), level)
        out = _finish_fetches(fetches, return_numpy, sync)
        wall = time.perf_counter() - t0
        _telemetry.record_spmd_step(self.axis, wall, step.collective_counts)
        host = max(0.0, _telemetry.HOST_BLOCKED_SECONDS.total() - host0)
        n_dev = len(set(self.mesh.devices))
        coll = _perfwatch.estimate_collective_seconds(
            step.device_kind, n_dev, step.payload_bytes,
            sum(step.collective_counts.values()))
        _perfwatch.record_step(
            "spmd", wall, flops=None, host_blocked=min(host, wall),
            collective_seconds=coll, device_kind=step.device_kind,
            n_devices=n_dev)
        return out

    def _build(self, feed_names: Tuple[str, ...],
               fetch_names: Tuple[str, ...], policy) -> RankStep:
        t0 = time.perf_counter()
        desc = self.program.desc
        step = RankStep(self.program, feed_names, fetch_names, policy,
                        self.ring, SPMD, axis=self.axis)

        # scalar fetches (loss-like) average over the ranks; batched
        # ones join the ranks' rows (reference: FetchOpHandle merges the
        # per-device results)
        def _is_scalar_fetch(n):
            vd = next((b.vars[n] for b in desc.blocks if n in b.vars), None)
            shp = vd.shape if vd is not None else None
            return shp is None or len(shp) == 0 or \
                (len(shp) == 1 and shp[0] == 1)

        step.scalar_fetch = {n: _is_scalar_fetch(n) for n in fetch_names}
        # the static per-program census of the c_* ops the transpiler
        # inserted, charged to the registry once per executed step
        counts: Dict[str, int] = {}
        for b in desc.blocks:
            for op in b.ops:
                if op.type.startswith("c_"):
                    counts[op.type] = counts.get(op.type, 0) + 1
        step.collective_counts = counts
        step.payload_bytes = 0
        step.device_kind = _device_kind(self.device)
        _telemetry.record_compile(
            "spmd", time.perf_counter() - t0,
            meta={"axis": self.axis, "devices": self.ring.size,
                  "device_kind": step.device_kind})
        return step

    def _rank_values(self, scope, name):
        v = scope.find_var(name)
        if v is None:
            raise RuntimeError(f"variable '{name}' missing from scope — run "
                               f"the startup program first")
        held = self._ranked.get(scope, {}).get(name)
        if held is not None and held[0] is v:
            return held[1]
        return [_on_device(v, self.device)] * self.ring.size

    def _step(self, step: RankStep, scope, feed, rng):
        S = self.ring.size
        shards = step.split_feeds(feed, f"devices on axis '{self.axis}'")
        reads = {n: self._rank_values(scope, n)
                 for n in step.const_reads + step.mut_reads}
        # the allreduce payload is about the updated state: what the
        # collective-time estimate is grounded on
        step.payload_bytes = sum(int(vals[0].nbytes) for n, vals in
                                 reads.items() if n in step.mut_reads)
        envs = [{n: vals[r] for n, vals in reads.items()} for r in range(S)]
        for env, shard in zip(envs, shards):
            env.update(shard)
        # each rank's stream: fold_in(state, rank), then its split
        seeds = [_split_rng(mix_seed(rng, r))[0] for r in range(S)]
        envs, _ = step.run_ranks(envs, seeds, self.device)

        fetches = []
        for n in step.fetch_names:
            if n not in envs[0]:
                raise lowering.LoweringError(
                    f"fetch var '{n}' was not produced by the program")
            vals = [env[n] for env in envs]
            if not step.scalar_fetch[n]:
                fetches.append(self.ring.join(vals, 0))
            elif self.reduce == "mean":
                total = self.ring.all_reduce([v.to(torch.float32)
                                              for v in vals])[0]
                fetches.append((total / S).to(vals[0].dtype))
            else:
                fetches.append(vals[0])
        ranked = self._ranked.setdefault(scope, {})
        for n in step.writes:
            if n not in envs[0]:
                continue
            vals = [env[n] for env in envs]
            scope.set_var(n, vals[0])
            if all(v is vals[0] for v in vals):
                ranked.pop(n, None)
            else:
                ranked[n] = (vals[0], vals)
        return fetches, _split_rng(rng)[1]
