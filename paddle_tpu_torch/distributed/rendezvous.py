# Copied from the JAX package: paddle_tpu/distributed/rendezvous.py
# (stdlib only), unchanged; keep it in step with its source.
"""Elastic membership: file-store rendezvous with generations and
heartbeats.

The reference's fleet/collective layer (SURVEY §1 layer 5 — NCCL gangs,
transpiler-era parameter servers) assumes the worker set is fixed for
the lifetime of a job; any membership change means a cold restart of
every rank. On preemptible TPU slices workers come and go constantly,
so membership here is a first-class, *versioned* object: a
**generation** is a sealed, immutable list of live workers, and a
world-size change is just the next generation — survivors plus joiners
re-form at a checkpoint boundary instead of the whole gang respawning
(ROADMAP item 3; torchrun-elastic is the closest prior art, rebuilt on
a plain shared directory because the TPU fleet already shares one for
checkpoints).

Store layout (all writes crash-safe via resilience/atomic; the seal is
an `os.link` exclusive publish so a generation file is always complete
and written exactly once):

    <root>/members/<worker_id>.json      join intent + heartbeat ts
    <root>/generations/gen_<N>.json      sealed membership for gen N
    <root>/CURRENT                       latest sealed generation number

Protocol:

  * **join/heartbeat** — a worker registers a member file and refreshes
    its `heartbeat_ts` (explicitly or via `start_heartbeat()`'s
    background thread). A member whose heartbeat is older than
    `dead_after_s` is *dead*: sealing prunes its file and counts it in
    `paddle_tpu_elastic_lost_workers_total`.
  * **seal** — any participant may propose generation `current+1` once
    the live set has ≥ `min_workers` and has been stable for
    `settle_s` (so a join storm lands in one generation, not one per
    arrival). First `os.link` wins; losers adopt the winner's file.
    Ranks are the index into the sorted member list — deterministic
    across all participants with no extra round.
  * **re-rendezvous** — `membership_changed(info)` compares the live
    set against a sealed generation; the training driver checks it at
    checkpoint boundaries and calls `rendezvous()` again on change.
    The wait loop backs off with a capped exponential sleep and gives
    up with `RendezvousTimeout` after `timeout_s` (the refusal path:
    a partition that never reaches `min_workers` must surface as an
    error, not a silent hang).
  * **join barrier** — sealing is not joining: `rendezvous()` returns
    only after EVERY member of the generation has acked it
    (`acks/gen_N/<worker>.json`). Without the barrier a joiner would
    seal gen N+1 and start training from the last checkpoint while
    the survivors keep training gen N until their next boundary —
    double-consuming the joiner's data slices and diverging the
    trajectories. With it, the joiner blocks until the survivors hit
    their boundary, re-rendezvous, and ack — which is also when the
    boundary checkpoint the joiner should restore exists. `timeout_s`
    must therefore exceed the checkpoint interval for joiners.
    Liveness-stub members that heartbeat but never train
    (chaos-bench members) ack from the heartbeat thread via
    `start_heartbeat(auto_ack=True)`; real training workers must NOT
    auto-ack, or the barrier guarantee is void. A member dying
    mid-barrier un-blocks the waiters (they re-rendezvous without
    it) rather than holding them to the timeout.

This store is file-based: multi-host deployments point `root` at the
job's shared filesystem (the checkpoint root's natural sibling). A
TCP-store backend would slot behind the same API; it is deliberately
not built until a deployment exists that has no shared directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import List, Optional, Tuple

from ..observability import events as _events
from ..observability import metrics as _m
from ..resilience.atomic import json_dump as _atomic_json_dump
from ..resilience.atomic import write_text as _atomic_write_text

__all__ = ["FileRendezvous", "RendezvousInfo", "RendezvousError",
           "RendezvousTimeout", "RDZV_DIR_ENV"]

RDZV_DIR_ENV = "PADDLE_TPU_RDZV_DIR"

WORLD_SIZE = _m.gauge(
    "paddle_tpu_elastic_world_size",
    "World size of the most recently sealed rendezvous generation")
GENERATION = _m.gauge(
    "paddle_tpu_elastic_generation",
    "Most recently sealed rendezvous generation number")
RENDEZVOUS_SECONDS = _m.histogram(
    "paddle_tpu_elastic_rendezvous_seconds",
    "Wall seconds spent in rendezvous() until a generation including "
    "this worker was sealed/adopted")
RENDEZVOUS_TOTAL = _m.counter(
    "paddle_tpu_elastic_rendezvous_total",
    "rendezvous() outcomes", labelnames=("outcome",))  # ok | timeout
LOST_WORKERS = _m.counter(
    "paddle_tpu_elastic_lost_workers_total",
    "Members pruned for a stale heartbeat while sealing a generation")
RESHARD_SECONDS = _m.histogram(
    "paddle_tpu_elastic_resharding_seconds",
    "Wall seconds per cross-world-size TrainState reshard "
    "(checkpoint restore onto a different mesh, or in-process "
    "device_put reshard)")
RESIZES = _m.counter(
    "paddle_tpu_elastic_resizes_total",
    "Mesh re-formations driven by a membership change",
    labelnames=("direction",))  # in | out | same


class RendezvousError(RuntimeError):
    """Rendezvous store protocol failure."""


class RendezvousTimeout(RendezvousError):
    """rendezvous() gave up: no sealable generation including this
    worker appeared within timeout_s (e.g. the live set never reached
    min_workers — a partitioned fleet must fail loudly, not hang)."""


@dataclasses.dataclass(frozen=True)
class RendezvousInfo:
    """One sealed generation, as seen by one worker."""

    generation: int
    rank: int
    world_size: int
    members: Tuple[str, ...]


class FileRendezvous:
    """File-store rendezvous — see module docstring for the protocol."""

    def __init__(self, root: str, worker_id: Optional[str] = None, *,
                 min_workers: int = 1, max_workers: Optional[int] = None,
                 heartbeat_s: float = 0.5, dead_after_s: float = 2.5,
                 settle_s: float = 0.2, timeout_s: float = 60.0,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 1.0):
        if min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if max_workers is not None and max_workers < min_workers:
            raise ValueError("max_workers must be >= min_workers")
        if dead_after_s <= heartbeat_s:
            raise ValueError(
                "dead_after_s must exceed heartbeat_s — otherwise every "
                "healthy member flaps dead between its own heartbeats")
        self.root = os.path.abspath(root)
        self.worker_id = worker_id if worker_id is not None \
            else f"worker-{os.getpid()}"
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.heartbeat_s = heartbeat_s
        self.dead_after_s = dead_after_s
        self.settle_s = settle_s
        self.timeout_s = timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        os.makedirs(self._members_dir, exist_ok=True)
        os.makedirs(self._gens_dir, exist_ok=True)

    @classmethod
    def from_env(cls, **overrides) -> "FileRendezvous":
        """Build from the launcher's env contract: PADDLE_TPU_RDZV_DIR
        (store root), PADDLE_TRAINER_ID (worker id), and
        PADDLE_TPU_MIN_WORKERS."""
        root = os.environ.get(RDZV_DIR_ENV)
        if not root:
            raise RendezvousError(
                f"{RDZV_DIR_ENV} is not set — launch with --elastic or "
                f"export the store directory explicitly")
        overrides.setdefault(
            "worker_id", f"rank-{os.environ.get('PADDLE_TRAINER_ID', '0')}")
        overrides.setdefault(
            "min_workers",
            int(os.environ.get("PADDLE_TPU_MIN_WORKERS", "1")))
        return cls(root, **overrides)

    # -- store layout -------------------------------------------------------

    @property
    def _members_dir(self) -> str:
        return os.path.join(self.root, "members")

    @property
    def _gens_dir(self) -> str:
        return os.path.join(self.root, "generations")

    def _member_file(self, worker_id: str) -> str:
        return os.path.join(self._members_dir, f"{worker_id}.json")

    def _gen_file(self, gen: int) -> str:
        return os.path.join(self._gens_dir, f"gen_{int(gen)}.json")

    # -- membership ---------------------------------------------------------

    def register(self):
        """Write/refresh this worker's member file (join intent +
        heartbeat in one atomic write)."""
        _atomic_json_dump(
            {"worker_id": self.worker_id, "pid": os.getpid(),
             "heartbeat_ts": time.time()},
            self._member_file(self.worker_id))

    heartbeat = register  # a heartbeat IS a re-registration

    def start_heartbeat(self, auto_ack: bool = False):
        """Refresh the member file from a background daemon thread every
        heartbeat_s until stop_heartbeat()/leave(). `auto_ack=True`
        additionally acks any sealed generation this worker appears in —
        ONLY for liveness-stub members that never train (the join
        barrier would otherwise be satisfied by a worker that has not
        actually adopted the generation)."""
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        self._hb_stop.clear()

        def loop():
            while not self._hb_stop.wait(self.heartbeat_s):
                try:
                    self.register()
                    if auto_ack:
                        self.ack_current()
                except OSError:
                    pass  # a transiently-full disk must not kill the beat

        self._hb_thread = threading.Thread(
            target=loop, name=f"rdzv-heartbeat-{self.worker_id}",
            daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self):
        if self._hb_thread is not None:
            self._hb_stop.set()
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None

    def _read_member(self, worker_id: str) -> Optional[dict]:
        try:
            with open(self._member_file(worker_id)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _scan_members(self, now: Optional[float] = None
                      ) -> Tuple[List[str], List[str]]:
        """ONE pass over the member files: (live, dead) worker ids by
        heartbeat freshness, both sorted. The single home of the
        staleness predicate — live_members and dead-pruning must never
        disagree on who is alive."""
        now = time.time() if now is None else now
        live, dead = [], []
        try:
            names = os.listdir(self._members_dir)
        except OSError:
            return [], []
        for name in names:
            if not name.endswith(".json"):
                continue
            meta = self._read_member(name[:-len(".json")])
            if meta is None:
                continue
            fresh = (now - float(meta.get("heartbeat_ts", 0))
                     <= self.dead_after_s)
            (live if fresh else dead).append(str(meta["worker_id"]))
        return sorted(live), sorted(dead)

    def live_members(self, now: Optional[float] = None) -> List[str]:
        """Worker ids with a fresh heartbeat, sorted (= rank order of a
        generation sealed from this set)."""
        return self._scan_members(now)[0]

    def _prune_dead(self, now: float) -> int:
        """Unlink member files with stale heartbeats; returns the count
        (the lost-worker signal). Called while sealing, so a dead member
        is counted once per loss, not once per poll."""
        lost = 0
        for wid in self._scan_members(now)[1]:
            try:
                os.unlink(self._member_file(wid))
            except OSError:
                continue
            lost += 1
        if lost:
            LOST_WORKERS.inc(lost)
        return lost

    def leave(self):
        """Graceful departure: stop heartbeating and withdraw the member
        file, so the next seal excludes this worker without waiting for
        its heartbeat to go stale."""
        self.stop_heartbeat()
        try:
            os.unlink(self._member_file(self.worker_id))
        except OSError:
            pass
        _events.emit("rendezvous", action="leave",
                     worker_id=self.worker_id)

    # -- generations --------------------------------------------------------

    def current_generation(self) -> int:
        """Highest sealed generation number. Derived from the sealed
        files themselves, not the CURRENT hint: two racing sealers of
        N and N+1 may write CURRENT out of order, and a monotonicity
        bug here would let a new generation reuse an old number."""
        best = 0
        try:
            names = os.listdir(self._gens_dir)
        except OSError:
            return 0
        for name in names:
            if name.startswith("gen_") and name.endswith(".json"):
                try:
                    best = max(best, int(name[len("gen_"):-len(".json")]))
                except ValueError:
                    continue
        return best

    def _read_generation(self, gen: int) -> Optional[dict]:
        try:
            with open(self._gen_file(gen)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def current(self) -> Optional[RendezvousInfo]:
        """Latest sealed generation as seen by this worker (rank -1 if
        this worker is not a member of it)."""
        gen = self.current_generation()
        if gen <= 0:
            return None
        meta = self._read_generation(gen)
        if meta is None:
            return None
        members = tuple(meta["members"])
        rank = members.index(self.worker_id) \
            if self.worker_id in members else -1
        return RendezvousInfo(generation=int(meta["generation"]),
                              rank=rank, world_size=len(members),
                              members=members)

    def _seal(self, gen: int, members: List[str]) -> Optional[dict]:
        """Exclusive-publish gen_<N>.json: write the complete payload to
        a tmp file, then os.link it onto the final name — link is atomic
        and fails when the name exists, so exactly one COMPLETE file
        ever appears (a plain O_EXCL open could die mid-write and leave
        a torn seal every later reader chokes on)."""
        final = self._gen_file(gen)
        tmp = _atomic_json_dump(
            {"generation": gen, "members": list(members),
             "sealed_by": self.worker_id, "ts": time.time()},
            final + f".proposal.{self.worker_id}")
        try:
            os.link(tmp, final)
            won = True
        except FileExistsError:
            won = False
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        if won:
            _atomic_write_text(os.path.join(self.root, "CURRENT"), str(gen))
            # bound the ack-dir population: generations 8 behind can
            # have no waiter left inside any sane timeout
            import shutil

            for old in range(max(1, gen - 16), gen - 8):
                shutil.rmtree(self._acks_dir(old), ignore_errors=True)
        return self._read_generation(gen)

    def _capped(self, live: List[str],
                incumbents: Tuple[str, ...] = ()) -> List[str]:
        """Apply max_workers with INCUMBENT preference: members of the
        current sealed generation keep their slots; newcomers fill
        whatever remains, in sorted order. Without the preference, an
        over-quota joiner whose id sorts early would evict a healthy
        member (which then times out), and the un-capped live set would
        disagree with every sealed generation forever — making each
        checkpoint boundary a spurious full resize."""
        if self.max_workers is None or len(live) <= self.max_workers:
            return live
        keep = [w for w in live if w in incumbents]
        keep += [w for w in live if w not in incumbents]
        return sorted(keep[:self.max_workers])

    # -- the join barrier ---------------------------------------------------

    def _acks_dir(self, gen: int) -> str:
        return os.path.join(self.root, "acks", f"gen_{int(gen)}")

    def ack(self, gen: int):
        """Acknowledge generation `gen`: this worker has seen and
        adopted it. rendezvous() acks automatically before returning."""
        _atomic_json_dump({"worker_id": self.worker_id, "ts": time.time()},
                          os.path.join(self._acks_dir(gen),
                                       f"{self.worker_id}.json"))

    def ack_current(self):
        """Ack the latest sealed generation when this worker is one of
        its members (the liveness-stub member's heartbeat-side ack)."""
        info = self.current()
        if info is not None and info.rank >= 0:
            self.ack(info.generation)

    def acked(self, gen: int) -> set:
        try:
            names = os.listdir(self._acks_dir(gen))
        except OSError:
            return set()
        return {n[:-len(".json")] for n in names if n.endswith(".json")}

    def _await_adoption(self, info: RendezvousInfo,
                        deadline: float) -> bool:
        """The join barrier: block until EVERY member of `info` acked
        it. Returns False — caller re-loops into a fresh rendezvous —
        when a not-yet-acked member goes heartbeat-dead (waiting out
        the full timeout on a corpse would stall the survivors).
        Raises RendezvousTimeout at `deadline` like the outer loop."""
        self.ack(info.generation)
        backoff = self.backoff_base_s
        while True:
            missing = set(info.members) - self.acked(info.generation)
            if not missing:
                return True
            if self.current_generation() > info.generation:
                # superseded: a peer (who transiently judged someone
                # here heartbeat-stale) already sealed a NEWER
                # generation. Waiting out this one's acks would
                # cross-generation deadlock — it waits for a member
                # that is itself blocked in the old barrier — until
                # both sides burn their full timeout. Bail; the caller
                # re-loops and adopts the newer generation, whose own
                # ack barrier preserves the join guarantee.
                return False
            if missing - set(self.live_members()):
                return False  # a member died before adopting
            if time.perf_counter() > deadline:
                RENDEZVOUS_TOTAL.inc(outcome="timeout")
                _events.emit("rendezvous", action="timeout",
                             worker_id=self.worker_id,
                             generation=info.generation,
                             waiting_for=sorted(missing))
                raise RendezvousTimeout(
                    f"generation {info.generation} sealed but members "
                    f"{sorted(missing)} never adopted it within "
                    f"{self.timeout_s}s — for joiners, timeout_s must "
                    f"exceed the survivors' checkpoint interval")
            time.sleep(backoff)
            backoff = min(self.backoff_max_s, backoff * 2)
            self.register()

    def membership_changed(self, info: RendezvousInfo) -> bool:
        """True when the live set no longer matches `info`'s members —
        a worker died (stale heartbeat), left, or a new one registered.
        The elastic driver polls this at checkpoint boundaries. A
        waiting over-quota joiner (beyond max_workers) does NOT count
        as a change: it gets a slot when one frees."""
        if self.current_generation() != info.generation:
            return True
        live = self._capped(self.live_members(), info.members)
        return set(live) != set(info.members)

    # -- the barrier --------------------------------------------------------

    def rendezvous(self, reason: str = "start") -> RendezvousInfo:
        """Join/re-join the group: block (capped-backoff polling) until
        a generation that includes this worker is sealed — by us, once
        the live set is stable and >= min_workers, or by any peer.
        Emits a `rendezvous` event and ticks the elastic metrics."""
        t0 = time.perf_counter()
        deadline = t0 + self.timeout_s
        self.register()
        prev = self.current()
        prev_members = set(prev.members) if prev else set()
        last_live: Optional[List[str]] = None
        last_change = time.perf_counter()
        backoff = self.backoff_base_s
        while True:
            # adopt any sealed generation that includes us and is newer
            # than what we joined against
            info = self.current()
            if info is not None and info.rank >= 0 and (
                    prev is None or info.generation > prev.generation
                    or set(info.members) == set(self._capped(
                        self.live_members(), info.members))):
                if self._await_adoption(info, deadline):
                    seconds = time.perf_counter() - t0
                    self._record(info, reason, seconds, prev_members)
                    return info
                prev = info  # a member died mid-barrier: force a fresh
                # generation instead of re-adopting this one
                continue

            now = time.time()
            live = self._capped(self.live_members(now),
                                info.members if info else ())
            if live != last_live:
                last_live = live
                last_change = time.perf_counter()
            stable = (time.perf_counter() - last_change) >= self.settle_s
            if (self.worker_id in live and len(live) >= self.min_workers
                    and stable):
                self._prune_dead(now)
                gen = max(self.current_generation(),
                          info.generation if info else 0) + 1
                sealed = self._seal(gen, live)
                if sealed and self.worker_id in sealed["members"]:
                    members = tuple(sealed["members"])
                    out = RendezvousInfo(
                        generation=int(sealed["generation"]),
                        rank=members.index(self.worker_id),
                        world_size=len(members), members=members)
                    if self._await_adoption(out, deadline):
                        seconds = time.perf_counter() - t0
                        self._record(out, reason, seconds, prev_members)
                        return out
                    prev = out  # member died mid-barrier: reseal fresh
                    continue
                # lost the seal race to a membership not including us:
                # keep polling — our member file forces the next gen
            if time.perf_counter() > deadline:
                RENDEZVOUS_TOTAL.inc(outcome="timeout")
                _events.emit("rendezvous", action="timeout",
                             worker_id=self.worker_id, reason=reason,
                             live=live, min_workers=self.min_workers)
                raise RendezvousTimeout(
                    f"no generation including {self.worker_id!r} sealed "
                    f"within {self.timeout_s}s (live={live}, "
                    f"min_workers={self.min_workers})")
            time.sleep(backoff)
            backoff = min(self.backoff_max_s, backoff * 2)
            self.register()  # keep our own heartbeat fresh while waiting

    def _record(self, info: RendezvousInfo, reason: str, seconds: float,
                prev_members: set):
        RENDEZVOUS_TOTAL.inc(outcome="ok")
        RENDEZVOUS_SECONDS.observe(seconds)
        WORLD_SIZE.set(info.world_size)
        GENERATION.set(info.generation)
        lost = sorted(prev_members - set(info.members))
        joined = sorted(set(info.members) - prev_members)
        _events.emit("rendezvous", action="sealed",
                     generation=info.generation, rank=info.rank,
                     world_size=info.world_size,
                     members=list(info.members), reason=reason,
                     lost=lost, joined=joined,
                     seconds=round(seconds, 6))
