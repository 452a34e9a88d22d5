# Copied from the JAX package: paddle_tpu/distributed/launch_serve.py
# (stdlib only). Keep it in step with that file; its declared changes:
# a plain lock, this package's replica module, one comment line.
"""Serving-fleet replica supervisor: spawn, respawn, scale.

The fleet analogue of `launch.py --elastic` / `launch_ps.py
--ps_supervise` (their per-slot pattern, applied to serving):
every replica is one SLOT owning a fixed endpoint spec; the supervisor

  * spawns `python -m paddle_tpu_torch.serving.replica` per slot (replicas
    boot from a shared warmstart artifact, heartbeat into the shared
    rendezvous store, and print a JSON ready line),
  * respawns a CRASHED slot (rc != 0) in place with capped exponential
    backoff while the per-slot `max_respawns` budget lasts — a spent
    budget retires the slot (the fleet shrinks rather than the
    supervisor crash-looping a poisoned replica),
  * treats rc == 0 as deliberate (scale-in drain finished) and retires
    the slot quietly,
  * exposes `scale_out()` / `scale_in()` for the Autoscaler
    (serving/autoscale.py): scale-out adds a fresh slot (serving within
    seconds via the warmstart artifact), scale-in SIGTERMs the chosen
    slot and lets the replica run its leave→drain→stop sequence.

The supervisor does NOT route traffic and the router does NOT manage
processes — membership meets in the rendezvous store, so either side
can be replaced (e.g. k8s instead of this supervisor) without touching
the other.

CLI:
    python -m paddle_tpu_torch.distributed.launch_serve \
        --model_dir M --replicas 2 --rdzv_dir /shared/fleet \
        [--warmstart ART] [--cpu] [--max_respawns 3]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..observability import events as _events
from ..observability import metrics as _m

__all__ = ["ReplicaSpec", "ReplicaSupervisor", "launch_serve_main"]

RESPAWNS = _m.counter(
    "paddle_tpu_fleet_replica_respawns_total",
    "Crashed replica slots respawned by the supervisor",
    labelnames=("slot",))
SLOTS = _m.gauge(
    "paddle_tpu_fleet_slots",
    "Supervisor slots by state (live|retired)", labelnames=("state",))


class ReplicaSpec:
    """Everything needed to spawn one replica process (shared by every
    slot; the port differs per slot)."""

    def __init__(self, model_dir: str, *, host: str = "127.0.0.1",
                 warmstart: Optional[str] = None,
                 buckets: Optional[str] = None,
                 max_batch: int = 64, max_queue: int = 128,
                 max_wait_ms: float = 5.0, timeout_s: float = 30.0,
                 precision: str = "f32", cpu: bool = False,
                 drain_timeout_s: float = 30.0,
                 extra_args: Optional[List[str]] = None):
        self.model_dir = model_dir
        self.host = host
        self.warmstart = warmstart
        self.buckets = buckets
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_wait_ms = float(max_wait_ms)
        self.timeout_s = float(timeout_s)
        self.precision = precision
        self.cpu = bool(cpu)
        self.drain_timeout_s = float(drain_timeout_s)
        self.extra_args = list(extra_args or [])

    def command(self, slot_id: int, port: int,
                rdzv_dir: str) -> List[str]:
        cmd = [sys.executable, "-u", "-m", "paddle_tpu_torch.serving.replica",
               "--model-dir", self.model_dir,
               "--host", self.host, "--port", str(port),
               "--slot", str(slot_id),
               "--max-batch", str(self.max_batch),
               "--max-queue", str(self.max_queue),
               "--max-wait-ms", str(self.max_wait_ms),
               "--timeout-s", str(self.timeout_s),
               "--precision", self.precision,
               "--drain-timeout-s", str(self.drain_timeout_s)]
        if rdzv_dir:
            cmd += ["--rdzv-dir", rdzv_dir]
        if self.warmstart:
            cmd += ["--warmstart", self.warmstart]
        if self.buckets:
            cmd += ["--buckets", self.buckets]
        if self.cpu:
            cmd += ["--cpu"]
        return cmd + self.extra_args


class _Slot:
    def __init__(self, slot_id: int, port: int,
                 host: str = "127.0.0.1"):
        self.slot_id = slot_id
        self.port = port
        self.host = host        # must match ReplicaSpec.host: the
        # replica registers f"{host}:{port}" in the rendezvous, and
        # scale_in(endpoint=...) compares against what the router sees
        self.proc: Optional[subprocess.Popen] = None
        self.out = None
        self.launches = 0
        self.respawns = 0
        self.retired = False
        self.stopping = False   # we sent SIGTERM (scale-in / shutdown)
        self.respawn_due: Optional[float] = None

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ReplicaSupervisor:
    """Per-slot supervision of a serving fleet — see module docstring.
    Thread-safe: the Autoscaler calls scale_out/scale_in from its own
    thread while the monitor thread polls slot processes."""

    def __init__(self, spec: ReplicaSpec, rdzv_dir: str, *,
                 replicas: int = 1, max_respawns: int = 3,
                 backoff_s: float = 0.5, log_dir: Optional[str] = None):
        self.spec = spec
        self.rdzv_dir = rdzv_dir
        self.max_respawns = int(max_respawns)
        self.backoff_s = float(backoff_s)
        self.log_dir = log_dir
        if rdzv_dir:
            os.makedirs(rdzv_dir, exist_ok=True)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        # a plain lock: the port has no lock-order checker (the JAX
        # package's analysis.lockcheck, ROADMAP item 21)
        self._lock = threading.Lock()
        self._slots: Dict[int, _Slot] = {}
        self._next_slot = 0
        self._initial = max(0, int(replicas))
        self._mon_stop = threading.Event()
        self._mon_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self):
        """Spawn the initial replica set and the monitor thread."""
        for _ in range(self._initial):
            self.scale_out()
        with self._lock:
            if self._mon_thread is not None \
                    and self._mon_thread.is_alive():
                return
            self._mon_stop.clear()
            self._mon_thread = threading.Thread(
                target=self._monitor, name="paddle-tpu-fleet-supervisor",
                daemon=True)
            self._mon_thread.start()

    def stop(self, grace_s: Optional[float] = None):
        """Join the monitor (no respawn can race the teardown), then
        SIGTERM every live slot (graceful drain) and SIGKILL stragglers
        after `grace_s`. The default grace exceeds the replicas' drain
        budget — killing a replica mid-drain would drop exactly the
        in-flight work the drain contract promises to finish.
        Idempotent."""
        if grace_s is None:
            grace_s = max(20.0, 2 * self.spec.drain_timeout_s + 10.0) \
                if hasattr(self.spec, "drain_timeout_s") else 20.0
        self._mon_stop.set()
        with self._lock:
            t, self._mon_thread = self._mon_thread, None
        if t is not None:
            t.join(timeout=10.0)
        with self._lock:
            slots = list(self._slots.values())
            for s in slots:
                s.stopping = True
                s.retired = True
                s.respawn_due = None
        for s in slots:
            if s.proc is not None and s.proc.poll() is None:
                try:
                    s.proc.send_signal(signal.SIGTERM)
                except OSError:
                    continue
        deadline = time.time() + grace_s
        while time.time() < deadline and any(
                s.proc is not None and s.proc.poll() is None
                for s in slots):
            time.sleep(0.1)
        for s in slots:
            if s.proc is not None and s.proc.poll() is None:
                s.proc.kill()
        for s in slots:
            if s.proc is not None:
                try:
                    s.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass  # D-state child; nothing more to do
            self._close_out(s)
        self._set_gauges()

    # -- scaling -------------------------------------------------------

    def scale_out(self) -> str:
        """Add one replica slot; returns its endpoint. The process
        boots from the shared warmstart artifact (when configured), so
        it is typically serving within seconds."""
        with self._lock:
            slot = _Slot(self._next_slot, _free_port(),
                         host=getattr(self.spec, "host", "127.0.0.1"))
            self._next_slot += 1
            self._slots[slot.slot_id] = slot
        self._spawn(slot)
        _events.emit("fleet", action="scale_out", slot=slot.slot_id,
                     endpoint=slot.endpoint)
        self._set_gauges()
        return slot.endpoint

    def scale_in(self, endpoint: Optional[str] = None) -> Optional[str]:
        """Retire one replica gracefully (SIGTERM → replica leaves the
        rendezvous, drains, exits 0). Defaults to the newest live slot;
        returns the endpoint being drained (None when nothing to do)."""
        with self._lock:
            cands = [s for s in self._slots.values()
                     if not s.retired and s.proc is not None
                     and s.proc.poll() is None]
            if endpoint is not None:
                cands = [s for s in cands if s.endpoint == endpoint]
            if not cands:
                return None
            slot = max(cands, key=lambda s: s.slot_id)
            slot.stopping = True
            slot.retired = True
        try:
            slot.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass  # already gone: monitor reaps it
        _events.emit("fleet", action="scale_in", slot=slot.slot_id,
                     endpoint=slot.endpoint)
        self._set_gauges()
        return slot.endpoint

    def kill_slot(self, slot_id: int) -> Optional[str]:
        """SIGKILL one replica process (chaos hook for serve_bench
        --fleet): no drain, no leave — exactly what a hardware loss
        looks like. The monitor sees rc != 0 and respawns the slot.
        Returns the killed endpoint."""
        with self._lock:
            slot = self._slots.get(slot_id)
            if slot is None or slot.proc is None:
                return None
        try:
            slot.proc.kill()
        except OSError:
            return None
        return slot.endpoint

    # -- introspection -------------------------------------------------

    def endpoints(self, live_only: bool = True) -> List[str]:
        with self._lock:
            return sorted(
                s.endpoint for s in self._slots.values()
                if not live_only
                or (not s.retired and s.proc is not None
                    and s.proc.poll() is None))

    def replica_count(self) -> int:
        """Live (non-retired, process-up) slots — the Autoscaler's
        notion of current fleet size, including slots still booting."""
        return len(self.endpoints(live_only=True))

    def slot_info(self) -> List[Dict]:
        with self._lock:
            return [{
                "slot": s.slot_id, "endpoint": s.endpoint,
                "alive": s.proc is not None and s.proc.poll() is None,
                "retired": s.retired, "launches": s.launches,
                "respawns": s.respawns,
            } for s in sorted(self._slots.values(),
                              key=lambda s: s.slot_id)]

    # -- internals -----------------------------------------------------

    def _close_out(self, slot: _Slot):
        if slot.out is not None:
            try:
                slot.out.close()
            except OSError:
                pass
            slot.out = None

    def _spawn(self, slot: _Slot):
        self._close_out(slot)
        if self.log_dir:
            mode = "w" if slot.launches == 0 else "a"
            slot.out = open(  # atomic-exempt: live log stream
                os.path.join(self.log_dir,
                             f"replica.{slot.slot_id}.log"), mode)
        cmd = self.spec.command(slot.slot_id, slot.port, self.rdzv_dir)
        slot.proc = subprocess.Popen(cmd, stdout=slot.out,
                                     stderr=slot.out)
        slot.launches += 1

    def _monitor(self):
        while not self._mon_stop.is_set():
            now = time.time()
            with self._lock:
                slots = list(self._slots.values())
            for s in slots:
                if s.proc is None:
                    continue
                if s.respawn_due is not None:
                    if s.retired or s.stopping \
                            or self._mon_stop.is_set():
                        # stop()/scale_in raced the scheduled respawn:
                        # spawning now would launch a replica nobody
                        # supervises (or one stop() then SIGKILLs
                        # mid-boot) — cancel it
                        s.respawn_due = None
                        continue
                    if s.respawn_due <= now:
                        s.respawn_due = None
                        self._spawn(s)
                        self._set_gauges()
                    continue
                rc = s.proc.poll()
                if rc is None:
                    continue
                if rc == 0 or s.stopping:
                    # deliberate exit (drain finished / our SIGTERM)
                    if not s.retired:
                        s.retired = True
                        _events.emit("fleet", action="slot_retired",
                                     slot=s.slot_id, rc=rc)
                        self._set_gauges()
                    continue
                # crash
                if s.respawns >= self.max_respawns:
                    s.retired = True
                    _events.emit("fleet", action="respawn_exhausted",
                                 slot=s.slot_id, rc=rc,
                                 respawns=s.respawns)
                    print(f"launch_serve: slot {s.slot_id} crashed "
                          f"rc={rc}; respawn budget spent — slot "
                          f"retired", file=sys.stderr, flush=True)
                    self._set_gauges()
                    continue
                delay = min(30.0, self.backoff_s * (2 ** s.respawns))
                s.respawns += 1
                s.respawn_due = now + delay
                RESPAWNS.inc(slot=str(s.slot_id))
                _events.emit("fleet", action="respawn", slot=s.slot_id,
                             rc=rc, respawn=s.respawns,
                             max_respawns=self.max_respawns,
                             delay_s=round(delay, 3))
                print(f"launch_serve: slot {s.slot_id} (endpoint "
                      f"{s.endpoint}) crashed rc={rc}; respawn "
                      f"{s.respawns}/{self.max_respawns} in "
                      f"{delay:.1f}s", file=sys.stderr, flush=True)
            self._mon_stop.wait(0.1)

    def _set_gauges(self):
        with self._lock:
            live = sum(1 for s in self._slots.values()
                       if not s.retired and s.proc is not None
                       and s.proc.poll() is None)
            retired = sum(1 for s in self._slots.values() if s.retired)
        SLOTS.set(live, state="live")
        SLOTS.set(retired, state="retired")


def launch_serve_main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch_serve")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--rdzv_dir", required=True,
                    help="shared membership store the router watches")
    ap.add_argument("--warmstart", default="")
    ap.add_argument("--buckets", default="")
    ap.add_argument("--max_respawns", type=int, default=3)
    ap.add_argument("--backoff_s", type=float, default=0.5)
    ap.add_argument("--log_dir", default="")
    ap.add_argument("--precision", default="f32")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    spec = ReplicaSpec(args.model_dir, warmstart=args.warmstart or None,
                       buckets=args.buckets or None,
                       precision=args.precision, cpu=args.cpu)
    sup = ReplicaSupervisor(spec, args.rdzv_dir,
                            replicas=args.replicas,
                            max_respawns=args.max_respawns,
                            backoff_s=args.backoff_s,
                            log_dir=args.log_dir or None)
    sup.start()
    try:
        while True:
            time.sleep(1.0)
            if sup.replica_count() == 0:
                # every slot retired (drained or budget-exhausted)
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        sup.stop()


if __name__ == "__main__":
    sys.exit(launch_serve_main())
