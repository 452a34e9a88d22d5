"""The port's resilience layer against the JAX package's, on the CPU.

Each scenario of the JAX package's own fault-tolerance tests that needs
no device (tests/test_resilience.py: the fault-spec grammar, atomic
writes, retry with backoff, the checkpoint manager's commit, retention
and corrupt fallback on a numpy payload, preemption, the skip, rollback
and abort policies, the warn-anomaly budget, and `train_loop` on a fake
step) runs once through each package, and the outcomes must be equal:
the values returned, the exceptions raised, the actions, `stop`, the
losses dict and the events emitted. The JAX package's cross-world,
elastic and warmstart tests are not used as oracles: they fail on the
JAX package itself.
"""

import os
import signal
import time
import types

import numpy as np
import pytest

from paddle_tpu import resilience as jres
from paddle_tpu.observability import events as jevents
from paddle_tpu.observability import health as jhealth
from paddle_tpu.parallel import train as jtrain

from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.observability import events as tevents
from paddle_tpu_torch.observability import health as thealth
from paddle_tpu_torch.parallel import train as ttrain


def _ns(res, events, health, train):
    return types.SimpleNamespace(
        res=res, faults=res.faults, preemption=res.preemption,
        atomic=res.atomic, events=events, health=health,
        train_loop=train.train_loop)


JAX = _ns(jres, jevents, jhealth, jtrain)
PORT = _ns(tres, tevents, thealth, ttrain)
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean_resilience_state(monkeypatch):
    for var in ("PADDLE_TPU_FAULT_SPEC", "PADDLE_TPU_CHECK_NUMERICS",
                "PADDLE_TPU_PREEMPT_SIGNALS"):
        monkeypatch.delenv(var, raising=False)

    def clean():
        for ns in BOTH:
            ns.faults.reset()
            ns.preemption.uninstall()
            ns.preemption.reset()
            ns.health.reset()
            ns.events.clear()

    clean()
    yield
    clean()


def both(scenario, *args):
    """`scenario(ns, *args)` through each package, with the resilience
    state cleared between them; the two outcomes must be equal."""
    out = []
    for ns in BOTH:
        for other in BOTH:
            other.faults.reset()
            other.preemption.reset()
            other.health.reset()
            other.events.clear()
        out.append(scenario(ns, *args))
    assert out[0] == out[1], out
    return out[1]


def _raised(fn, *args, **kwargs):
    """fn's return value, or the name and message of what it raised."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - the outcome under comparison
        return (type(e).__name__, str(e))


def _events(ns, kind, *fields):
    return [tuple(e.get(f) for f in fields)
            for e in ns.events.recent(kind=kind)]


# -- fault-spec grammar ------------------------------------------------------


def test_fault_spec_grammar():
    def parse(ns):
        return [(c.site, c.step, c.action, c.p, c.seed, c.times)
                for c in ns.faults.parse_spec(
                    "step=50:crash, save:io_error:p=0.3:seed=7, "
                    "restore:error:times=2")]
    assert both(parse)[1] == ("save", None, "io_error", 0.3, 7, None)


@pytest.mark.parametrize("bad", [
    "step=50", "save:explode", "step=x:crash", "save:io_error:p=1.5",
    "save:io_error:times=0", "save:io_error:frequency=2",
])
def test_fault_spec_rejects_typos(bad):
    out = both(lambda ns: _raised(ns.faults.parse_spec, bad))
    assert out[0] == "ValueError"


def test_fault_step_trigger_and_times(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC",
                       "step=3:error, save:io_error:times=2")

    def run(ns):
        out = [_raised(ns.faults.check, "step", step=s)[0]
               for s in range(5)]
        return out + [_raised(ns.faults.check, "save")[0]
                      for _ in range(4)]
    assert both(run) == ["ok"] * 3 + ["FaultInjected", "ok"] + \
        ["InjectedIOError"] * 2 + ["ok"] * 2


@pytest.mark.parametrize("seed", [7, 8])
def test_fault_probability_schedule(monkeypatch, seed):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC",
                       f"save:io_error:p=0.4:seed={seed}")

    def schedule(ns):
        return [_raised(ns.faults.check, "save")[0] != "ok"
                for _ in range(50)]
    assert 5 < sum(both(schedule)) < 45


def test_fault_check_is_noop_when_unset():
    both(lambda ns: (ns.faults.check("step", step=0),
                     ns.faults.check("save"), ns.faults.active()))


# -- atomic writes -------------------------------------------------------------


def test_atomic_open_replaces_only_on_success(tmp_path):
    def run(ns, root):
        d = root / ns.res.__name__
        d.mkdir()
        p = str(d / "data.json")
        ns.atomic.json_dump({"v": 1}, p)

        def torn():
            with ns.atomic.atomic_open(p, "w") as f:
                f.write('{"v": 2')
                raise RuntimeError("die mid-write")
        return (_raised(torn), open(p).read(), os.listdir(d))
    assert both(run, tmp_path)[1:] == ('{"v": 1}', ["data.json"])


# -- retry with capped exponential backoff -------------------------------------


def test_retry_io_backs_off_then_succeeds():
    def run(ns):
        calls, sleeps = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"
        got = ns.res.retry_io(flaky, attempts=4, base_delay_s=0.1,
                              max_delay_s=0.15, sleep=sleeps.append)
        return got, len(calls), sleeps
    assert both(run) == ("ok", 3, [0.1, 0.15])


def test_retry_io_exhausts_and_only_retries_named_exceptions():
    def run(ns):
        sleeps, calls = [], []

        def persistent():
            raise OSError("persistent")

        def bug():
            calls.append(1)
            raise ValueError("not transient")
        return (_raised(ns.res.retry_io, persistent, attempts=3,
                        base_delay_s=0.01, sleep=sleeps.append), sleeps,
                _raised(ns.res.retry_io, bug, attempts=5,
                        sleep=lambda s: None), len(calls))
    out = both(run)
    assert out[0][0] == "OSError" and len(out[1]) == 2 and out[3] == 1


# -- CheckpointManager on a numpy payload --------------------------------------


class _NpState:
    def __init__(self, step, w):
        self.step = step
        self.w = np.asarray(w)
        self.opt_state = None


def _np_manager(ns, root, **kw):
    def save(path, state):
        os.makedirs(path, exist_ok=True)
        ns.atomic.np_save(os.path.join(path, "w"), state.w)

    def restore(path, template):
        w = np.load(os.path.join(path, "w.npy"))
        return _NpState(int(os.path.basename(path).split("_")[1]), w)

    kw.setdefault("retry_base_s", 0.001)
    kw.setdefault("retry_max_s", 0.002)
    return ns.res.CheckpointManager(str(root / ns.res.__name__),
                                    save_fn=save, restore_fn=restore, **kw)


def _corrupt(mgr, step):
    with open(os.path.join(mgr.step_dir(step), "w.npy"), "wb") as f:  # atomic-exempt: deliberate corruption
        f.write(b"xx")


def test_manager_commit_marker_and_retention(tmp_path):
    def run(ns):
        mgr = _np_manager(ns, tmp_path, keep_last_n=2, keep_every_k_steps=4)
        for s in range(1, 9):
            mgr.save(_NpState(s, [float(s)]))
        refused = _raised(mgr.save, _NpState(8, [0.0]))[0]
        return (mgr.committed_steps(), refused,
                _events(ns, "checkpoint", "site", "step", "pruned"))
    assert both(run)[:2] == ([4, 7, 8], "FileExistsError")


def test_manager_prune_clears_stale_uncommitted_dirs(tmp_path):
    def run(ns):
        mgr = _np_manager(ns, tmp_path, keep_last_n=2)
        mgr.save(_NpState(1, [1.0]))
        os.makedirs(mgr.step_dir(2))
        ns.atomic.np_save(os.path.join(mgr.step_dir(2), "w"), np.zeros(1))
        mgr.save(_NpState(3, [3.0]))
        return os.path.isdir(mgr.step_dir(2)), mgr.committed_steps()
    assert both(run) == (False, [1, 3])


def test_manager_restore_skips_uncommitted_and_corrupt(tmp_path):
    def run(ns):
        mgr = _np_manager(ns, tmp_path, keep_last_n=3)
        for s in (2, 4, 6):
            mgr.save(_NpState(s, [float(s)]))
        _corrupt(mgr, 6)
        os.makedirs(mgr.step_dir(8))
        ns.events.clear()
        st = mgr.restore_latest(_NpState(0, [0.0]))
        return (st.step, float(st.w[0]),
                _events(ns, "restore", "step", "ok", "reason"))
    out = both(run)
    assert out[:2] == (4, 4.0)
    assert out[2] == [(8, False, "uncommitted"), (6, False, "corrupt"),
                      (4, True, None)]


def test_manager_fallback_demotes_corrupt_dir_so_save_can_reuse_step(
        tmp_path):
    def run(ns):
        mgr = _np_manager(ns, tmp_path, keep_last_n=3)
        for s in (2, 4):
            mgr.save(_NpState(s, [float(s)]))
        _corrupt(mgr, 4)
        first = mgr.restore_latest(_NpState(0, [0.0])).step
        committed = mgr.committed_steps()
        mgr.save(_NpState(4, [4.5]))
        st = mgr.restore_latest(_NpState(0, [0.0]))
        return first, committed, st.step, float(st.w[0])
    assert both(run) == (2, [2], 4, 4.5)


def test_manager_restore_none_vs_all_corrupt(tmp_path):
    def run(ns):
        mgr = _np_manager(ns, tmp_path)
        empty = mgr.restore_latest(_NpState(0, [0.0]))
        mgr.save(_NpState(1, [1.0]))
        _corrupt(mgr, 1)
        return empty, _raised(mgr.restore_latest, _NpState(0, [0.0]))[0]
    assert both(run) == (None, "CheckpointError")


def test_manager_save_retries_injected_io_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "save:io_error:times=2")

    def run(ns):
        before = ns.faults.INJECTED.value(site="save", action="io_error")
        mgr = _np_manager(ns, tmp_path, retry_attempts=3)
        mgr.save(_NpState(5, [5.0]))
        return (mgr.committed_steps(),
                ns.faults.INJECTED.value(site="save", action="io_error")
                - before)
    assert both(run) == ([5], 2)


def test_manager_save_exhausted_retries_leave_no_commit(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "save:io_error")

    def run(ns):
        mgr = _np_manager(ns, tmp_path, retry_attempts=2)
        return (_raised(mgr.save, _NpState(1, [1.0]))[0],
                mgr.committed_steps())
    assert both(run) == ("InjectedIOError", [])


# -- preemption ----------------------------------------------------------------


def test_preempt_and_crash_exit_codes_are_the_jax_packages():
    assert (tres.PREEMPT_EXIT_CODE, tres.CRASH_EXIT_CODE) == \
        (jres.PREEMPT_EXIT_CODE, jres.CRASH_EXIT_CODE) == (75, 70)
    assert tres.faults.SPEC_ENV == jres.faults.SPEC_ENV
    assert tres.preemption.SIGNALS_ENV == jres.preemption.SIGNALS_ENV


def test_preemption_signal_sets_stop_flag():
    def run(ns):
        before = ns.preemption.stop_requested()
        installed = ns.preemption.install(["USR1"])
        try:
            os.kill(os.getpid(), signal.SIGUSR1)
            deadline = time.time() + 5
            while not ns.preemption.stop_requested() and \
                    time.time() < deadline:
                time.sleep(0.01)
            return (before, installed, ns.preemption.stop_requested(),
                    ns.preemption.stop_reason(),
                    _events(ns, "preempt", "reason"))
        finally:
            ns.preemption.uninstall()
    assert both(run) == (False, True, True, "signal:SIGUSR1",
                         [("signal:SIGUSR1",)])


def test_preemption_env_gating(monkeypatch):
    def run(ns):
        unset = ns.preemption.maybe_install_from_env()
        monkeypatch.setenv("PADDLE_TPU_PREEMPT_SIGNALS", "USR2")
        installed = ns.preemption.maybe_install_from_env()
        ns.preemption.uninstall()
        monkeypatch.setenv("PADDLE_TPU_PREEMPT_SIGNALS", "NOSUCHSIG")
        bad = _raised(ns.preemption.maybe_install_from_env)
        monkeypatch.delenv("PADDLE_TPU_PREEMPT_SIGNALS")
        return unset, installed, bad
    assert both(run)[:2] == (False, True)


def test_request_stop_first_reason_wins():
    def run(ns):
        ns.preemption.request_stop("first")
        ns.preemption.request_stop("second")
        return ns.preemption.stop_reason(), _events(ns, "preempt", "reason")
    assert both(run) == ("first", [("first",)])


# -- recovery policies ---------------------------------------------------------


def test_policy_validation():
    def run(ns):
        return (_raised(ns.res.RecoveryPolicy, on_numerics="retry_harder"),
                _raised(ns.res.RecoveryPolicy, lr_backoff=0.0),
                _raised(ns.res.RecoveryController,
                        ns.res.RecoveryPolicy(on_numerics="rollback")))
    assert [o[0] for o in both(run)] == ["ValueError"] * 3


def test_skip_batch_budget_then_escalate():
    def run(ns):
        ctl = ns.res.RecoveryController(ns.res.RecoveryPolicy(
            on_numerics="skip_batch", max_skips=2))
        st = _NpState(3, [1.0])
        boom = RuntimeError("nan")
        out = [ctl.handle(boom, st, step=s)[0] for s in (3, 4)]
        out.append(_raised(ctl.handle, boom, st, step=5))
        return out, _events(ns, "recovery", "action", "step", "skips")
    out = both(run)
    assert out[0] == ["skip_batch", "skip_batch", ("RuntimeError", "nan")]
    assert [a for a, _, _ in out[1]] == ["skip_batch", "skip_batch", "abort"]


def test_scale_learning_rate_scales_every_param_group():
    """The JAX package scales an `inject_hyperparams` learning_rate; the
    port scales each param group's lr of a torch optimizer in place:
    the same factor on the same value, and found=False without one."""
    import collections

    import torch

    Inject = collections.namedtuple("Inject", ["count", "hyperparams",
                                               "inner_state"])
    jout, jfound = jres.scale_learning_rate(
        (Inject(0, {"learning_rate": 0.1}, ()),), 0.5)
    w = [torch.zeros(2, requires_grad=True),
         torch.zeros(3, requires_grad=True)]
    opt = torch.optim.SGD([{"params": [w[0]]},
                           {"params": [w[1]], "lr": 0.4}], lr=0.1,
                          momentum=0.9)
    topt, tfound = tres.scale_learning_rate(opt, 0.5)
    assert topt is opt and jfound and tfound
    assert [g["lr"] for g in opt.param_groups] == \
        [jout[0].hyperparams["learning_rate"], 0.2]
    assert opt.param_groups[0]["momentum"] == 0.9
    assert jres.scale_learning_rate((np.zeros(2), {"a": 1}), 0.5)[1] is \
        tres.scale_learning_rate(object(), 0.5)[1] is False


def test_rollback_restores_and_backs_off_lr(tmp_path):
    import collections

    Inject = collections.namedtuple("Inject", ["count", "hyperparams",
                                               "inner_state"])

    def lr_state(ns, lr):
        if ns is JAX:
            return Inject(0, {"learning_rate": lr}, ())
        return types.SimpleNamespace(param_groups=[{"lr": lr}])

    def lr_of(ns, opt):
        if ns is JAX:
            return opt.hyperparams["learning_rate"]
        return opt.param_groups[0]["lr"]

    def run(ns):
        mgr = _np_manager(ns, tmp_path)
        restore = mgr._restore_fn

        def restore_with_lr(path, template):
            st = restore(path, template)
            st.opt_state = lr_state(ns, 0.8)
            return st
        mgr._restore_fn = restore_with_lr
        mgr.save(_NpState(2, [2.0]))
        ctl = ns.res.RecoveryController(ns.res.RecoveryPolicy(
            on_numerics="rollback", max_rollbacks=1, lr_backoff=0.25),
            manager=mgr)
        action, st = ctl.handle(RuntimeError("nan"), _NpState(5, [0.0]),
                                step=5)
        again = _raised(ctl.handle, None, _NpState(7, [0.0]), step=7)
        return (action, st.step, lr_of(ns, st.opt_state), again,
                _events(ns, "recovery", "action", "restored_step",
                        "lr_backoff", "step"))
    out = both(run)
    assert out[:3] == ("rollback", 2, pytest.approx(0.2))
    assert out[3][0] == "RecoveryAbort"


def test_warn_anomaly_budget_trips_controller():
    def run(ns):
        ctl = ns.res.RecoveryController(ns.res.RecoveryPolicy(
            on_numerics="skip_batch", anomaly_budget=2)).attach()
        try:
            bad = np.array([np.nan], np.float32)
            acts = []
            for _ in range(3):
                ns.health.check_numerics("trainer_loss", [("loss", bad)],
                                         level=1)
                acts.append(ctl.should_act())
            action, _ = ctl.handle(None, _NpState(1, [1.0]), step=1)
            return (acts, action, ctl.skips, ctl.should_act(),
                    ns.health.status()["anomalies"])
        finally:
            ctl.detach()
    assert both(run) == ([False, False, True], "continue", 0, False, 3)


# -- train_loop on a fake step ---------------------------------------------------


class _FakeState:
    def __init__(self, step):
        self.step = step
        self.opt_state = None


def _fake_step(state, batch, rng):
    return _FakeState(state.step + 1), 0.5


def _recording_manager(ns, root):
    saved = []
    mgr = ns.res.CheckpointManager(
        str(root / ns.res.__name__),
        save_fn=lambda p, s: saved.append(int(s.step)) or
        os.makedirs(p, exist_ok=True),
        restore_fn=lambda p, t: None)
    return mgr, saved


def _summary(ns):
    return [(e["steps"], e["stop"], e["final_step"])
            for e in ns.events.recent(kind="step_summary")]


@pytest.mark.parametrize("fetch_window", [None, 1, 3])
def test_train_loop_periodic_saves_and_completion(tmp_path, fetch_window):
    def run(ns):
        mgr, saved = _recording_manager(ns, tmp_path / str(fetch_window))
        state, losses, stop = ns.train_loop(
            _fake_step, _FakeState(0), [{} for _ in range(5)],
            manager=mgr, save_every=2, fetch_window=fetch_window)
        return stop, state.step, saved, losses, _summary(ns)
    assert both(run)[:4] == ("completed", 5, [2, 4],
                             {i: 0.5 for i in range(5)})


def test_train_loop_preempt_writes_final_checkpoint(tmp_path):
    def run(ns):
        mgr, saved = _recording_manager(ns, tmp_path)

        def step_then_preempt(state, batch, rng):
            if state.step == 2:
                ns.preemption.request_stop("test")
            return _fake_step(state, batch, rng)
        state, losses, stop = ns.train_loop(
            step_then_preempt, _FakeState(0), [{} for _ in range(10)],
            manager=mgr)
        return stop, state.step, saved, sorted(losses), _summary(ns)
    assert both(run)[:4] == ("preempted", 3, [3], [0, 1, 2])


def test_train_loop_fault_preempt_action(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "step=2:preempt")

    def run(ns):
        state, losses, stop = ns.train_loop(
            _fake_step, _FakeState(0), [{} for _ in range(10)])
        return stop, state.step, losses, _events(ns, "fault", "action",
                                                 "step")
    assert both(run)[:2] == ("preempted", 2)


def test_train_loop_max_steps_and_batch_fn():
    def run(ns):
        seen = []

        def batch_fn(step):
            seen.append(step)
            return None if step >= 6 else {}
        out = ns.train_loop(_fake_step, _FakeState(1), batch_fn,
                            max_steps=3)
        rest = ns.train_loop(_fake_step, out[0], batch_fn)
        return out[1:], rest[0].step, rest[1:], seen
    assert both(run)[1] == 6


def test_train_loop_numerics_skip_policy(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "2")

    def nan_at_2(state, batch, rng):
        return _FakeState(state.step + 1), \
            (float("nan") if state.step == 2 else 0.5)

    def run(ns):
        unhandled = _raised(ns.train_loop, nan_at_2, _FakeState(0),
                            [{} for _ in range(5)])[0]
        ctl = ns.res.RecoveryController(
            ns.res.RecoveryPolicy(on_numerics="skip_batch"))
        state, losses, stop = ns.train_loop(
            nan_at_2, _FakeState(0), [{} for _ in range(5)],
            controller=ctl)
        return (unhandled, stop, state.step, sorted(losses),
                _events(ns, "recovery", "action", "step"))
    assert both(run)[:4] == ("NumericsError", "completed", 5, [0, 1, 3, 4])


def test_train_loop_routes_ps_unavailable_to_the_controller():
    from paddle_tpu.ps import errors as jps
    from paddle_tpu_torch.ps import errors as tps

    def run(ns):
        err = (jps if ns is JAX else tps).PSUnavailableError

        def ps_down_at_1(state, batch, rng):
            if state.step == 1:
                raise err("server 0 unreachable", endpoint="ps0",
                          op="pull")
            return _fake_step(state, batch, rng)
        unhandled = _raised(ns.train_loop, ps_down_at_1, _FakeState(0),
                            [{} for _ in range(3)])
        ctl = ns.res.RecoveryController(
            ns.res.RecoveryPolicy(on_numerics="skip_batch"))
        state, losses, stop = ns.train_loop(
            ps_down_at_1, _FakeState(0), [{} for _ in range(3)],
            controller=ctl)
        return unhandled, stop, state.step, losses, ctl.skips
    assert both(run) == (("PSUnavailableError", "server 0 unreachable"),
                         "completed", 1, {0: 0.5}, 2)


def test_train_loop_resize_check_needs_periodic_saves(tmp_path):
    def run(ns):
        refused = _raised(ns.train_loop, _fake_step, _FakeState(0), [{}],
                          resize_check=lambda: True)[0]
        mgr, saved = _recording_manager(ns, tmp_path)
        state, losses, stop = ns.train_loop(
            _fake_step, _FakeState(0), [{} for _ in range(6)],
            manager=mgr, save_every=2, resize_check=lambda: True)
        return refused, stop, state.step, saved
    assert both(run) == ("ValueError", "resize", 2, [2])
