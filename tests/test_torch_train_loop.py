"""The port's fault-tolerant training loop on a tiny f32 BERT, on the
CPU: `train_loop` against the JAX package's on the same params and
batches, resumes after a preemption and after a crash (a subprocess
killed by PADDLE_TPU_FAULT_SPEC) that equal the uninterrupted run,
rollback on a NaN, and TrainState checkpoints (corrupt fallback, the
dtype manifest's refusals, shape refusals, the loss scale).

Tolerances:
- against the JAX package: each loss within 1e-5 relative, as
  tests/test_torch_train.py holds an f32 BERT trajectory;
- a resumed run against the uninterrupted one, and fetch_window 1
  against 2: bit for bit (the same arithmetic in the same order from
  the same restored bits, on two threads in every process).
"""

import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import bert as jbert
from paddle_tpu.observability import events as jevents
from paddle_tpu.parallel import MeshConfig, make_mesh, mesh_guard
from paddle_tpu.parallel import train as jtrain

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core import async_exec
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.observability import events
from paddle_tpu_torch.observability import telemetry
from paddle_tpu_torch.parallel import checkpoint as tckpt
from paddle_tpu_torch.parallel import train as ttrain
from paddle_tpu_torch.resilience import (CRASH_EXIT_CODE, CheckpointManager,
                                         RecoveryController, RecoveryPolicy,
                                         faults, preemption)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The run both this process and the crashing subprocess build: BERT-tiny
# at f32 from a torch seed, AdamW, batches keyed on the global step.
_SETUP = r"""
import numpy as np
import torch

from paddle_tpu_torch.models import bert
from paddle_tpu_torch.parallel.train import TrainStrategy, make_train_step

torch.set_num_threads(2)
CFG = bert.BertConfig.tiny()
CFG.dtype = "float32"
STEPS = 6


def make(precision="f32", cfg=CFG):
    params, _ = bert.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    init, step = make_train_step(
        lambda p, b, g: bert.pretrain_loss(p, cfg, b, rng=g,
                                           deterministic=True),
        lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4),
        device="cpu", strategy=TrainStrategy(clip_global_norm=1.0),
        precision=precision)
    return params, init, step


def batch_fn(step):
    if step >= STEPS:
        return None
    return bert.make_batch(np.random.RandomState(100 + step), CFG, 4, 32,
                           device="cpu")
"""

_CHILD = _SETUP + r"""
import sys

from paddle_tpu_torch.parallel.train import train_loop
from paddle_tpu_torch.resilience import CheckpointManager

params, init, step = make()
train_loop(step, init(params), batch_fn, rng=7,
           manager=CheckpointManager(sys.argv[1], keep_last_n=2),
           save_every=2)
"""

RUN = {}
exec(_SETUP, RUN)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC", raising=False)
    monkeypatch.delenv("PADDLE_TPU_CHECK_NUMERICS", raising=False)
    faults.reset()
    preemption.reset()
    yield
    faults.reset()
    preemption.reset()


def _run(root, fetch_window=None, resume=False):
    """The run from its start, or with `resume` from the newest
    committed checkpoint under `root`, restored into a fresh template."""
    params, init, step = RUN["make"]()
    mgr = CheckpointManager(str(root), keep_last_n=2)
    state = init(params)
    if resume:
        state = mgr.restore_latest(state)
    state, losses, stop = ttrain.train_loop(
        step, state, RUN["batch_fn"], rng=7, manager=mgr, save_every=2,
        fetch_window=fetch_window)
    return state, losses, stop, mgr


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    state, losses, stop, mgr = _run(tmp_path_factory.mktemp("a"))
    assert stop == "completed" and state.step == RUN["STEPS"]
    assert mgr.committed_steps() == [4, 6]     # keep_last_n=2
    return losses, {k: v.detach().clone() for k, v in state.params.items()}


def _assert_resumed_equal(state, losses, want, first):
    want_losses, want_params = want
    assert sorted(losses) == list(range(first, RUN["STEPS"]))
    for s, v in losses.items():
        assert v == want_losses[s], (s, v, want_losses[s])
    for k, v in state.params.items():
        assert torch.equal(v, want_params[k]), k


def test_train_loop_matches_the_jax_train_loop():
    """4 steps through each package's train_loop from the same params
    and batch_fn (dropout off)."""
    jcfg, cfg = jbert.BertConfig.tiny(), RUN["CFG"]
    jcfg.dtype = "float32"
    jparams, axes = jbert.init(jax.random.key(0), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}

    def batches(step):
        if step >= 4:
            return None
        return tbert.make_batch(np.random.RandomState(100 + step), cfg, 4,
                                32, device="cpu")

    init, step = ttrain.make_train_step(
        lambda p, b, g: tbert.pretrain_loss(p, cfg, b, rng=g,
                                            deterministic=True),
        lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4),
        device="cpu", strategy=ttrain.TrainStrategy(clip_global_norm=1.0),
        precision="f32")
    state, got, stop = ttrain.train_loop(
        step, init(params_from_numpy(np_params, "cpu")), batches, rng=3)
    assert stop == "completed" and state.step == 4

    mesh = make_mesh(MeshConfig(dp=-1), devices=jax.devices()[:1])
    with mesh_guard(mesh):
        jinit, jstep = jtrain.make_train_step(
            lambda p, b, r: jbert.pretrain_loss(p, jcfg, b, rng=r,
                                                deterministic=True),
            optax.adamw(1e-3), mesh, axes,
            strategy=jtrain.TrainStrategy(clip_global_norm=1.0))

        def jbatches(step):
            b = batches(step)
            return None if b is None else \
                {k: jnp.asarray(v.numpy().astype(np.int32))
                 for k, v in b.items()}
        jstate, want, jstop = jtrain.train_loop(
            jstep, jinit({k: jnp.asarray(v) for k, v in np_params.items()}),
            jbatches, rng=jax.random.key(3))
    assert jstop == stop and sorted(want) == sorted(got) == [0, 1, 2, 3]
    for s in want:
        assert abs(got[s] - want[s]) <= 1e-5 * abs(want[s]), (s, got, want)
    summary = events.recent(kind="step_summary")[-1]
    jsummary = jevents.recent(kind="step_summary")[-1]
    for key in ("site", "steps", "stop", "final_step"):
        assert summary[key] == jsummary[key], key


def test_preempt_and_resume_equals_the_uninterrupted_run(
        tmp_path, monkeypatch, uninterrupted):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "step=3:preempt")
    state, losses, stop, mgr = _run(tmp_path)
    assert stop == "preempted" and state.step == 3
    assert sorted(losses) == [0, 1, 2]
    assert mgr.committed_steps() == [2, 3]
    monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC")
    faults.reset()
    preemption.reset()
    state, losses, stop, _ = _run(tmp_path, resume=True)
    assert stop == "completed"
    _assert_resumed_equal(state, losses, uninterrupted, 3)


def test_crash_and_resume_equals_the_uninterrupted_run(tmp_path,
                                                      uninterrupted):
    """A subprocess runs the same loop under step=3:crash and dies with
    CRASH_EXIT_CODE at step 3's boundary; this process resumes from its
    last committed checkpoint (step 2)."""
    env = dict(os.environ, PADDLE_TPU_FAULT_SPEC="step=3:crash",
               PYTHONPATH=_REPO)
    r = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                       cwd=_REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == CRASH_EXIT_CODE, r.stdout + r.stderr
    assert CheckpointManager(str(tmp_path)).committed_steps() == [2]
    state, losses, stop, _ = _run(tmp_path, resume=True)
    assert stop == "completed"
    _assert_resumed_equal(state, losses, uninterrupted, 2)


def test_fetch_window_does_not_change_the_losses(tmp_path, uninterrupted):
    """And the window bounds the handles outstanding: none once the
    loop has drained."""
    for window in (1, 2):
        async_exec.reset_inflight_stats()
        state, losses, stop, _ = _run(tmp_path / str(window),
                                      fetch_window=window)
        assert losses == uninterrupted[0], window
        stats = async_exec.inflight_stats()
        assert stats["open"] == 0
        assert stats["high_water"] == (0 if window == 1 else 2)


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    _run(tmp_path)
    mgr = CheckpointManager(str(tmp_path))
    with open(os.path.join(mgr.step_dir(6), tckpt.PAYLOAD_FILE), "wb") as f:  # atomic-exempt: deliberate corruption
        f.write(b"\x00")
    events.clear()
    params, init, _ = RUN["make"]()
    restored = mgr.restore_latest(init(params))
    assert restored.step == 4
    skipped = [(e["step"], e["reason"]) for e in
               events.recent(kind="restore") if not e.get("ok")]
    assert skipped == [(6, "corrupt")]
    assert mgr.committed_steps() == [4]         # the corrupt dir demoted


def test_restore_copies_into_the_templates_own_tensors(tmp_path):
    """The optimizer keeps stepping the template's tensors: restore
    copies into them instead of rebinding."""
    params, init, step = RUN["make"]()
    state = init(params)
    for s in range(2):
        state, _ = step(state, RUN["batch_fn"](s), s)
    tckpt.save_train_state(str(tmp_path / "ck"), state)
    with pytest.raises(FileExistsError):
        tckpt.save_train_state(str(tmp_path / "ck"), state)
    template = init(params)
    before = dict(template.params)
    got = tckpt.restore_train_state(str(tmp_path / "ck"), template)
    assert got is template and got.step == 2
    opt_params = [p for g in got.opt_state.param_groups for p in g["params"]]
    for k, v in got.params.items():
        assert v is before[k] and torch.equal(v, state.params[k]), k
    assert all(any(p is v for v in got.params.values()) for p in opt_params)
    a = state.opt_state.state_dict()["state"]
    b = got.opt_state.state_dict()["state"]
    for i in a:
        for name in a[i]:
            assert torch.equal(a[i][name], b[i][name]), (i, name)
    # one more step from each: the same bits
    _, l1 = step(state, RUN["batch_fn"](2), 2)
    _, l2 = step(got, RUN["batch_fn"](2), 2)
    assert l1.item() == l2.item()


def test_precision_mismatch_refused_unless_cast(tmp_path):
    """A bf16-policy checkpoint into an f32 template raises
    PrecisionMismatchError; cast_dtypes=True casts it."""
    params, init, step = RUN["make"]("bf16")
    state = init(params)
    state, _ = step(state, RUN["batch_fn"](0), 0)
    tckpt.save_train_state(str(tmp_path), state, force=True)
    params32, init32, _ = RUN["make"]("f32")
    with pytest.raises(tckpt.PrecisionMismatchError, match="bfloat16"):
        tckpt.restore_train_state(str(tmp_path), init32(params32))
    got = tckpt.restore_train_state(str(tmp_path), init32(params32),
                                    cast_dtypes=True)
    for k, v in got.params.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, state.params[k].float()), k
    for st in got.opt_state.state.values():
        assert st["exp_avg"].dtype == torch.float32
    # a mixed checkpoint carries loss-scale state an f32 template lacks
    paramsm, initm, stepm = RUN["make"]("mixed_bf16")
    sm = initm(paramsm)
    tckpt.save_train_state(str(tmp_path / "mixed"), sm)
    with pytest.raises(tckpt.PrecisionMismatchError, match="loss-scaling"):
        tckpt.restore_train_state(str(tmp_path / "mixed"), init32(params32))
    got = tckpt.restore_train_state(str(tmp_path / "mixed"),
                                    init32(params32), cast_dtypes=True)
    assert got.loss_scale is None


def test_shape_mismatch_raises_reshard_error(tmp_path):
    params, init, _ = RUN["make"]()
    tckpt.save_train_state(str(tmp_path), init(params), force=True)
    wide = tbert.BertConfig.tiny()
    wide.dtype, wide.mlp_dim = "float32", 256
    pw, initw, _ = RUN["make"](cfg=wide)
    template = initw(pw)
    snapshot = {k: v.detach().clone() for k, v in template.params.items()}
    with pytest.raises(tckpt.ReshardError, match="mlp"):
        tckpt.restore_train_state(str(tmp_path), template)
    for k, v in template.params.items():   # nothing was written
        assert torch.equal(v, snapshot[k]), k


def test_mixed_loss_scale_round_trips(tmp_path):
    params, init, step = RUN["make"]("mixed_bf16")
    state = init(params)
    for s in range(3):
        state, _ = step(state, RUN["batch_fn"](s), s)
    state.loss_scale = dict(state.loss_scale, scale=1024.0, overflows=2,
                            growths=1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state)
    got = mgr.restore_latest(init(params))
    assert got.step == 3 and got.loss_scale == state.loss_scale
    assert got.loss_scale == {"scale": 1024.0, "good_steps": 3,
                              "overflows": 2, "growths": 1}


def test_rollback_on_a_nan_restores_and_backs_off_the_lr(tmp_path,
                                                        monkeypatch):
    """A NaN loss at step 3 (level-2 numerics checks) under the rollback
    policy: the live state is restored from the step-2 checkpoint in
    place, every param group's lr halves, and steps 2 and 3 replay."""
    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "2")
    params = RUN["make"]()[0]
    poisoned = []

    def batch_fn(s):
        b = RUN["batch_fn"](s)
        if b is not None:
            bad = s == 3 and not poisoned
            if s == 3:
                poisoned.append(s)
            b["nan"] = torch.tensor(float("nan") if bad else 1.0)
        return b

    def loss_fn(p, b, g):
        return tbert.pretrain_loss(p, RUN["CFG"], b, rng=g,
                                   deterministic=True) * b["nan"]

    init, step = ttrain.make_train_step(
        loss_fn, lambda ps: torch.optim.AdamW(ps, lr=1e-3,
                                              weight_decay=1e-4),
        device="cpu", precision="f32")
    mgr = CheckpointManager(str(tmp_path))
    ctl = RecoveryController(RecoveryPolicy(on_numerics="rollback",
                                            lr_backoff=0.5), manager=mgr)
    state = init(params)
    opt = state.opt_state
    state, losses, stop = ttrain.train_loop(
        step, state, batch_fn, rng=7, manager=mgr, save_every=2,
        controller=ctl)
    assert stop == "completed" and state.step == RUN["STEPS"]
    assert ctl.rollbacks == 1 and poisoned == [3, 3]
    assert state.opt_state is opt
    assert [g["lr"] for g in opt.param_groups] == [5e-4]
    assert sorted(losses) == list(range(RUN["STEPS"]))
    assert all(np.isfinite(list(losses.values())))
    assert all(torch.isfinite(v).all() for v in state.params.values())


def test_sync_loss_scale_metrics_matches_the_jax_package():
    """The same sequence of cumulative loss-scale counters through both
    packages' sync_loss_scale_metrics: the same amp_overflow events and
    the same counter increments."""
    from paddle_tpu.observability import telemetry as jtelemetry

    seq = [(0, 0, 2.0 ** 15), (0, 1, 2.0 ** 16), (2, 1, 2.0 ** 14),
           (2, 1, 2.0 ** 14), (3, 2, 2.0 ** 14)]

    def run(make_state, sync, ev, tel):
        ev.clear()
        before = {e: tel.AMP_EVENTS.value(event=e)
                  for e in ("overflow", "skip", "growth")}
        last = None
        for i, (o, g, s) in enumerate(seq):
            last = sync(make_state(i, o, g, s), last)
        return ([(e["count"], e["step"], e["scale"])
                 for e in ev.recent(kind="amp_overflow")],
                {e: tel.AMP_EVENTS.value(event=e) - n
                 for e, n in before.items()},
                tel.AMP_LOSS_SCALE.value())

    class State:
        def __init__(self, step, ls):
            self.step, self.loss_scale = step, ls

    port = run(lambda i, o, g, s: State(i, {
        "overflows": o, "growths": g, "scale": s, "good_steps": 0}),
        ttrain.sync_loss_scale_metrics, events, telemetry)
    jax_ = run(lambda i, o, g, s: State(jnp.int32(i), {
        "overflows": jnp.int32(o), "growths": jnp.int32(g),
        "scale": jnp.float32(s), "good_steps": jnp.int32(0)}),
        jtrain.sync_loss_scale_metrics, jevents, jtelemetry)
    assert port == jax_
    assert port[0] == [(2, 2, 2.0 ** 14), (1, 4, 2.0 ** 14)]
    assert port[1] == {"overflow": 3, "skip": 3, "growth": 2}
    assert ttrain.sync_loss_scale_metrics(State(0, None), {"x": 1}) == \
        {"x": 1}
