"""The port's data and tensor parallelism (dp, tp, ZeRO-1) on in-process
rings against the JAX package on its virtual 8-device CPU mesh: BERT
under dp2 tp2 sp2 (graft path 1), a batch whose valid MLM labels differ
in count between the dp shards, ZeRO-1 and gradient accumulation, the
sync-BN ResNet at dp=8 (path 4), GPT dense at pp2 tp2 dp2 (path 3) and
GPT-MoE at pp2 dp2 ep2 (path 2), and `mha`'s "shardmap" route.

The JAX package runs `make_train_step` (or the loss under `jax.jit`)
inside `mesh_guard` of its mesh of CPU devices; the port the same
entry points on `make_mesh(MeshConfig(...), devices=["cpu"] * n)`.
Params are the JAX package's, carried across by `params_from_numpy`;
batches are numpy from a seed, handed to both.

Tolerances, all at f32 unless named:
- BERT under dp2 tp2 sp2: the step-0 loss within 1e-5 relative of the
  JAX package's mesh step and of its one-device step, and every
  gradient within 1e-4 of its largest value of the one-device step's
  (`test_torch_ring`'s model limits; measured 8e-7). The JAX package's
  mesh step is no oracle for the gradients: on this CPU mesh (x64 off,
  as its partitioner needs) they lie up to 17% of their largest value
  from its own one-device step's (the embeddings, `layer0.mlp.down`;
  ROADMAP §3, F7), which its own test's 2e-2 on the losses admits.
  3 AdamW steps
  (lr 1e-3) within 1e-5 relative of the port's no-mesh run and of the
  JAX package's one-device run (the same f32 arithmetic summed in other
  orders; measured up to 1.5e-7), and of the JAX package's own mesh run
  within its own test's limit for that run against one device, 2e-2
  (measured: the JAX mesh trajectory drifts from its one-device one by
  up to 4.3e-3 in 3 steps, the port's by 1.5e-7);
- the uneven MLM batch: loss within 1e-6 relative, while averaging the
  dp ranks' own means is off by more than 100 times that;
- ZeRO-1 against replicated AdamW: params bit for bit, under
  `torch.use_deterministic_algorithms` (the CPU's embedding backward
  accumulates its rows in a thread order that varies run to run
  otherwise); accum_steps=2 and ZeRO-1 against the JAX package's same
  strategy within 1e-5 relative of its one-device trajectory and 2e-2
  of its mesh one, as above; a ZeRO-1 rollback with lr backoff under
  `train_loop` against the replicated optimizer's: losses and params
  bit for bit (deterministic algorithms);
- ResNet at f64 activations, as the JAX package's own sync-BN test:
  the 3 losses within 1e-6 relative of the port's no-mesh run (the
  head and its log-softmax are f32 by design; measured 1.2e-7) and the
  first two within 1e-4 of the JAX package's dp=8 run (the two f32
  heads round differently and SGD carries it on: measured 6e-6 at
  step 1, 1.2e-4 at step 2, a trajectory that chaotic is held a step
  at a time in `test_torch_resnet`); the stem's BN running mean after
  each step within the JAX test's rtol 1e-5, atol 1e-8 of the no-mesh
  run's, and after step 0 of the JAX package's;
- the GPT losses within 1e-5 relative (measured 1.1e-6: tp's partial
  sums in another order than GSPMD's) and each gradient's RMS
  difference within 1e-5 of its RMS (`test_torch_moe`'s GRAD_TOL); the
  MoE loss with no dp split differs by more than 1e-4;
- `mha`'s shardmap route within 1e-6 of the no-mesh call (the plain
  version per rank block) and 2e-5 of the JAX package's splash blocks
  in interpret mode (its own limit for splash against XLA).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import set_flags
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import resnet as jres
from paddle_tpu.ops.pallas import attention as jattn
from paddle_tpu.parallel import MeshConfig as JMeshConfig
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import mesh_guard as jmesh_guard
from paddle_tpu.parallel import train as jtrain

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import train as ttrain

from test_torch_moe import GRAD_TOL, _rel_rms

torch.set_num_threads(2)

STEPS = 3


def _n(axes):
    return int(np.prod(list(axes.values())))


def _tmesh(**axes):
    return tmesh.make_mesh(tmesh.MeshConfig(**{"dp": 1, **axes}),
                           devices=["cpu"] * _n(axes))


def _jmesh(**axes):
    return jmake_mesh(JMeshConfig(**{"dp": 1, **axes}),
                      devices=jax.devices()[:_n(axes)])


def _adamw(lr=1e-3):
    # optax.adamw(lr): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
    return lambda ps: torch.optim.AdamW(ps, lr=lr, weight_decay=1e-4)


def _bert():
    jcfg = dataclasses.replace(jbert.BertConfig.tiny(), dtype="float32")
    tcfg = tbert.BertConfig(**vars(jcfg))
    jparams, axes = jbert.init(jax.random.key(0), jcfg)
    return jcfg, tcfg, {k: np.asarray(v) for k, v in jparams.items()}, axes


def _bert_batch(tcfg, bs=16, T=32, seed=1):
    return tbert.make_batch(np.random.RandomState(seed), tcfg, bs, T,
                            device="cpu")


def _jb(tb):
    return {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}


def _jax_bert(jcfg, np_params, axes, batch, mesh_axes, strategy):
    """The JAX package's BERT trajectory on its CPU mesh. x64 is off: it
    aborts XLA's SPMD partitioner on the embedding gradient's scatter
    under this mesh, and the f32 model declares its dtypes."""
    with jax.enable_x64(False):
        mesh = _jmesh(**mesh_axes)
        with jmesh_guard(mesh):
            init, step = jtrain.make_train_step(
                lambda p, b, r: jbert.pretrain_loss(p, jcfg, b, rng=r,
                                                    deterministic=True),
                optax.adamw(1e-3), mesh, axes, strategy=strategy)
            state = init({k: jnp.asarray(v) for k, v in np_params.items()})
            losses = []
            for i in range(STEPS):
                state, loss = step(state, _jb(batch), jax.random.key(10 + i))
                losses.append(float(loss))
    return losses


def _port_bert(tcfg, np_params, axes, batch, mesh_axes,
               strategy=None, steps=STEPS):
    mesh = _tmesh(**mesh_axes) if mesh_axes is not None else None
    init, step = ttrain.make_train_step(
        lambda p, b, g: tbert.pretrain_loss(p, tcfg, b, rng=g,
                                            deterministic=True),
        _adamw(), device="cpu", strategy=strategy, mesh=mesh,
        param_axes=axes)
    state = init(params_from_numpy(np_params, "cpu"))
    losses = []
    for i in range(steps):
        state, loss = step(state, batch, i)
        losses.append(loss.item())
    return state, losses, step


def _check_model(jloss, jgrads, tparams, tloss):
    """Loss within 1e-5 relative, each gradient within 1e-4 of its
    largest value (at least 1)."""
    tgrads = torch.autograd.grad(tloss, list(tparams.values()),
                                 allow_unused=True)
    assert abs(float(jloss) - tloss.item()) <= 1e-5 * abs(float(jloss))
    for (name, p), g in zip(tparams.items(), tgrads):
        g = torch.zeros_like(p) if g is None else g
        want = np.asarray(jgrads[name], np.float32)
        err = np.abs(want - g.detach().numpy()).max()
        assert err <= 1e-4 * max(1.0, np.abs(want).max()), name


def _close(got, want, rtol):
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= rtol * abs(w), (i, g, w)


def test_bert_dp2_tp2_sp2_matches_the_jax_package():
    """Path 1: BERT-tiny at 16 x 32 under dp2 tp2 sp2, as
    `test_models_parallel.test_bert_dp_tp_sp_matches_single_device`
    runs the JAX package's: the loss and every gradient against its
    mesh step, then 3 AdamW steps against the port's no-mesh run and
    the JAX package's one-device and mesh runs. Every attention call
    takes the sp ring ("ring_xla": the head dim 16 is no kernel's)."""
    jcfg, tcfg, np_params, axes = _bert()
    batch = _bert_batch(tcfg)
    mesh = dict(dp=2, tp=2, sp=2)
    with jax.enable_x64(False), jmesh_guard(_jmesh(**mesh)):
        jloss = jax.jit(lambda p: jbert.pretrain_loss(
            p, jcfg, _jb(batch), deterministic=True))(
            {k: jnp.asarray(v) for k, v in np_params.items()})
    tparams = params_from_numpy(np_params, "cpu")
    for v in tparams.values():
        v.requires_grad_()
    with jax.enable_x64(False):
        oloss, ograds = jax.jit(jax.value_and_grad(
            lambda p: jbert.pretrain_loss(p, jcfg, _jb(batch),
                                          deterministic=True)))(
            {k: jnp.asarray(v) for k, v in np_params.items()})
    with tmesh.mesh_guard(_tmesh(**mesh)):
        tloss = tbert.pretrain_loss(tparams, tcfg, batch, deterministic=True)
    _check_model(oloss, ograds, tparams, tloss)
    assert abs(float(jloss) - tloss.item()) <= 1e-5 * abs(float(jloss))
    want = _jax_bert(jcfg, np_params, axes, batch, mesh,
                     jtrain.TrainStrategy())
    one = _jax_bert(jcfg, np_params, axes, batch, dict(dp=1),
                    jtrain.TrainStrategy())
    tattn.GATE_COUNTS.clear()
    state, got, _ = _port_bert(tcfg, np_params, axes, batch, mesh)
    assert dict(tattn.GATE_COUNTS) == {"ring_xla": jcfg.layers * STEPS}
    _, single, _ = _port_bert(tcfg, np_params, axes, batch, None)
    _close(got, single, 1e-5)
    _close(got, one, 1e-5)
    _close(got, want, 2e-2)
    assert got[-1] < got[0]
    # ZeRO-1 is the default: the moments are held as dp slices
    assert isinstance(state.opt_state, ttrain.Zero1Optimizer)


def test_bert_mlm_loss_divides_by_the_global_count():
    """The MLM loss divides the ranks' summed log-likelihoods by the
    global count of valid labels: here the first dp shard holds 12 of
    them and the second 3, so averaging the ranks' own means would be
    another loss. The port at dp=2 (and dp2 tp2) against the JAX
    package's mesh and the port's no-mesh loss."""
    jcfg, tcfg, np_params, axes = _bert()
    batch = _bert_batch(tcfg, bs=4)
    lab = batch["masked_labels"].clone()
    lab[2:, 1:] = -100                 # shard 2: one valid label a row
    batch["masked_labels"] = lab
    valid = (lab >= 0).reshape(2, -1).sum(1).tolist()
    assert valid[0] != valid[1], valid
    batch.pop("nsp_labels")
    tparams = params_from_numpy(np_params, "cpu")

    def port(mesh):
        with tmesh.mesh_guard(mesh) if mesh else _nullcontext():
            return tbert.pretrain_loss(tparams, tcfg, batch,
                                       deterministic=True).item()

    with jax.enable_x64(False), jmesh_guard(_jmesh(dp=2, tp=2)):
        want = float(jax.jit(lambda p: jbert.pretrain_loss(
            p, jcfg, _jb(batch), deterministic=True))(
            {k: jnp.asarray(v) for k, v in np_params.items()}))
    single = port(None)
    for mesh in (_tmesh(dp=2), _tmesh(dp=2, tp=2)):
        got = port(mesh)
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)
        assert abs(got - single) <= 1e-6 * abs(single), (got, single)
    # what averaging the ranks' own means would give
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    wrong = np.mean([tbert.pretrain_loss(tparams, tcfg, h,
                                         deterministic=True).item()
                     for h in halves])
    assert abs(wrong - want) > 1e-4 * abs(want), (wrong, want)


def _nullcontext():
    import contextlib

    return contextlib.nullcontext()


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_zero1_equals_replicated_adamw_bit_for_bit(deterministic):
    """ZeRO-1 (each moment held as dp slices along its first unsharded
    dim that dp divides) against replicated AdamW at dp=8: the params
    after 3 steps bit for bit, and the losses."""
    jcfg, tcfg, np_params, axes = _bert()
    batch = _bert_batch(tcfg)
    z_state, z_losses, _ = _port_bert(
        tcfg, np_params, axes, batch, dict(dp=8),
        ttrain.TrainStrategy(shard_optimizer_states=True))
    r_state, r_losses, _ = _port_bert(
        tcfg, np_params, axes, batch, dict(dp=8),
        ttrain.TrainStrategy(shard_optimizer_states=False))
    assert isinstance(z_state.opt_state, ttrain.Zero1Optimizer)
    assert isinstance(r_state.opt_state, torch.optim.AdamW)
    assert z_losses == r_losses
    for k, v in r_state.params.items():
        assert torch.equal(z_state.params[k], v), k
    # each rank holds its slice of every sliced moment
    opt = z_state.opt_state
    word = [i for i, p in enumerate(opt.params)
            if p is z_state.params["embeddings.word.w"]][0]
    # (vocab, embed) -> ("tp", None): the first unsharded dim is embed
    assert opt.dims[word] == 1
    sliced = sum(d is not None for d in opt.dims)
    for r in range(8):
        st = opt.ranks[r].state_dict()["state"]
        assert len(st) == sliced
        w = st[sum(d is not None for d in opt.dims[:word])]["exp_avg"]
        assert tuple(w.shape) == (jcfg.vocab_size, jcfg.hidden // 8)


def test_zero1_rollback_backs_off_every_slices_lr(tmp_path, monkeypatch,
                                                  deterministic):
    """`train_loop` at dp=2 under the rollback policy (lr_backoff 0.5)
    with a NaN loss at step 3: the ZeRO-1 state rolls back to the step-2
    checkpoint and every param group of every rank's optimizer (and of
    the whole params') halves its lr, so the 6 losses and the params
    equal the replicated AdamW's run through the same rollback, bit for
    bit. A backoff that missed a slice would step it at the old lr."""
    from paddle_tpu_torch.resilience import (CheckpointManager,
                                             RecoveryController,
                                             RecoveryPolicy)

    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "2")
    jcfg, tcfg, np_params, axes = _bert()

    def run(zero1, where):
        poisoned = []

        def batch_fn(s):
            if s >= 6:
                return None
            b = _bert_batch(tcfg, bs=8, seed=s)
            b["nan"] = torch.tensor(float("nan") if s == 3 and not poisoned
                                    else 1.0)
            if s == 3:
                poisoned.append(s)
            return b

        init, step = ttrain.make_train_step(
            lambda p, b, g: tbert.pretrain_loss(
                p, tcfg, b, rng=g, deterministic=True) * b["nan"],
            _adamw(), device="cpu", mesh=_tmesh(dp=2), param_axes=axes,
            strategy=ttrain.TrainStrategy(shard_optimizer_states=zero1))
        mgr = CheckpointManager(str(tmp_path / where))
        ctl = RecoveryController(RecoveryPolicy(on_numerics="rollback",
                                                lr_backoff=0.5), manager=mgr)
        state, losses, stop = ttrain.train_loop(
            step, init(params_from_numpy(np_params, "cpu")), batch_fn,
            rng=7, manager=mgr, save_every=2, controller=ctl)
        assert stop == "completed" and state.step == 6
        assert ctl.rollbacks == 1 and poisoned == [3, 3]
        return state, losses

    z_state, z_losses = run(True, "zero1")
    r_state, r_losses = run(False, "replicated")
    opt = z_state.opt_state
    assert isinstance(opt, ttrain.Zero1Optimizer) and len(opt.optimizers) > 1
    assert [g["lr"] for g in opt.param_groups] == [5e-4] * len(opt.optimizers)
    assert [g["lr"] for g in r_state.opt_state.param_groups] == [5e-4]
    assert z_losses == r_losses and sorted(z_losses) == list(range(6))
    for k, v in r_state.params.items():
        assert torch.equal(z_state.params[k], v), k


def test_batch_spec_is_checked_once():
    """`batch_spec` names axes of the mesh or the step refuses it at
    `make_train_step`; a valid one changes no loss (the rules split the
    batch on in-process rings)."""
    from paddle_tpu_torch.parallel.sharding import PartitionSpec

    jcfg, tcfg, np_params, axes = _bert()
    batch = _bert_batch(tcfg, bs=8)

    def loss(spec):
        init, step = ttrain.make_train_step(
            lambda p, b, g: tbert.pretrain_loss(p, tcfg, b, rng=g,
                                                deterministic=True),
            _adamw(), device="cpu", mesh=_tmesh(dp=2, sp=2),
            param_axes=axes, batch_spec=spec)
        return step(init(params_from_numpy(np_params, "cpu")), batch,
                    0)[1].item()

    assert loss(PartitionSpec("dp", "sp")) == loss(None) == \
        loss(PartitionSpec(("dp", "sp"), None))
    with pytest.raises(ValueError, match="'data'"):
        loss(PartitionSpec("data", None))


def test_zero1_and_grad_accum_match_the_jax_package():
    """`test_bert_zero1_and_grad_accum_match`'s runs through both
    packages: ZeRO-1 at dp=8 and accum_steps=2 at dp=2, each trajectory
    against the JAX package's same strategy."""
    jcfg, tcfg, np_params, axes = _bert()
    batch = _bert_batch(tcfg)
    for mesh, strategy in (
            (dict(dp=8), dict(shard_optimizer_states=True)),
            (dict(dp=2), dict(accum_steps=2))):
        want = _jax_bert(jcfg, np_params, axes, batch, mesh,
                         jtrain.TrainStrategy(**strategy))
        one = _jax_bert(jcfg, np_params, axes, batch, dict(dp=1),
                        jtrain.TrainStrategy(**strategy))
        _, got, _ = _port_bert(tcfg, np_params, axes, batch, mesh,
                               ttrain.TrainStrategy(**strategy))
        _close(got, one, 1e-5)
        _close(got, want, 2e-2)


def test_resnet_dp8_sync_bn_matches_the_jax_package():
    """Path 4 (BASELINE's config 5) as
    `test_resnet_dp_matches_single_device_sync_bn`: ResNet-tiny at f64
    activations, 16 x 32^2, 3 SGD-momentum steps at dp=8 against the
    port with no mesh and the JAX package's dp=8 run: losses and the
    stem's BN running mean. `fused_1x1` is asked for and stays off under the
    mesh, as the JAX package's gate turns it off."""
    jcfg = dataclasses.replace(jres.ResNetConfig.tiny(), dtype="float64")
    tcfg = tres.ResNetConfig(**{**vars(jcfg), "fused_1x1": True})
    jparams, axes = jres.init(jax.random.key(0), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    batch = tres.make_batch(np.random.RandomState(1), tcfg, 16, hw=32,
                            device="cpu")
    batch["img"] = batch["img"].double()
    jb = {"img": jnp.asarray(batch["img"].numpy()),
          "label": jnp.asarray(batch["label"].numpy().astype(np.int32))}
    mesh = _jmesh(dp=8)
    with jmesh_guard(mesh):
        init, step = jtrain.make_train_step(
            lambda p, b, r: jres.loss_fn(p, jcfg, b, r),
            optax.sgd(0.05, momentum=0.9), mesh, axes, has_aux=True)
        state = init({k: jnp.asarray(v) for k, v in np_params.items()})
        want = []
        for i in range(STEPS):
            state, loss = step(state, jb, jax.random.key(10 + i))
            want.append(float(loss))
            if i == 0:
                want_bn = np.asarray(state.params["stem.bn.mean"],
                                     np.float64)

    def port(mesh_axes, cfg):
        init, step = ttrain.make_train_step(
            lambda p, b, g: tres.loss_fn(p, cfg, b, g),
            lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9),
            device="cpu", has_aux=True, param_axes=axes,
            mesh=_tmesh(**mesh_axes) if mesh_axes else None)
        state = init(params_from_numpy(np_params, "cpu"))
        losses, bn = [], []
        for i in range(STEPS):
            losses.append(step(state, batch, i)[1].item())
            bn.append(state.params["stem.bn.mean"].detach().double().numpy())
        return losses, bn

    tp = params_from_numpy(np_params, "cpu")
    assert tres._fused_1x1_ok(tp, "g0.b0", tcfg, True)
    with tmesh.mesh_guard(_tmesh(dp=8)):
        assert not tres._fused_1x1_ok(tp, "g0.b0", tcfg, True)
    got, got_bn = port(dict(dp=8), tcfg)
    single, single_bn = port(None, dataclasses.replace(tcfg,
                                                       fused_1x1=False))
    _close(got, single, 1e-6)
    _close(got[:2], want[:2], 1e-4)
    np.testing.assert_allclose(got_bn[0], want_bn, rtol=1e-5, atol=1e-8)
    for a, b in zip(got_bn, single_bn):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


def test_resnet_bn_statistics_reduce_over_the_dp_ring(monkeypatch):
    """Under dp the BN statistics come from the ranks' sums, all-reduced
    over the dp ring (one all-reduce of sums and one of squares per BN
    layer), not from one whole-batch mean."""
    from paddle_tpu_torch.core import ring as tring

    cfg = tres.ResNetConfig(depth=50, n_classes=10, width=8,
                            dtype="float64")
    params, _ = tres.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    batch = tres.make_batch(np.random.RandomState(0), cfg, 4, hw=32,
                            device="cpu")
    batch["img"] = batch["img"].double()
    calls = []
    real = tring.InProcessRing.all_reduce

    def spy(self, xs, op="sum"):
        calls.append((self.size, len(xs), op))
        return real(self, xs, op)

    monkeypatch.setattr(tring.InProcessRing, "all_reduce", spy)
    with tmesh.mesh_guard(_tmesh(dp=4)):
        loss, upd = tres.loss_fn(params, cfg, batch)
    n_bn = sum(k.endswith(".bn.mean") or k.endswith("bn1.mean")
               or k.endswith("bn2.mean") or k.endswith("bn3.mean")
               for k in params)
    # each BN layer reduces its sums and its squares; the loss its sum
    assert calls.count((4, 4, "sum")) == 2 * n_bn + 1, (len(calls), n_bn)
    calls.clear()
    want, want_upd = tres.loss_fn(params, cfg, batch)
    assert not calls
    assert abs(loss.item() - want.item()) <= 1e-9 * abs(want.item())
    for k, v in want_upd.items():
        np.testing.assert_allclose(upd[k].numpy(), v.numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


def _check_gpt(jloss, jgrads, tparams, tloss):
    """The loss within 1e-5 relative, each gradient's RMS difference
    within `test_torch_moe`'s GRAD_TOL of its RMS."""
    assert abs(tloss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = torch.autograd.grad(tloss, list(tparams.values()))
    errs = {k: _rel_rms(jgrads[k], g) for k, g in zip(tparams, grads)}
    assert max(errs.values()) <= GRAD_TOL, errs


def _gpt(n_experts=0):
    # capacity factor 0.5 for the MoE: a shard's capacity binds
    jcfg = dataclasses.replace(jgpt.GPTConfig.tiny(n_experts=n_experts),
                               dtype="float32",
                               capacity_factor=0.5 if n_experts else 1.25)
    tcfg = tgpt.GPTConfig(**vars(jcfg))
    jparams, _ = jgpt.init(jax.random.key(6 + n_experts), jcfg)
    return jcfg, tcfg, jparams


def _gpt_parity(mesh_axes, n_experts, n_micro=4, bs=8, T=32):
    jcfg, tcfg, jparams = _gpt(n_experts)
    ids = np.random.RandomState(7).randint(0, jcfg.vocab_size, (bs, T + 1))
    with jmesh_guard(_jmesh(**mesh_axes)):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jgpt.lm_loss(p, jcfg, {"ids": jnp.asarray(ids)},
                                   n_microbatches=n_micro)))(jparams)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, "cpu")
    for v in tparams.values():
        v.requires_grad_()
    with tmesh.mesh_guard(_tmesh(**mesh_axes)):
        tloss = tgpt.lm_loss(tparams, tcfg, {"ids": torch.from_numpy(ids)},
                             n_microbatches=n_micro)
    return jloss, jgrads, tparams, tloss, tcfg, ids


def test_gpt_dense_pp2_tp2_dp2_matches_the_jax_package():
    """Path 3: GPT-tiny dense, 8 x 32 in 4 microbatches under pp2 tp2
    dp2: the pipelined loss and every gradient against the JAX
    package's, and the loss within the graft path's bound of the
    unpipelined `lm_loss` with no mesh."""
    jloss, jgrads, tparams, tloss, tcfg, ids = _gpt_parity(
        dict(pp=2, tp=2, dp=2), 0)
    _check_gpt(jloss, jgrads, tparams, tloss)
    ref = tgpt.lm_loss(tparams, tcfg, {"ids": torch.from_numpy(ids)}).item()
    assert abs(ref - tloss.item()) < 5e-2 + 1e-3 * abs(ref)


def test_gpt_moe_pp2_dp2_ep2_matches_the_jax_package():
    """Path 2: GPT-tiny with 4 experts under pp2 dp2 ep2: the capacity
    comes from a microbatch's dp shard of tokens in both packages, so
    the loss and gradients equal the JAX package's, and differ from
    the same pipeline with no dp split (whole microbatches)."""
    jloss, jgrads, tparams, tloss, tcfg, ids = _gpt_parity(
        dict(pp=2, dp=2, ep=2), 4)
    _check_gpt(jloss, jgrads, tparams, tloss)
    with tmesh.mesh_guard(_tmesh(pp=2, ep=2)):
        whole = tgpt.lm_loss(tparams, tcfg, {"ids": torch.from_numpy(ids)},
                             n_microbatches=4).item()
    assert abs(whole - tloss.item()) > 1e-4 * abs(tloss.item())


def test_gpt_moe_tp2_ep2_matches_the_jax_package():
    """GPT-tiny with 4 experts under tp2 ep2 with no pipeline: the
    experts' FFN split along "mlp" over tp (partial products summed)
    and along the experts over ep, the loss and every gradient against
    the JAX package's GSPMD run."""
    jloss, jgrads, tparams, tloss, _, _ = _gpt_parity(dict(tp=2, ep=2), 4,
                                                      n_micro=0)
    _check_gpt(jloss, jgrads, tparams, tloss)


def _qkv(B=4, T=128, N=4, H=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, T, N, H, generator=g) for _ in range(3)]


@pytest.mark.parametrize("axes", [dict(dp=2, tp=2), dict(dp=4),
                                  dict(tp=2)])
def test_mha_shardmap_route_counts_and_matches(axes):
    """An unmasked call under dp/tp runs once per (dp, tp) rank on its
    block ("splash_shardmap"), equal to the no-mesh call and to the JAX
    package's `_shardmap_splash_mha` (splash in interpret mode)."""
    q, k, v = _qkv()
    want = tattn.mha(q, k, v)
    tattn.GATE_COUNTS.clear()
    with tmesh.mesh_guard(_tmesh(**axes)):
        got = tattn.mha(q, k, v)
    assert dict(tattn.GATE_COUNTS) == {"splash_shardmap": 1}
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    set_flags({"FLAGS_flash_attention": "splash"})
    try:
        jattn.GATE_COUNTS.clear()
        with jmesh_guard(_jmesh(**axes)):
            jout = jax.jit(lambda a, b, c: jattn.mha(a, b, c))(
                *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    finally:
        set_flags({"FLAGS_flash_attention": "auto"})
    assert jattn.GATE_COUNTS["splash_shardmap"] >= 1
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), atol=2e-5)


def test_mha_shardmap_gate_and_the_masked_call_per_tp_rank():
    """The gate's other side takes the single-device route: a batch dp
    does not divide, T off a multiple of 128, a head dim off 64, the
    manual region. A masked call under tp runs per tp rank on its
    heads, equal to the no-mesh call."""
    mesh = _tmesh(dp=2, tp=2)
    with tmesh.mesh_guard(mesh):
        for q in (_qkv(B=3)[0], _qkv(T=96)[0], _qkv(H=16)[0]):
            assert not tattn._shardmap_route(q, q, None)
        q, k, v = _qkv()
        assert tattn._shardmap_route(q, k, None)
        assert not tattn._shardmap_route(q, k, torch.zeros(4, 1, 1, 128))
        from paddle_tpu_torch.parallel.sharding import manual_region

        with manual_region():
            assert not tattn._shardmap_route(q, k, None)
    q, k, v = _qkv()
    mask = torch.where(torch.rand(4, 1, 1, 128,
                                  generator=torch.Generator().manual_seed(1))
                       > 0.3, 0.0, -1e9)
    want = tattn.mha(q, k, v, mask=mask)
    tattn.GATE_COUNTS.clear()
    with tmesh.mesh_guard(mesh):
        got = tattn.mha(q, k, v, mask=mask, causal=True)
    assert dict(tattn.GATE_COUNTS) == {"plain": 1}
    np.testing.assert_allclose(
        got.numpy(), tattn.mha(q, k, v, mask=mask, causal=True).numpy(),
        atol=1e-6)
    assert want.shape == got.shape


@pytest.mark.parametrize("what", ["vgg", "transformer", "lenet",
                                  "fluid", "resnet_tp", "apply_prefill",
                                  "apply_decode_step", "apply_prefill_chunk",
                                  "apply_verify_step"])
def test_models_outside_the_slice_refuse_dp_and_tp(what):
    """Transformer-big, VGG-16, LeNet, the fluid Executor, ResNet's
    head under tp and GPT's four decode paths raise, naming the ROADMAP
    item of their split, rather than compute replicated."""
    from paddle_tpu_torch.models import lenet as tlenet
    from paddle_tpu_torch.models import transformer as ttr
    from paddle_tpu_torch.models import vgg as tvgg
    import paddle_tpu_torch as fluid

    gen = torch.Generator().manual_seed(0)
    calls = {
        "vgg": (lambda: tvgg.apply(
            tvgg.init(gen, tvgg.VGGConfig.tiny(), device="cpu")[0],
            tvgg.VGGConfig.tiny(), torch.zeros(2, 3, 32, 32)), "20c-iv"),
        "transformer": (lambda: ttr.encode(
            ttr.init(gen, ttr.TransformerConfig.tiny(), device="cpu")[0],
            ttr.TransformerConfig.tiny(), torch.zeros(2, 8).long()),
            "20c-iv"),
        "lenet": (lambda: tlenet.apply(tlenet.init(gen, device="cpu")[0],
                                       torch.zeros(2, 1, 28, 28)), "20c-iv"),
        "fluid": (lambda: fluid.Executor(fluid.CPUPlace()).run(
            fluid.Program()), "20c-iii"),
        "resnet_tp": (lambda: tres.apply(
            tres.init(gen, tres.ResNetConfig.tiny(), device="cpu")[0],
            tres.ResNetConfig.tiny(), torch.zeros(2, 3, 32, 32)), "20c-iv"),
    }
    # the decode paths' positional args after cfg, as test_torch_moe's
    n_args = 6 if what == "apply_prefill_chunk" else 5
    fn, item = calls.get(what) or (lambda: getattr(tgpt, what)(
        None, tgpt.GPTConfig.tiny(), *[None] * n_args, block_size=8,
        eos_id=0), "20c-iv")
    mesh = _tmesh(tp=2) if what == "resnet_tp" else _tmesh(dp=2)
    with tmesh.mesh_guard(mesh):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            fn()


@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_split_axes_are_inits(model):
    """Every weight a helper splits carries, in `init`'s axes, the
    axes the model's ops hand the helper (`SPLIT_AXES`; a GPT block's
    after its stacked "layer" axis)."""
    if model == "bert":
        _, axes = tbert.init(torch.Generator(), tbert.BertConfig.tiny(),
                             device="cpu")
        want = {k: v for k, v in axes.items()
                if k.endswith(".w") and k[:-2] != "embeddings.position"
                and k[:-2] != "embeddings.type"}
        assert {k: tbert._axes(k[:-2]) for k in want} == want
    else:
        _, axes = tgpt.init(torch.Generator(), tgpt.GPTConfig.tiny(),
                            device="cpu")
        for k, v in tgpt.SPLIT_AXES.items():
            assert axes[k] == (v if k == "wte.w" else ("layer",) + v), k


def test_a_rule_no_helper_splits_raises():
    """A logical axis that the rules map to tp and that no helper splits
    ("embed") raises, naming the rule; a rule of None keeps the params
    whole."""
    from paddle_tpu_torch.parallel import sharding as tsh

    jcfg, tcfg, np_params, _ = _bert()
    tparams = params_from_numpy(np_params, "cpu")
    batch = _bert_batch(tcfg, bs=4)
    want = tbert.pretrain_loss(tparams, tcfg, batch, deterministic=True)
    with tmesh.mesh_guard(_tmesh(tp=2)):
        with tsh.with_rules(tsh.DEFAULT_RULES.updated(embed="tp")):
            with pytest.raises(NotImplementedError,
                               match="rule 'embed' -> 'tp'"):
                tbert.pretrain_loss(tparams, tcfg, batch,
                                    deterministic=True)
        whole = tsh.DEFAULT_RULES.updated(heads=None, mlp=None, vocab=None)
        with tsh.with_rules(whole):
            got = tbert.pretrain_loss(tparams, tcfg, batch,
                                      deterministic=True)
    assert torch.equal(got, want)
