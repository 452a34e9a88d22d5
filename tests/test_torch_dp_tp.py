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
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jres
from paddle_tpu.models import transformer as jtr
from paddle_tpu.models import vgg as jvgg
from paddle_tpu.ops.pallas import attention as jattn
from paddle_tpu.parallel import MeshConfig as JMeshConfig
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import mesh_guard as jmesh_guard
from paddle_tpu.parallel import train as jtrain

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.models import vgg as tvgg
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


# -- Transformer, LeNet, VGG and ResNet's head under dp and tp ------

MODEL_MESHES = [dict(dp=2), dict(tp=2), dict(dp=2, tp=2)]


def _j(np_params):
    return {k: jnp.asarray(v) for k, v in np_params.items()}


def _jax_grads(loss, np_params):
    """The JAX package's one-device loss and gradients (x64 off, as its
    mesh runs need)."""
    with jax.enable_x64(False):
        jloss, jgrads = jax.jit(jax.value_and_grad(loss))(_j(np_params))
    return float(jloss), {k: np.asarray(v) for k, v in jgrads.items()}


def _jax_mesh_loss(loss, np_params, axes, mesh_axes, rules=None,
                   has_aux=False):
    """The step-0 loss of the JAX package's `make_train_step` on its
    mesh, params placed by their `init` axes under `rules`."""
    with jax.enable_x64(False):
        mesh = _jmesh(**mesh_axes)
        with jmesh_guard(mesh):
            init, step = jtrain.make_train_step(
                lambda p, b, r: loss(p), optax.sgd(0.1), mesh, axes,
                rules=rules, has_aux=has_aux)
            return float(step(init(_j(np_params)), {"i": jnp.zeros(4)},
                              jax.random.key(0))[1])


def _port_under(loss, np_params, mesh_axes, rules=None, axes=None):
    """The port's loss and params under the mesh (and `rules`); with
    `axes`, also the step-0 loss of its `make_train_step` there."""
    from paddle_tpu_torch.parallel import sharding as tsh

    tparams = params_from_numpy(np_params, "cpu")
    for v in tparams.values():
        v.requires_grad_()
    rules = rules or tsh.DEFAULT_RULES
    with tmesh.mesh_guard(_tmesh(**mesh_axes)), tsh.with_rules(rules):
        tloss = loss(tparams)
    if axes is None:
        return tparams, tloss, None
    init, step = ttrain.make_train_step(
        lambda p, b, g: loss(p), lambda ps: torch.optim.SGD(ps, lr=0.1),
        device="cpu", mesh=_tmesh(**mesh_axes), param_axes=axes,
        rules=rules, has_aux=isinstance(tloss, tuple))
    step_loss = step(init(params_from_numpy(np_params, "cpu")),
                     {"i": torch.zeros(4)}, 0)[1].item()
    return tparams, tloss, step_loss


def _tr():
    jcfg, tcfg = jtr.TransformerConfig.tiny(), ttr.TransformerConfig.tiny()
    jcfg.dtype = tcfg.dtype = "float32"
    jparams, axes = jtr.init(jax.random.key(21), jcfg)
    return jcfg, tcfg, {k: np.asarray(v) for k, v in jparams.items()}, axes


def _tr_batch(tcfg, bs=4, seed=21):
    tb = ttr.make_batch(np.random.RandomState(seed), tcfg, bs, 16, 12,
                        device="cpu")
    return tb, {k: jnp.asarray(v.numpy().astype(np.int32))
                for k, v in tb.items()}


@pytest.mark.parametrize("mesh", MODEL_MESHES,
                         ids=lambda m: "-".join(f"{k}{v}"
                                                for k, v in m.items()))
def test_transformer_matches_the_jax_package(mesh):
    """Transformer-tiny (2 + 2 layers) at f32 on a ragged 4 x (16, 12)
    batch under dp2, tp2 and dp2 tp2: the loss within 1e-5 relative and
    every gradient within 1e-4 of its largest value of the JAX
    package's one-device step (`_check_model`); the JAX package's mesh
    step is no gradient oracle (ROADMAP F7): its loss within 2e-2, as
    its own tests hold it, and the port's `make_train_step` loss there
    within 1e-6 of the port's own under the mesh. Every attention call
    runs per (dp, tp) rank: the masked ones split the mask with the
    rows."""
    jcfg, tcfg, np_params, axes = _tr()
    tb, jb = _tr_batch(tcfg)
    oloss, ograds = _jax_grads(lambda p: jtr.nmt_loss(p, jcfg, jb),
                               np_params)
    calls = []
    real = tattn._per_rank

    def spy(fn, q, k, v, mask=None):
        calls.append(mask is not None)
        return real(fn, q, k, v, mask)

    tattn._per_rank = spy
    try:
        tparams, tloss, step_loss = _port_under(
            lambda p: ttr.nmt_loss(p, tcfg, tb), np_params, mesh, axes=axes)
    finally:
        tattn._per_rank = real
    # the encoder's and the decoder's cross-attention calls (masked) per
    # rank; the causal self-attention's T 12 takes no shardmap route
    assert calls.count(True) >= jcfg.enc_layers + jcfg.dec_layers, calls
    _check_model(oloss, ograds, tparams, tloss)
    assert abs(step_loss - tloss.item()) <= 1e-6 * abs(tloss.item())
    want = _jax_mesh_loss(lambda p: jtr.nmt_loss(p, jcfg, jb), np_params,
                          axes, mesh)
    assert abs(tloss.item() - want) <= 2e-2 * abs(want)


def test_transformer_loss_divides_by_the_global_count():
    """`nmt_loss` under dp divides the ranks' summed token losses by the
    global count of valid target tokens: the first dp shard's rows hold
    11 valid tokens each and the second's 1, so the mean of the ranks'
    own means is another loss. Under dp2 and dp2 tp2 the loss equals
    the port's one-device loss within 1e-6 relative and the JAX
    package's one-device loss within 1e-5; the ranks' mean of means is
    off by more than 1e-3 relative."""
    jcfg, tcfg, np_params, _ = _tr()
    tb, _ = _tr_batch(tcfg)
    tb["tgt_len"] = torch.tensor([12, 12, 2, 2])
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}
    tparams = params_from_numpy(np_params, "cpu")
    single = ttr.nmt_loss(tparams, tcfg, tb).item()
    with jax.enable_x64(False):
        want = float(jax.jit(lambda p: jtr.nmt_loss(p, jcfg, jb))(
            _j(np_params)))
    for mesh in (dict(dp=2), dict(dp=2, tp=2)):
        with tmesh.mesh_guard(_tmesh(**mesh)):
            got = ttr.nmt_loss(tparams, tcfg, tb).item()
        assert abs(got - single) <= 1e-6 * abs(single), (mesh, got, single)
        assert abs(got - want) <= 1e-5 * abs(want), (mesh, got, want)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in tb.items()}
              for i in range(2)]
    wrong = np.mean([ttr.nmt_loss(tparams, tcfg, h).item() for h in halves])
    assert abs(wrong - want) > 1e-3 * abs(want), (wrong, want)


def test_transformer_beam_and_greedy_under_dp2_tp2():
    """`beam_search` (2 sources, beam 2, 8 steps) and `greedy_decode`
    under dp2 tp2 give the tokens of the port with no mesh and of the
    JAX package's one-device run, the scores within 1e-5 relative; a
    batch of sources that dp does not divide raises."""
    jcfg, tcfg, np_params, _ = _tr()
    tb, jb = _tr_batch(tcfg, bs=2, seed=5)
    tparams = params_from_numpy(np_params, "cpu")
    src, sl = tb["src_ids"], tb["src_len"]
    with torch.no_grad():
        want_t, want_s = ttr.beam_search(tparams, tcfg, src, sl, beam_size=2,
                                         max_len=8)
        want_g = ttr.greedy_decode(tparams, tcfg, src, sl, max_len=8)
        with tmesh.mesh_guard(_tmesh(dp=2, tp=2)):
            got_t, got_s = ttr.beam_search(tparams, tcfg, src, sl,
                                           beam_size=2, max_len=8)
            got_g = ttr.greedy_decode(tparams, tcfg, src, sl, max_len=8)
            with pytest.raises(ValueError,
                               match="does not split over mesh axis 'dp'"):
                ttr.greedy_decode(tparams, tcfg, src[:1], sl[:1],
                                  max_len=8)
    with jax.enable_x64(False):
        jt, js = jtr.beam_search(_j(np_params), jcfg, jb["src_ids"],
                                 jb["src_len"], beam_size=2, max_len=8)
        jg = jtr.greedy_decode(_j(np_params), jcfg, jb["src_ids"],
                               jb["src_len"], max_len=8)
    assert torch.equal(got_t, want_t) and torch.equal(got_g, want_g)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(jg))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), rtol=1e-5)


def test_lenet_dp2_tp2_matches_the_jax_package():
    """LeNet under dp2 tp2 on 4 MNIST-shaped images: fc1 column-parallel
    (its 500 outputs over tp), fc2 whole, the loss the global batch's
    mean; the loss and every gradient against the JAX package's
    one-device step at `_check_model`'s limits, its mesh step's loss
    within 2e-2, the port's `make_train_step` loss within 1e-6."""
    jparams, axes = jlenet.init(jax.random.key(22))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    rng = np.random.RandomState(22)
    img = rng.standard_normal((4, 1, 28, 28)).astype(np.float32)
    label = rng.randint(0, 10, 4)
    tb = {"img": torch.from_numpy(img), "label": torch.from_numpy(label)}
    jb = {"img": jnp.asarray(img), "label": jnp.asarray(label, jnp.int32)}
    oloss, ograds = _jax_grads(lambda p: jlenet.loss_fn(p, jb), np_params)
    mesh = dict(dp=2, tp=2)
    tparams, tloss, step_loss = _port_under(
        lambda p: tlenet.loss_fn(p, tb), np_params, mesh, axes=axes)
    _check_model(oloss, ograds, tparams, tloss)
    assert abs(step_loss - tloss.item()) <= 1e-6 * abs(tloss.item())
    want = _jax_mesh_loss(lambda p: jlenet.loss_fn(p, jb), np_params, axes,
                          mesh)
    assert abs(tloss.item() - want) <= 2e-2 * abs(want)


def test_resnet_head_under_tp2_matches_the_jax_package():
    """ResNet-tiny at f64 activations (the head and its log-softmax f32
    by design) on 4 x 32^2 under tp2: the head column-parallel over the
    classes, the log-softmax over the class ranks; the loss within 1e-6
    relative of the port's no-mesh loss and within 1e-5 of the JAX
    package's one-device loss, every gradient within 1e-4 of its
    largest value of the JAX package's (`_check_model`), the JAX
    package's tp2 step's loss within 2e-2."""
    jcfg = dataclasses.replace(jres.ResNetConfig.tiny(), dtype="float64")
    tcfg = tres.ResNetConfig(**vars(jcfg))
    jparams, axes = jres.init(jax.random.key(23), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tb = tres.make_batch(np.random.RandomState(23), tcfg, 4, hw=32,
                         device="cpu")
    tb["img"] = tb["img"].double()
    jb = {"img": jnp.asarray(tb["img"].numpy()),
          "label": jnp.asarray(tb["label"].numpy().astype(np.int32))}
    oloss, ograds = jax.jit(jax.value_and_grad(
        lambda p: jres.loss_fn(p, jcfg, jb)[0]))(_j(np_params))
    ograds = {k: np.asarray(v) for k, v in ograds.items()}
    tparams, (tloss, _), step_loss = _port_under(
        lambda p: tres.loss_fn(p, tcfg, tb), np_params, dict(tp=2),
        axes=axes)
    single = tres.loss_fn(params_from_numpy(np_params, "cpu"), tcfg,
                          tb)[0].item()
    assert abs(tloss.item() - single) <= 1e-6 * abs(single)
    assert abs(step_loss - tloss.item()) <= 1e-6 * abs(tloss.item())
    _check_model(float(oloss), ograds, tparams, tloss)
    mesh = _jmesh(tp=2)
    with jmesh_guard(mesh):
        init, step = jtrain.make_train_step(
            lambda p, b, r: jres.loss_fn(p, jcfg, b, r), optax.sgd(0.1),
            mesh, axes, has_aux=True)
        want = float(step(init(_j(np_params)), jb, jax.random.key(0))[1])
    assert abs(tloss.item() - want) <= 2e-2 * abs(want)


def _vgg_loss(mod, cfg, img, label):
    """The mean softmax cross-entropy of VGG's logits (VGG has no loss
    of its own), in `mod`'s package."""
    if mod is tvgg:
        return lambda p: -tres.dp_mean(torch.log_softmax(
            tvgg.apply(p, cfg, img), -1).gather(1, label[:, None]))
    return lambda p: -jnp.take_along_axis(jax.nn.log_softmax(
        jvgg.apply(p, cfg, img)), label[:, None], 1).mean()


def _vgg():
    jcfg = dataclasses.replace(jvgg.VGGConfig.tiny(), dtype="float32")
    tcfg = tvgg.VGGConfig(**vars(jcfg))
    jparams, axes = jvgg.init(jax.random.key(24), jcfg)
    rng = np.random.RandomState(24)
    img = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    label = rng.randint(0, 10, 4)
    return (jcfg, tcfg, {k: np.asarray(v) for k, v in jparams.items()}, axes,
            (jnp.asarray(img), jnp.asarray(label, jnp.int32)),
            (torch.from_numpy(img), torch.from_numpy(label)))


def test_vgg_dp2_tp2_with_mlp_whole_matches_the_jax_package():
    """VGG-tiny at f32 under dp2 tp2 with "mlp" mapped to None: fc1 and
    fc2 whole, the head column-parallel over the classes on its f32
    input; the loss and every gradient against the JAX package's
    one-device step (`_check_model`), the JAX package's
    `make_train_step` under the same rules and mesh within 2e-2, the
    port's within 1e-6 of its own loss."""
    from paddle_tpu.parallel.sharding import DEFAULT_RULES as JRULES
    from paddle_tpu_torch.parallel import sharding as tsh

    jcfg, tcfg, np_params, axes, jb, tb = _vgg()
    oloss, ograds = _jax_grads(_vgg_loss(jvgg, jcfg, *jb), np_params)
    mesh = dict(dp=2, tp=2)
    tparams, tloss, step_loss = _port_under(
        _vgg_loss(tvgg, tcfg, *tb), np_params, mesh,
        rules=tsh.DEFAULT_RULES.updated(mlp=None), axes=axes)
    _check_model(oloss, ograds, tparams, tloss)
    assert abs(step_loss - tloss.item()) <= 1e-6 * abs(tloss.item())
    want = _jax_mesh_loss(_vgg_loss(jvgg, jcfg, *jb), np_params, axes, mesh,
                          rules=JRULES.updated(mlp=None))
    assert abs(tloss.item() - want) <= 2e-2 * abs(want)


def test_vgg_under_the_default_rules_refuses_as_the_jax_package():
    """ROADMAP F14: under `MeshConfig(dp=2)` and the default rules VGG's
    fc2.w ("mlp", "mlp") maps "tp" onto both dims. The JAX package's
    `make_train_step` raises DuplicateSpecError and the port's
    `make_train_step` (and a bare forward under the mesh) raises
    ValueError, each naming "tp". A split dim its ring does not divide
    raises in both too: LeNet's fc1 (500 outputs) over tp=8."""
    jcfg, tcfg, np_params, axes, jb, tb = _vgg()
    with jax.enable_x64(False), pytest.raises(Exception) as e:
        mesh = _jmesh(dp=2)
        with jmesh_guard(mesh):
            jtrain.make_train_step(lambda p, b, r: 0.0, optax.sgd(0.1),
                                   mesh, axes)
    assert type(e.value).__name__ == "DuplicateSpecError"
    assert "tp" in str(e.value)
    with pytest.raises(ValueError, match="fc2.w.*'mlp', 'mlp'.*'tp'"):
        ttrain.make_train_step(lambda p, b, g: 0.0,
                               lambda ps: torch.optim.SGD(ps, lr=0.1),
                               device="cpu", mesh=_tmesh(dp=2),
                               param_axes=axes)
    with tmesh.mesh_guard(_tmesh(dp=2)), pytest.raises(ValueError,
                                                       match="'tp'"):
        _vgg_loss(tvgg, tcfg, *tb)(params_from_numpy(np_params, "cpu"))
    jparams, laxes = jlenet.init(jax.random.key(22))
    with jax.enable_x64(False), pytest.raises(ValueError):
        mesh = _jmesh(tp=8)
        with jmesh_guard(mesh):
            jtrain.make_train_step(lambda p, b, r: 0.0, optax.sgd(0.1),
                                   mesh, laxes)[0](jparams)
    init, _ = ttrain.make_train_step(
        lambda p, b, g: 0.0, lambda ps: torch.optim.SGD(ps, lr=0.1),
        device="cpu", mesh=_tmesh(tp=8), param_axes=laxes)
    tl = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                           "cpu")
    with pytest.raises(ValueError, match="500"):
        init(tl)
    with tmesh.mesh_guard(_tmesh(tp=8)), pytest.raises(
            ValueError, match="fc1.w, of size 500"):
        tlenet.apply(tl, torch.zeros(8, 1, 28, 28))


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
    manual region. A masked call under dp and tp runs per (dp, tp)
    rank on its rows and heads, the mask split with the rows, equal to
    the no-mesh call."""
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


@pytest.mark.parametrize("what", ["fluid", "apply_prefill",
                                  "apply_decode_step", "apply_prefill_chunk",
                                  "apply_verify_step"])
def test_models_outside_the_slice_refuse_dp_and_tp(what):
    """The fluid Executor and GPT's four decode paths raise under dp,
    saying why, rather than compute replicated: the Executor runs one
    rank (ROADMAP item 20c-iii), and the JAX package's serving path runs
    on no mesh, so the decode paths have no split to port."""
    import paddle_tpu_torch as fluid

    if what == "fluid":
        fn, why = (lambda: fluid.Executor(fluid.CPUPlace()).run(
            fluid.Program())), "item 20c-iii"
    else:
        # the decode paths' positional args after cfg, as test_torch_moe's
        n_args = 6 if what == "apply_prefill_chunk" else 5
        fn, why = (lambda: getattr(tgpt, what)(
            None, tgpt.GPTConfig.tiny(), *[None] * n_args, block_size=8,
            eos_id=0)), "serving path.*runs on no mesh"
    with tmesh.mesh_guard(_tmesh(dp=2)):
        with pytest.raises(NotImplementedError, match=why):
            fn()


@pytest.mark.parametrize("model", ["bert", "gpt", "transformer", "vgg",
                                   "lenet", "resnet"])
def test_split_axes_are_inits(model):
    """Every weight a helper splits carries, in `init`'s axes, the
    axes the model's ops hand the helper (`SPLIT_AXES`; a GPT block's
    after its stacked "layer" axis), and `init`'s axes are the JAX
    package's."""
    g = torch.Generator()
    if model == "bert":
        _, axes = tbert.init(g, tbert.BertConfig.tiny(), device="cpu")
        want = {k: v for k, v in axes.items()
                if k.endswith(".w") and k[:-2] != "embeddings.position"
                and k[:-2] != "embeddings.type"}
        assert {k: tbert._axes(k[:-2]) for k in want} == want
    elif model == "gpt":
        _, axes = tgpt.init(g, tgpt.GPTConfig.tiny(), device="cpu")
        for k, v in tgpt.SPLIT_AXES.items():
            assert axes[k] == (v if k == "wte.w" else ("layer",) + v), k
    elif model == "transformer":
        _, axes = ttr.init(g, ttr.TransformerConfig.tiny(), device="cpu")
        want = {k: v for k, v in axes.items()
                if k.endswith(".w") and k != "pos.w"}
        assert {k: ttr._axes(k[:-2]) for k in want} == want
        assert len(want) == 2 + 4 * 2 + 8 * 2 + 2 * 4
        assert axes == jtr.init(jax.random.key(0),
                                jtr.TransformerConfig.tiny())[1]
    else:
        mod, jmod, args = {
            "vgg": (tvgg, jvgg, (tvgg.VGGConfig.tiny(),)),
            "lenet": (tlenet, jlenet, ()),
            "resnet": (tres, jres, (tres.ResNetConfig.tiny(),))}[model]
        _, axes = mod.init(g, *args, device="cpu")
        assert {k: axes[k + ".w"] for k in mod.SPLIT_AXES} == mod.SPLIT_AXES
        jargs = {"vgg": (jvgg.VGGConfig.tiny(),), "lenet": (),
                 "resnet": (jres.ResNetConfig.tiny(),)}[model]
        assert axes == jmod.init(jax.random.key(0), *jargs)[1]


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
