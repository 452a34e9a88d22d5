"""The port's mesh and logical-axis rules against the JAX package's:
`MeshConfig.resolve` on a table of cases (the same sizes, or both
raising ValueError), `AXIS_ORDER` and `DEFAULT_RULES` equal to the JAX
package's (the copied table has not drifted), `LogicalRules.spec`,
`logical_to_mesh` and `shard_params_spec` equal to the JAX package's
specs, and what `make_mesh` builds and refuses: in-process rings for
every axis (dp and tp beside pp, ep and sp) only from a repeated device
list, none without one or a process group, NotImplementedError on any
axis but sp over processes (dp and tp naming item 20a);
`make_hybrid_mesh`, `resize_mesh`, `auto_mesh` and `get_mesh`; the
rings' all-reduce and all-gather in-process and over gloo processes;
and a ZeRO-1 TrainState saved and restored at dp=2 whose resumed run
equals the uninterrupted one bit for bit."""

import numpy as np
import pytest
import torch

from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import sharding as jsharding

from paddle_tpu_torch.ops import attention as ta
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import sharding as tsharding
from paddle_tpu_torch.core.ring import InProcessRing, check_backend

CPU = torch.device("cpu")

# (config kwargs, n_devices)
RESOLVE_CASES = [
    ({}, 1), ({}, 8), ({"sp": 4}, 4), ({"sp": 4}, 8), ({"sp": 4}, 1),
    ({"sp": 3}, 8), ({"dp": 2, "sp": 2, "tp": 2}, 8),
    ({"dp": 2, "sp": 2}, 8), ({"dp": 1, "sp": 4}, 4), ({"dp": 1, "sp": 2}, 4),
    ({"dp": -1, "tp": -1}, 4), ({"pp": 2, "dp": -1, "ep": 2}, 8),
    ({"dp": 1}, 1), ({"dp": 2, "tp": 2, "sp": 2, "pp": 1, "ep": 1}, 8),
]


@pytest.mark.parametrize("kw,n", RESOLVE_CASES)
def test_resolve_matches_the_jax_package(kw, n):
    try:
        want = jmesh.MeshConfig(**kw).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.MeshConfig(**kw).resolve(n)
        assert str(got.value) == str(e)
        return
    assert tmesh.MeshConfig(**kw).resolve(n) == want


def test_axis_order_and_default_rules_match_the_jax_package():
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tsharding.DEFAULT_RULES._rules == jsharding.DEFAULT_RULES._rules
    for logical in list(jsharding.DEFAULT_RULES._rules) + [None, "nope"]:
        assert tsharding.DEFAULT_RULES.mesh_axis(logical) == \
            jsharding.DEFAULT_RULES.mesh_axis(logical)


def test_rules_stack_and_updated():
    custom = tsharding.DEFAULT_RULES.updated(seq="tp")
    assert tsharding.DEFAULT_RULES.mesh_axis("seq") == "sp"
    assert tsharding.current_rules() is tsharding.DEFAULT_RULES
    with tsharding.with_rules(custom):
        assert tsharding.current_rules().mesh_axis("seq") == "tp"
        assert tsharding.current_rules().mesh_axis("batch") == "dp"
    assert tsharding.current_rules() is tsharding.DEFAULT_RULES


def test_in_process_ring_from_a_repeated_device_list():
    m = tmesh.make_mesh(tmesh.MeshConfig(sp=4), devices=[CPU] * 4)
    assert m.shape == {"pp": 1, "dp": 1, "ep": 1, "sp": 4, "tp": 1}
    assert m.devices == (CPU,) * 4
    ring = m.rings["sp"]
    assert isinstance(ring, InProcessRing) and ring.size == 4
    assert list(m.rings) == ["sp"]
    # sp=1: a one-device mesh without rings
    one = tmesh.make_mesh(tmesh.MeshConfig(), devices=[CPU])
    assert one.devices == (CPU,) and one.rings == {}


def test_make_mesh_emulates_no_ring_and_raises():
    # no device list and no process group: one device, as resolve says
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.make_mesh(tmesh.MeshConfig(sp=4))
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.make_mesh(tmesh.MeshConfig(dp=1, sp=4), devices=[CPU] * 2)
    # dp and tp make in-process rings as sp does
    for cfg, rings in ((tmesh.MeshConfig(dp=2, sp=2), {"dp": 2, "sp": 2}),
                       (tmesh.MeshConfig(tp=2), {"dp": 2, "tp": 2}),
                       (tmesh.MeshConfig(dp=1, tp=2, sp=2),
                        {"tp": 2, "sp": 2})):
        m = tmesh.make_mesh(cfg, devices=[CPU] * 4)
        assert {a: r.size for a, r in m.rings.items()} == rings
    m = tmesh.make_mesh(tmesh.MeshConfig(), devices=[CPU] * 2)  # dp=2
    assert m.shape["dp"] == 2 and list(m.rings) == ["dp"]
    with pytest.raises(ValueError, match="one device"):
        tmesh.make_mesh(tmesh.MeshConfig(sp=2),
                        devices=[CPU, torch.device("meta")])


@pytest.mark.parametrize("kw,rings", [
    (dict(pp=2, ep=2), {"pp": 2, "ep": 2}),
    (dict(pp=2, ep=2, sp=2), {"pp": 2, "ep": 2, "sp": 2}),
    (dict(pp=4), {"pp": 4}), (dict(ep=4), {"ep": 4})])
def test_in_process_rings_for_pp_and_ep(kw, rings):
    n = 1
    for v in kw.values():
        n *= v
    m = tmesh.make_mesh(tmesh.MeshConfig(dp=1, **kw), devices=[CPU] * n)
    assert m.shape == {**{a: 1 for a in tmesh.AXIS_ORDER}, **kw}
    assert {a: r.size for a, r in m.rings.items()} == rings
    assert all(isinstance(r, InProcessRing) for r in m.rings.values())
    m = tmesh.make_mesh(tmesh.MeshConfig(dp=2, **kw), devices=[CPU] * 2 * n)
    assert {a: r.size for a, r in m.rings.items()} == {**rings, "dp": 2}


@pytest.mark.parametrize("kw,item", [
    (dict(pp=2, sp=2), "20a and 20e"), (dict(ep=2, sp=2), "20a and 20e"),
    (dict(tp=2, sp=2), "20a"), (dict(pp=4), "20a and 20e"),
    (dict(dp=2, sp=2), "20a"), (dict(dp=4), "20a")])
def test_process_mesh_takes_sp_only(monkeypatch, kw, item):
    """Under a process group of 4 ranks, pp and ep raise naming items
    20a and 20e, dp and tp item 20a (the process ring that lifts their
    reductions), before any ring is made."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tmesh.make_mesh(tmesh.MeshConfig(**{"dp": 1, **kw}))


def test_mesh_guard_nests_and_pops_on_error():
    a = tmesh.make_mesh(tmesh.MeshConfig(sp=2), devices=[CPU] * 2)
    b = tmesh.make_mesh(tmesh.MeshConfig(sp=4), devices=[CPU] * 4)
    assert tmesh.current_mesh() is None
    with tmesh.mesh_guard(a):
        assert tmesh.current_mesh() is a
        with pytest.raises(KeyError):
            with tmesh.mesh_guard(b):
                assert tmesh.current_mesh() is b
                raise KeyError("x")
        assert tmesh.current_mesh() is a
    assert tmesh.current_mesh() is None


def test_in_process_ring_hop_is_ppermute_plus_one():
    ring = InProcessRing(4)
    xs = ring.split(torch.arange(8.0)[None], 1)
    assert [x.tolist() for x in xs] == [[[0, 1]], [[2, 3]], [[4, 5]], [[6, 7]]]
    (moved,) = ring.hop(xs)
    # perm [(i, i + 1)]: rank r now holds rank r - 1's shard
    assert [m[0, 0].item() for m in moved] == [6, 0, 2, 4]
    assert torch.equal(ring.join(moved, 1), torch.tensor([[6., 7, 0, 1, 2, 3,
                                                          4, 5]]))
    with pytest.raises(ValueError, match="does not split"):
        ring.split(torch.zeros(1, 6), 1)


@pytest.mark.parametrize("n,S,sizes", [(3, 2, [2, 1]), (1, 2, [1, 0]),
                                        (5, 4, [2, 1, 1, 1]),
                                        (4, 2, [2, 2])])
def test_in_process_ring_splits_unevenly_on_request(n, S, sizes):
    """`even=False` cuts as `torch.tensor_split` (the experts over ep);
    `join` puts the shards back."""
    ring = InProcessRing(S)
    x = torch.arange(float(n))[:, None]
    xs = ring.split(x, 0, even=False)
    assert [len(t) for t in xs] == sizes
    assert torch.equal(ring.join(xs, 0), x)


def test_backend_that_cannot_carry_the_device_raises():
    check_backend("gloo", CPU)
    check_backend("nccl", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="gloo process group cannot carry "
                                         "cuda"):
        check_backend("gloo", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="nccl process group cannot carry "
                                         "cpu"):
        check_backend("nccl", CPU)


def test_mha_without_sp_ignores_a_one_device_mesh():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 128, 2, 64, generator=g) for _ in range(3))
    ta.GATE_COUNTS.clear()
    with tmesh.mesh_guard(tmesh.make_mesh(tmesh.MeshConfig(),
                                          devices=[CPU])):
        out = ta.mha(q, k, v)
    assert dict(ta.GATE_COUNTS) == {"plain": 1}
    assert torch.equal(out, ta.mha(q, k, v))


@pytest.mark.parametrize("kw,n", [
    (dict(dp=2, tp=2), 4), (dict(pp=2, tp=2, dp=2), 8),
    (dict(dp=2, tp=2, sp=2), 8), (dict(dp=4), 4), (dict(tp=4, dp=1), 4)])
def test_dp_and_tp_rings_in_process(kw, n):
    """dp and tp make in-process rings, alone and beside pp and sp; the
    shape resolves as the JAX package's."""
    m = tmesh.make_mesh(tmesh.MeshConfig(**kw), devices=[CPU] * n)
    assert m.shape == jmesh.MeshConfig(**kw).resolve(n)
    assert m.devices == (CPU,) * n
    assert {a: r.size for a, r in m.rings.items()} == \
        {a: s for a, s in m.shape.items() if s > 1}
    assert all(isinstance(r, InProcessRing) for r in m.rings.values())


def test_make_hybrid_mesh_is_make_mesh_in_one_process(monkeypatch):
    import torch.distributed as dist

    m = tmesh.make_hybrid_mesh(tmesh.MeshConfig(dp=2, tp=2),
                               devices=[CPU] * 4)
    assert m.shape == tmesh.make_mesh(tmesh.MeshConfig(dp=2, tp=2),
                                      devices=[CPU] * 4).shape
    assert tmesh.make_hybrid_mesh(devices=[CPU] * 2, dp=2).shape["dp"] == 2
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    with pytest.raises(NotImplementedError, match="item 20a"):
        tmesh.make_hybrid_mesh(tmesh.MeshConfig(dp=4))


def test_resize_mesh_absorbs_into_dp_and_refuses():
    """As the JAX package's: every axis keeps its size but `absorb`;
    fixed axes that do not divide the new world, a bad axis, too few
    devices and a process mesh are refused."""
    m = tmesh.make_mesh(tmesh.MeshConfig(dp=2, tp=2), devices=[CPU] * 4)
    big = tmesh.resize_mesh(m, 8)
    assert (big.shape["dp"], big.shape["tp"]) == (4, 2)
    assert {a: r.size for a, r in big.rings.items()} == {"dp": 4, "tp": 2}
    small = tmesh.resize_mesh(m, 2)
    assert (small.shape["dp"], small.shape["tp"]) == (1, 2)
    assert tmesh.resize_mesh(m, 8, absorb="tp").shape["tp"] == 4
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.resize_mesh(m, 3)
    with pytest.raises(ValueError, match="absorb axis"):
        tmesh.resize_mesh(m, 4, absorb="zz")
    with pytest.raises(ValueError, match="cannot resize"):
        tmesh.resize_mesh(m, 0)
    with pytest.raises(ValueError, match="only 2"):
        tmesh.resize_mesh(m, 4, devices=[CPU] * 2)
    proc = tmesh.Mesh({**m.shape}, (CPU,), {})
    with pytest.raises(NotImplementedError, match="item 20e"):
        tmesh.resize_mesh(proc, 8)


def test_auto_mesh_and_get_mesh(monkeypatch):
    m = tmesh.auto_mesh(4, model_parallel=2, device="cpu")
    assert (m.shape["dp"], m.shape["tp"]) == (2, 2)
    assert tmesh.auto_mesh(device="cpu").shape == \
        tmesh.MeshConfig().resolve(1)
    with tmesh.mesh_guard(m):
        assert tmesh.get_mesh() is m
    made = tmesh.make_mesh(tmesh.MeshConfig(), devices=[CPU] * 2)
    monkeypatch.setattr(tmesh, "auto_mesh", lambda: made)
    try:
        assert tmesh.get_mesh() is made      # made current, as there
        assert tmesh.current_mesh() is made
        assert tmesh.get_mesh() is made
    finally:
        tmesh._mesh_stack.remove(made)
    assert tmesh.current_mesh() is None


AXES = [("batch", "seq"), ("vocab", "embed"), ("embed", "heads"),
        ("layer", "embed", "mlp"), ("expert", "embed", "mlp"), (None,),
        ("stage", "conv_out"), ("nope", "kv")]


@pytest.mark.parametrize("axes", AXES)
def test_specs_match_the_jax_package(axes):
    custom = {"heads": None, "embed": "tp"}
    for jr, tr in ((None, None),
                   (jsharding.DEFAULT_RULES.updated(**custom),
                    tsharding.DEFAULT_RULES.updated(**custom))):
        want = jsharding.logical_to_mesh(axes, jr)
        got = tsharding.logical_to_mesh(axes, tr)
        assert tuple(got) == tuple(want)
        assert isinstance(got, tsharding.PartitionSpec)
        assert tuple((tr or tsharding.DEFAULT_RULES).spec(axes)) == \
            tuple((jr or jsharding.DEFAULT_RULES).spec(axes))
    pa = {f"p{i}": a for i, a in enumerate(AXES)}
    assert {k: tuple(v) for k, v in tsharding.shard_params_spec(pa).items()} \
        == {k: tuple(v) for k, v in jsharding.shard_params_spec(pa).items()}


def test_shard_checks_and_named_sharding_tree():
    x = torch.zeros(4, 6)
    assert tsharding.shard(x, ("batch", "heads")) is x     # no mesh
    m = tmesh.make_mesh(tmesh.MeshConfig(dp=2, tp=4), devices=[CPU] * 8)
    with tmesh.mesh_guard(m):
        with pytest.raises(ValueError, match=r"dim 1 \('heads'\) of size 6"):
            tsharding.shard(x, ("batch", "heads"))
        assert tsharding.shard(x, ("batch", None)) is x
        with tsharding.manual_region():
            assert tsharding.shard(x, ("batch", "heads")) is x
    P = tsharding.PartitionSpec
    tree = tsharding.named_sharding_tree(
        m, {"a": P("dp"), "b": [P(None, "tp"), P()], "c": 3})
    assert tree["a"] == tsharding.NamedSharding(m, P("dp"))
    assert tree["b"][1].spec == () and tree["c"] == 3
    assert repr(P("dp", None)) == "PartitionSpec('dp', None)"


def test_in_process_all_reduce_and_all_gather_with_autograd():
    ring = InProcessRing(3)
    xs = [torch.tensor([1.0, -2.0]) * (r + 1) for r in range(3)]
    for x in xs:
        x.requires_grad_()
    out = ring.all_reduce(xs)
    assert len(out) == 3 and all(o is out[0] for o in out)
    assert out[0].tolist() == [6.0, -12.0]
    assert ring.all_reduce(xs, "max")[0].tolist() == [3.0, -2.0]
    # every rank's use of the sum sends its gradient to every input
    gs = torch.autograd.grad(sum((o * (r + 1)).sum() for r, o in
                                 enumerate(out)), xs)
    assert all(g.tolist() == [6.0, 6.0] for g in gs)
    gathered = ring.all_gather([x.detach()[None] for x in xs], 0)
    assert gathered[0].shape == (3, 2) and gathered[2] is gathered[0]
    with pytest.raises(ValueError, match="sum or max"):
        ring.all_reduce(xs, "min")
    with pytest.raises(ValueError, match="2 tensors for a ring of 3"):
        ring.all_reduce(xs[:2])


_REDUCE_WORKER = r"""
import sys
import torch
import torch.distributed as dist

rank, world, rdv, _, out_path = sys.argv[1:]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + rdv,
                        world_size=world, rank=rank)
try:
    from paddle_tpu_torch.core.ring import ProcessRing

    ring = ProcessRing(None, world, rank)
    x = (torch.arange(4.0) * (rank + 1)).requires_grad_()
    s = ring.all_reduce([x])[0]
    m = ring.all_reduce([x.detach()], "max")[0]
    g = ring.all_gather([x[None]], 0)[0]
    (dx,) = torch.autograd.grad((s * (rank + 1)).sum() + (g * g).sum(), x)
    torch.save({"sum": s.detach(), "max": m, "gather": g.detach(),
                "dx": dx}, out_path)
finally:
    dist.destroy_process_group()
"""


def test_process_ring_all_reduce_and_all_gather_over_gloo(tmp_path):
    """Two gloo processes: the sum, the max and the gather equal the
    in-process ring's, and the gradients are the collectives' own (a
    sum's: the ranks' incoming gradients summed; a gather's: this
    rank's slice of the summed gradient)."""
    from test_torch_ring import _spawn_ring

    res = _spawn_ring(tmp_path, 2, worker=_REDUCE_WORKER)
    xs = [torch.arange(4.0) * (r + 1) for r in range(2)]
    ring = InProcessRing(2)
    for r, got in enumerate(res):
        assert torch.equal(got["sum"], ring.all_reduce(xs)[0])
        assert torch.equal(got["max"], ring.all_reduce(xs, "max")[0])
        assert torch.equal(got["gather"], ring.all_gather(
            [x[None] for x in xs], 0)[0])
        # d/dx_r: sum's weights 1 + 2 from both ranks, and each rank's
        # g * g gives 2 x_r, twice (both ranks' gathers hold it)
        assert torch.equal(got["dx"], 3.0 + 4.0 * xs[r])


def test_zero1_train_state_checkpoint_roundtrip(tmp_path):
    """A ZeRO-1 TrainState at dp=2 (BERT-tiny, AdamW) saved through the
    CheckpointManager after 2 steps, restored into a fresh template and
    run 2 more steps, against the uninterrupted 4 steps: losses and
    params bit for bit (deterministic algorithms: the CPU's embedding
    backward otherwise accumulates in a varying order), as
    `test_models_parallel.test_sharded_train_state_checkpoint_roundtrip`
    holds the JAX package's."""
    from paddle_tpu_torch.models import bert as tbert
    from paddle_tpu_torch.parallel import train as ttrain
    from paddle_tpu_torch.resilience.checkpoint_manager import \
        CheckpointManager

    cfg = tbert.BertConfig.tiny()
    cfg.dtype = "float32"
    mesh = tmesh.make_mesh(tmesh.MeshConfig(dp=2), devices=[CPU] * 2)
    batch = tbert.make_batch(np.random.RandomState(1), cfg, 8, 32,
                             device="cpu")

    def fresh(seed):
        params, axes = tbert.init(torch.Generator().manual_seed(seed), cfg,
                                  device="cpu")
        init, step = ttrain.make_train_step(
            lambda p, b, g: tbert.pretrain_loss(p, cfg, b, rng=g,
                                                deterministic=True),
            lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4),
            mesh=mesh, param_axes=axes)
        return init(params), step

    torch.use_deterministic_algorithms(True)
    try:
        state, step = fresh(0)
        assert isinstance(state.opt_state, ttrain.Zero1Optimizer)
        for i in range(2):
            state, _ = step(state, batch, i)
        mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
        mgr.save(state)
        base = [step(state, batch, i)[1].item() for i in (2, 3)]
        restored, step2 = fresh(9)
        restored = mgr.restore_latest(restored)
        assert restored.step == 2
        resumed = [step2(restored, batch, i)[1].item() for i in (2, 3)]
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed == base
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v), k
    sd = restored.opt_state.state_dict()
    assert {k.split("/")[0] for k in sd["state"]} <= {"0", "1", "whole"}
