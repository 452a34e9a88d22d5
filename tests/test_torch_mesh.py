"""The port's mesh and logical-axis rules against the JAX package's:
`MeshConfig.resolve` on a table of cases (the same sizes, or both
raising ValueError), `AXIS_ORDER` and `DEFAULT_RULES` equal to the JAX
package's (the copied table has not drifted), and what `make_mesh`
builds and refuses: in-process rings (pp, ep, sp) only from a repeated
device list, none without one or a process group, NotImplementedError
on dp or tp larger than 1, and on any axis but sp over processes."""

import pytest
import torch

from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import sharding as jsharding

from paddle_tpu_torch.ops import attention as ta
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import sharding as tsharding
from paddle_tpu_torch.parallel.ring import InProcessRing, check_backend

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
    for cfg in (tmesh.MeshConfig(dp=2, sp=2), tmesh.MeshConfig(tp=2),
                tmesh.MeshConfig(dp=1, tp=2, sp=2)):
        with pytest.raises(NotImplementedError, match="item 20"):
            tmesh.make_mesh(cfg, devices=[CPU] * 4)
    with pytest.raises(NotImplementedError, match="item 20"):
        tmesh.make_mesh(tmesh.MeshConfig(), devices=[CPU] * 2)  # dp=2
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
    with pytest.raises(NotImplementedError, match="item 20c"):
        tmesh.make_mesh(tmesh.MeshConfig(dp=2, **kw), devices=[CPU] * 2 * n)


@pytest.mark.parametrize("kw,item", [
    (dict(pp=2, sp=2), "20a and 20e"), (dict(ep=2, sp=2), "20a and 20e"),
    (dict(tp=2, sp=2), "20c"), (dict(pp=4), "20a and 20e")])
def test_process_mesh_takes_sp_only(monkeypatch, kw, item):
    """Under a process group of 4 ranks, pp and ep raise naming items
    20a and 20e, dp and tp item 20c, before any ring is made."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tmesh.make_mesh(tmesh.MeshConfig(dp=1, **kw))


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
