"""The port's mesh and logical-axis rules against the JAX package's:
`MeshConfig.resolve` on a table of cases (the same sizes, or both
raising ValueError), `AXIS_ORDER` and `DEFAULT_RULES` equal to the JAX
package's (the copied table has not drifted), and what `make_mesh`
builds and refuses: an in-process ring only from a repeated device
list, none without one or a process group, and NotImplementedError on
any axis other than sp that is larger than 1."""

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
                tmesh.MeshConfig(dp=1, pp=2, sp=2)):
        with pytest.raises(NotImplementedError, match="item 20"):
            tmesh.make_mesh(cfg, devices=[CPU] * 4)
    with pytest.raises(NotImplementedError, match="item 20"):
        tmesh.make_mesh(tmesh.MeshConfig(), devices=[CPU] * 2)  # dp=2
    with pytest.raises(ValueError, match="one device"):
        tmesh.make_mesh(tmesh.MeshConfig(sp=2),
                        devices=[CPU, torch.device("meta")])


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
