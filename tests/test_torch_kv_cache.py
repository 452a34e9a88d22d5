"""The port's paged KV cache against the JAX package's.

Allocator behaviour is the same state machine; the pool writers and the
gather, fed the same numpy pools and tables, must give exactly the same
values (they only move data).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.serving import kv_cache as jkv

from paddle_tpu_torch.serving import kv_cache as tkv

torch.set_num_threads(2)


def _cfgs(**kw):
    base = dict(layers=2, kv_heads=2, head_dim=4, max_len=32, block_size=8,
                num_blocks=6)
    base.update(kw)
    return jkv.KVCacheConfig(**base), tkv.KVCacheConfig(**base)


def test_block_allocator_units():
    _, cfg = _cfgs()
    al = tkv.BlockAllocator(cfg)
    assert al.free_blocks() == 5          # block 0 reserved (null)
    got = al.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert al.used_blocks() == 3 and al.free_blocks() == 2
    with pytest.raises(tkv.NoBlocksError):  # no partial grant
        al.alloc(3)
    assert al.free_blocks() == 2
    al.free(got[:1])
    assert al.free_blocks() == 3
    with pytest.raises(ValueError):
        al.free(got[:1])                   # double free
    with pytest.raises(ValueError):
        al.free([0])                       # null block
    al2 = tkv.BlockAllocator(cfg)
    al2.alloc(2)
    st = al2.stats(live_tokens=9)
    assert st["allocated_token_capacity"] == 16
    assert st["internal_waste_tokens"] == 7
    assert st["waste_fraction"] == round(7 / 16, 4)
    with pytest.raises(ValueError):
        tkv.BlockAllocator(tkv.KVCacheConfig(
            layers=1, kv_heads=1, head_dim=2, max_len=8, block_size=8,
            num_blocks=1))


def test_allocator_sequence_matches_jax():
    """The same alloc/free sequence hands out the same block ids and
    reports the same stats in both packages."""
    jcfg, tcfg = _cfgs(num_blocks=12)
    ja, ta = jkv.BlockAllocator(jcfg), tkv.BlockAllocator(tcfg)
    seq = [("a", 3), ("a", 2), ("f", 0), ("a", 4), ("f", 1), ("a", 5)]
    held_j, held_t = [], []
    for op, n in seq:
        if op == "a":
            held_j.append(ja.alloc(n))
            held_t.append(ta.alloc(n))
        else:
            ja.free(held_j.pop(n))
            ta.free(held_t.pop(n))
        assert held_j == held_t
        assert ja.free_blocks() == ta.free_blocks()
    assert {k: v for k, v in ja.stats(live_tokens=50).items()
            if k != "pool_bytes"} == \
        {k: v for k, v in ta.stats(live_tokens=50).items()
         if k != "pool_bytes"}
    assert jcfg.pool_bytes() == tcfg.pool_bytes()


def test_build_block_table_bounds():
    np.testing.assert_array_equal(tkv.build_block_table([3, 4], 4),
                                  jkv.build_block_table([3, 4], 4))
    with pytest.raises(ValueError):
        tkv.build_block_table([1, 2, 3], 2)


def test_init_pools_shape_and_dtype():
    _, cfg = _cfgs(dtype="float32")
    kp, vp = tkv.init_pools(cfg, "cpu")
    assert kp.shape == (2, 6, 8, 2, 4) and kp.dtype == torch.float32
    assert not kp.any() and not vp.any()


def test_prefill_write_and_gather_match_jax():
    jcfg, tcfg = _cfgs(layers=1, max_len=16, block_size=4, num_blocks=7,
                       dtype="float32")
    rs = np.random.RandomState(0)
    pool = rs.randn(7, 4, 2, 4).astype(np.float32)
    # a 10-token bucket for a sequence that owns blocks [5, 2, 6]:
    # positions 0..9 land in its blocks, the table tail is the null block
    kv = rs.randn(10, 2, 4).astype(np.float32)
    bt = tkv.build_block_table([5, 2, 6], tcfg.max_blocks_per_seq)
    want = jkv.write_prefill_kv(jnp.asarray(pool), jnp.asarray(kv),
                                jnp.asarray(bt), 4)
    got = torch.from_numpy(pool.copy())
    tkv.write_prefill_kv(got, torch.from_numpy(kv), torch.from_numpy(bt), 4)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    ctx_j = jkv.gather_kv(want, jnp.asarray(bt)[None])
    ctx_t = tkv.gather_kv(got, torch.from_numpy(bt)[None])
    assert ctx_t.shape == (1, 16, 2, 4)
    np.testing.assert_array_equal(np.asarray(ctx_j), ctx_t.numpy())
    np.testing.assert_array_equal(ctx_t.numpy()[0, :10], kv)


def test_token_write_and_gather_match_jax():
    """A decode step's write for 4 slots: two active (one crossing into
    a new block), two inactive with all-zero tables writing the null
    block with identical rows, as the engine's padded slots do."""
    jcfg, tcfg = _cfgs(layers=1, max_len=16, block_size=4, num_blocks=9,
                       dtype="float32")
    rs = np.random.RandomState(1)
    pool = rs.randn(9, 4, 2, 4).astype(np.float32)
    kv = rs.randn(4, 2, 4).astype(np.float32)
    kv[3] = kv[2]
    bts = np.stack([tkv.build_block_table([3, 7], 4),
                    tkv.build_block_table([1, 4, 8], 4),
                    np.zeros(4, np.int32), np.zeros(4, np.int32)])
    positions = np.array([5, 8, 0, 0], np.int32)
    want = jkv.write_token_kv(jnp.asarray(pool), jnp.asarray(kv),
                              jnp.asarray(bts), jnp.asarray(positions), 4)
    got = torch.from_numpy(pool.copy())
    tkv.write_token_kv(got, torch.from_numpy(kv), torch.from_numpy(bts),
                       torch.from_numpy(positions), 4)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(got.numpy()[7, 1], kv[0])
    np.testing.assert_array_equal(got.numpy()[8, 0], kv[1])
    np.testing.assert_array_equal(
        np.asarray(jkv.gather_kv(want, jnp.asarray(bts))),
        tkv.gather_kv(got, torch.from_numpy(bts)).numpy())


def test_bf16_pool_roundtrip_is_exact():
    _, tcfg = _cfgs(layers=1, max_len=16, block_size=4, num_blocks=5)
    kp, _ = tkv.init_pools(tcfg, "cpu")
    assert kp.dtype == torch.bfloat16
    kv = torch.randn(6, 2, 4, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    bt = torch.from_numpy(tkv.build_block_table([1, 2], 4))
    tkv.write_prefill_kv(kp[0], kv, bt, 4)
    assert torch.equal(tkv.gather_kv(kp[0], bt[None])[0, :6], kv)


@pytest.mark.parametrize("start", [0, 9, 13])
def test_chunk_write_matches_jax(start):
    """A C = 6 slice at `start` for a sequence owning blocks [5, 2, 6, 3]
    of a table 4 wide (16 positions): start 13 runs three positions
    past the table, which land in the null block."""
    jcfg, tcfg = _cfgs(layers=1, max_len=16, block_size=4, num_blocks=7,
                       dtype="float32")
    rs = np.random.RandomState(start)
    pool = rs.randn(7, 4, 2, 4).astype(np.float32)
    kv = rs.randn(6, 2, 4).astype(np.float32)
    bt = tkv.build_block_table([5, 2, 6, 3], tcfg.max_blocks_per_seq)
    want = jkv.write_chunk_kv(jnp.asarray(pool), jnp.asarray(kv),
                              jnp.asarray(bt), jnp.int32(start), 4)
    got = torch.from_numpy(pool.copy())
    tkv.write_chunk_kv(got, torch.from_numpy(kv), torch.from_numpy(bt),
                       torch.tensor(start, dtype=torch.int32), 4)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    t = np.arange(6) + start
    inside = t < 16
    blk = np.where(inside, bt[np.minimum(t // 4, 3)], 0)
    np.testing.assert_array_equal(got.numpy()[blk, t % 4], kv)
    if not inside.all():
        assert (blk[~inside] == 0).all()


def test_span_write_matches_jax():
    """Verification's W = 3 spans for 4 slots: one crossing a block
    boundary, one running past the table width (null block), two
    padded with all-zero tables. Several rows land on one null-block
    slot, where which write wins is unspecified in both packages: the
    other blocks must be equal, and left alone but where a span
    lands."""
    jcfg, tcfg = _cfgs(layers=1, max_len=16, block_size=4, num_blocks=9,
                       dtype="float32")
    rs = np.random.RandomState(2)
    pool = rs.randn(9, 4, 2, 4).astype(np.float32)
    kv = rs.randn(4, 3, 2, 4).astype(np.float32)
    bts = np.stack([tkv.build_block_table([3, 7], 4),
                    tkv.build_block_table([1, 4, 8, 5], 4),
                    np.zeros(4, np.int32), np.zeros(4, np.int32)])
    positions = np.array([2, 15, 0, 0], np.int32)
    want = jkv.write_span_kv(jnp.asarray(pool), jnp.asarray(kv),
                             jnp.asarray(bts), jnp.asarray(positions), 4)
    got = torch.from_numpy(pool.copy())
    tkv.write_span_kv(got, torch.from_numpy(kv), torch.from_numpy(bts),
                      torch.from_numpy(positions), 4)
    np.testing.assert_array_equal(np.asarray(want)[1:], got.numpy()[1:])
    touched = np.zeros((9, 4), bool)
    touched[3, 2:] = touched[7, 0] = touched[5, 3] = True
    np.testing.assert_array_equal(got.numpy()[1:][~touched[1:]],
                                  pool[1:][~touched[1:]])
    np.testing.assert_array_equal(got.numpy()[3, 2:], kv[0, :2])
    np.testing.assert_array_equal(got.numpy()[7, 0], kv[0, 2])
    np.testing.assert_array_equal(got.numpy()[5, 3], kv[1, 0])
