"""Paged (blocked) KV cache for autoregressive decode, in PyTorch.

Counterpart of the JAX package's `serving/kv_cache.py`: ONE
preallocated device pool of fixed-size blocks per K and V
(`[L, num_blocks, block_size, kv_heads, head_dim]`), a per-sequence
block table mapping logical positions to pool blocks, and the host-side
`BlockAllocator` free-list. Memory scales with live tokens, rounded up
to the block size.

Block 0 is the null block: padded or inactive decode slots and
out-of-range table entries read and write it, so fixed-shape steps need
no validity branches; the attention length mask guarantees nothing read
from it contributes.

The pool writers update one layer's pool slice IN PLACE (the JAX
versions return a new pool). Several writes may hit the same null-block
slot in one call; which one lands does not matter, since those slots
are never read unmasked.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["KVCacheConfig", "BlockAllocator", "NoBlocksError",
           "init_pools", "write_token_kv", "write_prefill_kv",
           "write_chunk_kv", "write_span_kv", "gather_kv",
           "build_block_table", "NULL_BLOCK"]

NULL_BLOCK = 0


class NoBlocksError(RuntimeError):
    """The pool has fewer free blocks than the allocation needs (the
    scheduler defers admission or preempts a sequence; the pool never
    grows)."""


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Shape of the device pool. `max_len` bounds any single sequence
    (prompt + generated) and fixes the block-table width."""

    layers: int
    kv_heads: int
    head_dim: int
    max_len: int
    block_size: int = 16
    num_blocks: int = 64
    dtype: str = "bfloat16"

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-int(self.max_len) // int(self.block_size))

    @property
    def usable_blocks(self) -> int:
        return int(self.num_blocks) - 1  # block 0 is the null block

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def pool_bytes(self) -> int:
        """Device bytes of BOTH pools (K and V)."""
        per = (self.layers * self.num_blocks * self.block_size *
               self.kv_heads * self.head_dim)
        return 2 * per * self.torch_dtype.itemsize


class BlockAllocator:
    """Host-side free-list over the pool's block ids (1..num_blocks-1;
    block 0 is never handed out). Single owner, the decode scheduler
    thread, so no locking here. `stats` reports internal waste: slots
    allocated but not (yet) holding a live token."""

    def __init__(self, cfg: KVCacheConfig):
        self.cfg = cfg
        if cfg.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is reserved), got "
                f"{cfg.num_blocks}")
        self._free: List[int] = list(range(cfg.num_blocks - 1, 0, -1))
        self._owned: Dict[int, bool] = {}

    def free_blocks(self) -> int:
        return len(self._free)

    def used_blocks(self) -> int:
        return len(self._owned)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take n blocks off the free list; raises NoBlocksError,
        allocating nothing, when fewer than n are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise NoBlocksError(
                f"need {n} blocks, only {len(self._free)} of "
                f"{self.cfg.usable_blocks} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._owned[b] = True
        return out

    def free(self, blocks: Sequence[int]):
        """Return blocks to the pool. Double-free, foreign ids and the
        null block raise: re-listing a block would hand it to two
        sequences."""
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("block 0 (null block) is never "
                                 "allocated and cannot be freed")
            if b not in self._owned:
                raise ValueError(f"block {b} is not allocated "
                                 "(double free?)")
            del self._owned[b]
            self._free.append(int(b))

    def stats(self, live_tokens: int = 0) -> Dict[str, float]:
        used = self.used_blocks()
        cap = used * self.cfg.block_size
        waste = max(0, cap - int(live_tokens))
        return {
            "blocks_total": self.cfg.usable_blocks,
            "blocks_free": self.free_blocks(),
            "blocks_used": used,
            "block_size": self.cfg.block_size,
            "live_tokens": int(live_tokens),
            "allocated_token_capacity": cap,
            "internal_waste_tokens": waste,
            "waste_fraction": round(waste / cap, 4) if cap else 0.0,
            "pool_bytes": self.cfg.pool_bytes(),
        }


# ---------------------------------------------------------------------------
# Pool helpers (device tensors; the writers update in place)
# ---------------------------------------------------------------------------


def init_pools(cfg: KVCacheConfig, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Zeroed K and V pools, `[L, NB, BS, kv_heads, head_dim]`."""
    shape = (cfg.layers, cfg.num_blocks, cfg.block_size, cfg.kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            torch.zeros(shape, dtype=cfg.torch_dtype, device=device))


def write_token_kv(pool_l: torch.Tensor, kv: torch.Tensor,
                   block_tables: torch.Tensor, positions: torch.Tensor,
                   block_size: int) -> None:
    """Write one token's K (or V) per slot into one layer's pool slice,
    in place. pool_l `[NB, BS, H, D]`, kv `[S, H, D]`, block_tables
    `[S, MB]`, positions `[S]`. Inactive slots carry all-zero tables,
    so their writes land in the null block."""
    positions = positions.long()
    blk = torch.gather(block_tables.long(), 1,
                       (positions // block_size)[:, None])[:, 0]
    pool_l[blk, positions % block_size] = kv


def write_prefill_kv(pool_l: torch.Tensor, kv: torch.Tensor,
                     block_table: torch.Tensor, block_size: int) -> None:
    """Write a whole prompt's K (or V), positions 0..T-1, into one
    layer's pool slice, in place. pool_l `[NB, BS, H, D]`, kv
    `[T, H, D]`, block_table `[MB]`. Positions past the sequence's
    allocated blocks hit table entries that are still 0 (the null
    block); positions inside the last allocated block but past the
    true length write slots that the decode step overwrites before any
    mask lets them be read."""
    t = torch.arange(kv.shape[0], device=pool_l.device)
    pool_l[block_table.long()[t // block_size], t % block_size] = kv


def write_chunk_kv(pool_l: torch.Tensor, kv: torch.Tensor,
                   block_table: torch.Tensor, start: torch.Tensor,
                   block_size: int) -> None:
    """Write one prompt SLICE's K (or V) into one layer's pool slice, in
    place (chunked prefill). pool_l `[NB, BS, H, D]`, kv `[C, H, D]`
    holding positions start..start+C-1, block_table `[MB]`, start an
    int32 device scalar (so a captured chunk step takes it from a static
    buffer). Positions past the table width go to the null block (the
    final slice's padded tail can run past max_len); positions inside
    allocated blocks but past the true prompt length write slots that
    later writes overwrite before any mask lets them be read."""
    t = torch.arange(kv.shape[0], device=pool_l.device) + start.long()
    bi = t // block_size
    mb = block_table.shape[0]
    blk = torch.where(bi < mb, block_table.long()[bi.clamp(max=mb - 1)],
                      NULL_BLOCK)
    pool_l[blk, t % block_size] = kv


def write_span_kv(pool_l: torch.Tensor, kv: torch.Tensor,
                  block_tables: torch.Tensor, positions: torch.Tensor,
                  block_size: int) -> None:
    """Write a W-token span per slot into one layer's pool slice, in
    place (speculative verification). pool_l `[NB, BS, H, D]`, kv
    `[S, W, H, D]` holding each slot's positions p..p+W-1, block_tables
    `[S, MB]`, positions `[S]` = each slot's span start. Slots with
    all-zero tables write the null block; span positions past the table
    width go there too."""
    w = kv.shape[1]
    t = positions.long()[:, None] + \
        torch.arange(w, device=pool_l.device)[None, :]
    bi = t // block_size
    mb = block_tables.shape[1]
    blk = torch.gather(block_tables.long(), 1, bi.clamp(max=mb - 1))
    blk = torch.where(bi < mb, blk, NULL_BLOCK)
    pool_l[blk, t % block_size] = kv


def gather_kv(pool_l: torch.Tensor, block_tables: torch.Tensor
              ) -> torch.Tensor:
    """Every slot's full (padded) context from one layer's pool slice:
    `[NB, BS, H, D]` x `[S, MB]` -> `[S, MB*BS, H, D]`. The caller masks
    positions past each slot's own."""
    s, mb = block_tables.shape
    ctx = pool_l[block_tables.long()]                 # [S, MB, BS, H, D]
    return ctx.reshape(s, mb * pool_l.shape[1], *pool_l.shape[2:])


def build_block_table(blocks: Sequence[int], max_blocks: int) -> np.ndarray:
    """Host helper: a sequence's padded table row (unused tail = null
    block)."""
    row = np.zeros((max_blocks,), np.int32)
    n = len(blocks)
    if n > max_blocks:
        raise ValueError(f"{n} blocks exceed table width {max_blocks}")
    row[:n] = np.asarray(list(blocks), np.int32)
    return row
