# Copied from the JAX package: paddle_tpu/reader.py, with the changes
# tests/test_torch_imports.py declares (FRONT_END_CHANGES); keep it in
# step with that file.
"""DataLoader / PyReader (reference: python/paddle/fluid/reader.py —
DataLoader.from_generator :73, GeneratorLoader :298, PyReader :569).

The reference pushes LoDTensors into a C++ LoDTensorBlockingQueue consumed by
a graph-embedded `read` op with double-buffering to GPU
(operators/reader/buffered_reader.cc). The port's pipeline keeps the
same shape: a background thread runs the user generator into a bounded
host queue (core/async_exec.Prefetcher — producer errors propagate to
the iterating consumer, and the thread is joined when iteration stops
early), and with `use_double_buffer` + places a second Prefetcher stage
(core/async_exec.DevicePrefetcher) copies each batch to the places'
card, from pinned memory on a side stream, into a bounded double
buffer, so batch N+1 is on device while step N computes and batch N+2
is being collated on the host.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

from .core.async_exec import (DevicePrefetcher, Prefetcher,
                              device_prefetch_wanted, prefetch_device)
from .core.framework import Variable

__all__ = ["DataLoader", "PyReader", "GeneratorLoader",
           "ElasticShardPlan", "elastic_epoch_permutation"]

# reuse the reference's decorator library semantics
from .reader_decorators import (  # noqa: F401,E402
    batch, buffered, cache, chain, compose, firstn, map_readers,
    multiprocess_reader, shuffle, xmap_readers)


# ---------------------------------------------------------------------------
# Elastic data sharding (RESILIENCE.md §Elasticity)
# ---------------------------------------------------------------------------


def elastic_epoch_permutation(n_examples: int, epoch: int,
                              seed: int = 0) -> np.ndarray:
    """Per-epoch example shuffle that is WORLD-SIZE-INDEPENDENT: the
    permutation is keyed on (seed, epoch) only, so every worker — and a
    worker that joins mid-epoch — derives the identical global order.
    That independence is what lets a membership change re-split the
    stream without moving, losing, or double-seeing any example."""
    rs = np.random.RandomState(
        (int(seed) * 1_000_003 + int(epoch) * 7_919 + 1) & 0x7FFFFFFF)
    return rs.permutation(int(n_examples))


class ElasticShardPlan:
    """Deterministic assignment of the global example stream to workers,
    keyed on (epoch, global step, world size) — nothing else.

    The global stream is consumed `global_batch` examples per global
    step: step s covers epoch positions [p, p + global_batch) where
    p = (s % steps_per_epoch) * global_batch, mapped through the
    world-size-independent `elastic_epoch_permutation` for that epoch
    (trailing examples that don't fill a batch are dropped, the
    reference's drop_last semantics). Within a step the batch is split
    contiguously across the `world_size` workers in rank order, rank
    r taking `global_batch // W` examples (+1 for the first
    `global_batch % W` ranks).

    Invariant (the elastic contract): for EVERY world size W,
    `⋃_r worker_indices(s, r, W) == batch_indices(s)` — exactly, in
    order. A membership change between steps therefore re-splits the
    stream with no example lost or double-seen, and the concatenated
    global batch is bit-identical to the fixed-membership run, which is
    what makes the loss trajectory comparable across resizes
    (tools/chaos_bench.py --elastic proves it end to end).
    """

    def __init__(self, n_examples: int, global_batch: int, *,
                 seed: int = 0, shuffle_each_epoch: bool = True):
        if global_batch < 1 or n_examples < global_batch:
            raise ValueError(
                f"need n_examples >= global_batch >= 1, got "
                f"{n_examples} / {global_batch}")
        self.n_examples = int(n_examples)
        self.global_batch = int(global_batch)
        self.seed = int(seed)
        self.shuffle_each_epoch = bool(shuffle_each_epoch)
        self.steps_per_epoch = self.n_examples // self.global_batch
        self._perm_cache = {}
        # identity order shared across epochs — built once, not one
        # fresh n_examples-long arange per step on the hot data path
        self._identity = None if shuffle_each_epoch \
            else np.arange(self.n_examples)

    def epoch_of(self, step: int) -> int:
        return int(step) // self.steps_per_epoch

    def _perm(self, epoch: int) -> np.ndarray:
        if not self.shuffle_each_epoch:
            return self._identity
        if epoch not in self._perm_cache:
            # tiny cache: an elastic resize replays at most the current
            # and neighbouring epochs
            if len(self._perm_cache) > 4:
                self._perm_cache.clear()
            self._perm_cache[epoch] = elastic_epoch_permutation(
                self.n_examples, epoch, self.seed)
        return self._perm_cache[epoch]

    def batch_indices(self, step: int) -> np.ndarray:
        """Global example indices consumed at `step` — identical for
        every world size by construction."""
        step = int(step)
        pos = (step % self.steps_per_epoch) * self.global_batch
        return self._perm(self.epoch_of(step))[pos:pos + self.global_batch]

    def worker_counts(self, world_size: int) -> List[int]:
        if world_size < 1:
            raise ValueError("world_size must be >= 1")
        q, rem = divmod(self.global_batch, int(world_size))
        return [q + (1 if r < rem else 0) for r in range(int(world_size))]

    def worker_indices(self, step: int, rank: int,
                       world_size: int) -> np.ndarray:
        """`rank`'s slice of the step's global batch under `world_size`
        live workers: the contiguous split of batch_indices(step)."""
        counts = self.worker_counts(world_size)
        if not 0 <= int(rank) < len(counts):
            raise ValueError(f"rank {rank} out of range for world "
                             f"{world_size}")
        start = sum(counts[:int(rank)])
        return self.batch_indices(step)[start:start + counts[int(rank)]]


class GeneratorLoader:
    """reference: reader.py:298."""

    def __init__(self, feed_list: Sequence[Variable], capacity: int = 64,
                 iterable: bool = True, return_list: bool = False,
                 use_double_buffer: bool = True):
        self._feed_list = list(feed_list)
        self._capacity = capacity
        self._iterable = iterable
        self._return_list = return_list
        self._generator: Optional[Callable] = None
        self._places = None
        self._batched = False
        self._use_double_buffer = bool(use_double_buffer)

    @property
    def feed_list(self):
        return list(self._feed_list)

    # -- configuration (reference API) --------------------------------------

    def set_sample_generator(self, reader, batch_size, drop_last=True, places=None):
        def batched():
            buf = []
            for sample in reader():
                if not isinstance(sample, (list, tuple)):
                    sample = (sample,)
                buf.append(sample)
                if len(buf) == batch_size:
                    yield self._collate(buf)
                    buf = []
            if buf and not drop_last:
                yield self._collate(buf)

        self._generator = batched
        self._places = places
        return self

    def set_sample_list_generator(self, reader, places=None):
        def gen():
            for samples in reader():
                yield self._collate(samples)

        self._generator = gen
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        def gen():
            for batch_data in reader():
                if isinstance(batch_data, dict):
                    yield batch_data
                else:
                    yield {v.name: np.asarray(a)
                           for v, a in zip(self._feed_list, batch_data)}

        self._generator = gen
        self._places = places
        return self

    def _collate(self, samples):
        from .data_feeder import DataFeeder

        return DataFeeder(self._feed_list).feed(samples)

    # -- iteration -----------------------------------------------------------

    def __iter__(self):
        assert self._generator is not None, "call set_*_generator first"
        # host producer stage: the bounded background queue the
        # reference's LoDTensorBlockingQueue provides. Prefetcher owns
        # the lifecycle — a generator exception re-raises HERE (not a
        # silent hang/truncation), and the finally clause joins the
        # thread when the consumer stops iterating early.
        host = Prefetcher(self._generator(), depth=self._capacity,
                          stage="host")
        device = None
        if device_prefetch_wanted(self._places, self._use_double_buffer):
            # prefetch-to-device: batches go up to the places' card
            # two batches ahead
            device = DevicePrefetcher(
                host, depth=2, device=prefetch_device(self._places))
        try:
            yield from (device if device is not None else host)
        finally:
            if device is not None:
                device.close()
            host.close()

    # reference idiom: `for data in loader():`
    def __call__(self):
        return iter(self)

    # non-iterable (start/reset) mode used with graph readers in the
    # reference; provided for API parity
    def start(self):
        self._it = iter(self)

    def reset(self):
        self._it = None

    def next(self):
        return next(self._it)


class DataLoader:
    """reference: reader.py:73."""

    @staticmethod
    def from_generator(feed_list=None, capacity=64, use_double_buffer=True,
                       iterable=True, return_list=False, use_multiprocess=False):
        return GeneratorLoader(feed_list or [], capacity, iterable, return_list,
                               use_double_buffer)

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True,
                     use_double_buffer=False):
        from .dataset_loader import DatasetLoader

        return DatasetLoader(dataset, places, drop_last,
                             use_double_buffer=use_double_buffer)


class PyReader(GeneratorLoader):
    """reference: reader.py:569 (older API surface over the same loader)."""

    def __init__(self, feed_list=None, capacity=64, use_double_buffer=True,
                 iterable=True, return_list=False):
        super().__init__(feed_list or [], capacity, iterable, return_list,
                         use_double_buffer)

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        return self.set_sample_generator(sample_generator, batch_size,
                                         drop_last, places)

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places)
