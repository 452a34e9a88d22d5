# Copied from the JAX package: paddle_tpu/dataset_loader.py, with the changes
# tests/test_torch_imports.py declares (FRONT_END_CHANGES); keep it in
# step with that file.
"""DatasetLoader (reference: reader.py:990 DatasetLoader — iterate a
Dataset's batches through the loader interface)."""

from __future__ import annotations


class DatasetLoader:
    """With `use_double_buffer`, batches are staged ahead of the
    consumer by a bounded background thread (core/async_exec): a
    stage that copies them to the places' card when
    `async_exec.device_prefetch_wanted` says so — accelerator places,
    or a PADDLE_TPU_DEVICE_PREFETCH=1 override, the same gate
    GeneratorLoader applies — and a host-side stage otherwise, so CPU
    consumers keep getting mutable numpy without a transfer that has
    nothing to hide."""

    def __init__(self, dataset, places=None, drop_last=True,
                 use_double_buffer=False, prefetch_depth=2):
        self._dataset = dataset
        self._places = places
        self._drop_last = drop_last
        self._use_double_buffer = bool(use_double_buffer)
        self._prefetch_depth = max(1, int(prefetch_depth))

    def __iter__(self):
        from .core.async_exec import (DevicePrefetcher, Prefetcher,
                                      device_prefetch_wanted,
                                      prefetch_device)

        want_device = device_prefetch_wanted(self._places,
                                             self._use_double_buffer)
        if not (self._use_double_buffer or want_device):
            yield from self._dataset._iter_batches()
            return
        src = self._dataset._iter_batches()
        pf = DevicePrefetcher(src, depth=self._prefetch_depth,
                              device=prefetch_device(self._places)) \
            if want_device \
            else Prefetcher(src, depth=self._prefetch_depth, stage="host")
        try:
            yield from pf
        finally:
            pf.close()
