# Copied from the JAX package: paddle_tpu/reader_decorators.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Reader decorators (reference: python/paddle/reader/decorator.py —
map_readers, buffered, compose, chain, shuffle, firstn, cache, batch)."""

from __future__ import annotations

import itertools
import queue
import random
import threading

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "cache", "batch"]


def map_readers(func, *readers):
    def reader():
        for vals in zip(*[r() for r in readers]):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    def shuffled():
        buf = []
        rng = random.Random(0)
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf

    return shuffled


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, check_alignment=True):
    def reader():
        for items in zip(*[r() for r in readers]):
            out = []
            for it in items:
                if isinstance(it, tuple):
                    out.extend(it)
                else:
                    out.append(it)
            yield tuple(out)

    return reader


def buffered(reader, size):
    def buffered_reader():
        q: "queue.Queue" = queue.Queue(maxsize=size)
        end = object()

        def worker():
            try:
                for d in reader():
                    q.put(d)
            finally:
                q.put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is end:
                break
            yield e

    return buffered_reader


def firstn(reader, n):
    def reader_n():
        yield from itertools.islice(reader(), n)

    return reader_n


def cache(reader):
    all_data = None

    def cached():
        nonlocal all_data
        if all_data is None:
            all_data = list(reader())
        yield from all_data

    return cached


def batch(reader, batch_size, drop_last=False):
    def batched():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads (reference:
    reader/decorator.py xmap_readers; threads instead of processes — the
    mappers here are numpy transforms that release the GIL)."""
    import queue as _queue
    import threading

    end = object()

    class _Err:
        def __init__(self, exc):
            self.exc = exc

    def data_reader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)

        def feed():
            # sentinel in finally: a dying producer must never leave the
            # consumer blocked (the buffered() pattern above)
            try:
                for i, sample in enumerate(reader()):
                    in_q.put((i, sample))
            except BaseException as e:
                out_q.put(_Err(e))
            finally:
                for _ in range(process_num):
                    in_q.put(end)

        def work():
            try:
                while True:
                    item = in_q.get()
                    if item is end:
                        return
                    i, sample = item
                    out_q.put((i, mapper(sample)))
            except BaseException as e:
                out_q.put(_Err(e))
            finally:
                out_q.put(end)

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        finished = 0
        pending = {}
        next_i = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if isinstance(item, _Err):
                raise item.exc
            if order:
                i, mapped = item
                pending[i] = mapped
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
            else:
                yield item[1]

    return data_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave multiple readers on threads (reference:
    decorator.py multiprocess_reader; thread-backed here — the use case is
    overlapping IO-bound readers)."""
    import queue as _queue
    import threading

    end = object()

    class _Err:
        def __init__(self, exc):
            self.exc = exc

    def data_reader():
        q = _queue.Queue(queue_size)

        def pump(r):
            try:
                for sample in r():
                    q.put(sample)
            except BaseException as e:
                q.put(_Err(e))
            finally:
                q.put(end)

        for r in readers:
            threading.Thread(target=pump, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            item = q.get()
            if item is end:
                finished += 1
                continue
            if isinstance(item, _Err):
                raise item.exc
            yield item

    return data_reader
