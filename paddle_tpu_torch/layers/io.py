# Copied from the JAX package: paddle_tpu/layers/io.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Input layers (reference: python/paddle/fluid/layers/io.py — `data` :40)."""

from __future__ import annotations

from ..core import framework
from ..core.framework import Variable

__all__ = ["data", "py_reader", "create_py_reader_by_data",
           "read_file", "double_buffer"]


def data(name, shape, dtype="float32", append_batch_size=True,
         lod_level=0, type=None, stop_gradient=True) -> Variable:
    """Declare a feed variable (reference: layers/io.py:40). The reference
    injects feed ops reading from a feed-var holder (executor.py:233); here
    the executor binds feeds by name directly into the compiled step."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    block = framework.default_main_program().current_block()
    var = block.create_var(name=name, shape=shape, dtype=dtype,
                           stop_gradient=stop_gradient)
    var.desc.need_check_feed = True
    return var


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """reference: layers/io.py:525 `py_reader` — graph-side reader fed
    from Python. Returns a PyReader bound to fresh feed vars; call
    .decorate_sample_list_generator / .start() / read_file() like the
    reference."""
    from ..core.framework import unique_name
    from ..reader import PyReader

    prefix = name or unique_name.generate("py_reader")
    feed_vars = []
    for i, (sh, dt) in enumerate(zip(shapes, dtypes)):
        feed_vars.append(data(
            name=f"{prefix}_in_{i}",
            shape=[int(s) for s in sh[1:]], dtype=dt))
    return PyReader(feed_list=feed_vars, capacity=capacity,
                    use_double_buffer=use_double_buffer)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """reference: layers/io.py `create_py_reader_by_data` — PyReader over
    existing feed vars."""
    from ..reader import PyReader

    return PyReader(feed_list=feed_list, capacity=capacity,
                    use_double_buffer=use_double_buffer)


def read_file(reader):
    """reference: layers/io.py `read_file` — in-graph read from a
    reader; here the PyReader's feed vars ARE the read results (the
    blocking queue feeds them directly)."""
    vs = list(reader.feed_list)
    return vs[0] if len(vs) == 1 else vs


def double_buffer(reader, place=None, name=None):
    """reference: layers/io.py `double_buffer` — device prefetch
    decorator; the PyReader pipeline already double-buffers
    (use_double_buffer), so this is the identity on TPU."""
    return reader
