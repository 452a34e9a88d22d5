# Copied from the JAX package: paddle_tpu/layers/collective.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Collective layers (reference: python/paddle/fluid/layers/collective.py:20-172
— `_allreduce`, `_c_allreduce`, `_c_broadcast`, `_c_allgather`,
`_c_reducescatter`). ring_id becomes a mesh axis name (default 'data')."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = []


def _allreduce(x, out=None, reduce_type="sum", sync_mode=False):
    helper = LayerHelper("allreduce")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=f"c_allreduce_{reduce_type}", inputs={"X": x},
                     outputs={"Out": out})
    return out


def _c_allreduce(x, out=None, reduce_type="sum", ring_id=0, use_calc_stream=False,
                 axis_name="data"):
    helper = LayerHelper("c_allreduce")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=f"c_allreduce_{reduce_type}", inputs={"X": x},
                     outputs={"Out": out},
                     attrs={"ring_id": ring_id, "axis_name": axis_name})
    return out


def _c_broadcast(x, root=0, ring_id=0, use_calc_stream=False, axis_name="data"):
    helper = LayerHelper("c_broadcast")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="c_broadcast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"root": root, "ring_id": ring_id, "axis_name": axis_name})
    return out


def _c_allgather(x, nranks, ring_id=0, use_calc_stream=False, axis_name="data"):
    helper = LayerHelper("c_allgather")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="c_allgather", inputs={"X": x}, outputs={"Out": out},
                     attrs={"nranks": nranks, "ring_id": ring_id,
                            "axis_name": axis_name})
    return out


def _c_reducescatter(x, nranks, ring_id=0, use_calc_stream=False, axis_name="data"):
    helper = LayerHelper("c_reducescatter")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="c_reducescatter", inputs={"X": x}, outputs={"Out": out},
                     attrs={"nranks": nranks, "ring_id": ring_id,
                            "axis_name": axis_name})
    return out
