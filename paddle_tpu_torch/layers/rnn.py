# Copied from the JAX package: paddle_tpu/layers/rnn.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Recurrent layers: LSTM / GRU over padded batches.

Reference: dynamic_lstm/dynamic_gru (operators/lstm_op.cc, gru_op.cc +
math/lstm_compute, gru_compute) consume LoD sequences; StaticRNN unrolls.
TPU-native: one differentiable `scan` op per layer over the time axis of a
padded [N, T, D] batch (SURVEY §5: LoD → padded + lengths). Gate math
matches the reference kernels, so converged weights transfer.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["lstm", "dynamic_lstm", "gru", "dynamic_gru", "dynamic_lstmp",
           "lstm_unit", "gru_unit",
           "beam_search", "beam_search_decode", "gather_tree"]


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=False,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", cell_clip=None, proj_clip=None,
                  dtype="float32", name=None):
    """reference: layers/nn.py `dynamic_lstmp` → lstmp op (lstmp_op.cc):
    projection LSTM over pre-projected [N, T, 4H] input; returns
    (projection [N, T, P], cell [N, T, H])."""
    helper = LayerHelper("dynamic_lstmp", name=name)
    hidden_size = size // 4
    w = helper.create_parameter(
        param_attr, shape=[proj_size, 4 * hidden_size], dtype=dtype)
    pw = helper.create_parameter(
        param_attr, shape=[hidden_size, proj_size], dtype=dtype)
    b = helper.create_parameter(
        bias_attr, shape=[4 * hidden_size], dtype=dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": input, "Weight": w, "ProjWeight": pw, "Bias": b}
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op(
        type="lstmp_v2", inputs=inputs,
        outputs={"Projection": proj, "Cell": cell},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation,
               "cell_clip": float(cell_clip or 0.0),
               "proj_clip": float(proj_clip or 0.0)})
    return proj, cell


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """reference: layers/nn.py `lstm_unit` — fc([x_t, h_prev]) -> 4D gates
    then one lstm_unit op step; returns (hidden, cell)."""
    from .nn import fc
    from .tensor import concat

    helper = LayerHelper("lstm_unit", name=name)
    size = cell_t_prev.shape[1]
    concat_in = concat([x_t, hidden_t_prev], axis=1)
    fc_out = fc(concat_in, size=4 * size, param_attr=param_attr,
                bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": fc_out, "C_prev": cell_t_prev},
                     outputs={"C": c, "H": h},
                     attrs={"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False, name=None):
    """reference: layers/nn.py `gru_unit` → gru_unit op; returns
    (hidden, reset_hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", name=name)
    acts = {"identity": 0, "sigmoid": 1, "tanh": 2, "relu": 3}
    hidden_size = size // 3
    w = helper.create_parameter(param_attr,
                                shape=[hidden_size, 3 * hidden_size],
                                dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[1, 3 * hidden_size],
                                dtype=input.dtype, is_bias=True)
    gate = helper.create_variable_for_type_inference(input.dtype)
    rhp = helper.create_variable_for_type_inference(input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": input, "HiddenPrev": hidden, "Weight": w,
                "Bias": b},
        outputs={"Gate": gate, "ResetHiddenPrev": rhp, "Hidden": out},
        attrs={"activation": acts[activation],
               "gate_activation": acts[gate_activation],
               "origin_mode": origin_mode})
    return out, rhp, gate


def lstm(input, hidden_size, num_layers=1, is_reverse=False,
         param_attr=None, bias_attr=None, h0=None, c0=None, name=None):
    """LSTM over [N, T, D] padded input → (hidden [N, T, H], last_h, last_c).

    Gate layout follows the reference lstm_op memory order: c̃, i, f, o
    (math/detail/lstm_cpu_kernel.h) with combined input-and-recurrent
    weight [D + H, 4H] — converged reference weights transfer.
    """
    helper = LayerHelper("lstm", name=name)
    out = input
    last_h = last_c = None
    for layer in range(num_layers):
        D = out.shape[-1]
        w = helper.create_parameter(
            param_attr, shape=[D + hidden_size, 4 * hidden_size],
            dtype=input.dtype)
        b = helper.create_parameter(
            bias_attr, shape=[4 * hidden_size], dtype=input.dtype,
            is_bias=True)
        hidden = helper.create_variable_for_type_inference(input.dtype)
        lh = helper.create_variable_for_type_inference(input.dtype)
        lc = helper.create_variable_for_type_inference(input.dtype)
        inputs = {"Input": out, "Weight": w, "Bias": b}
        if h0 is not None and layer == 0:
            inputs["H0"] = h0
        if c0 is not None and layer == 0:
            inputs["C0"] = c0
        helper.append_op(
            type="lstm_v2",
            inputs=inputs,
            outputs={"Hidden": hidden, "LastH": lh, "LastC": lc},
            attrs={"hidden_size": hidden_size, "is_reverse": is_reverse})
        out, last_h, last_c = hidden, lh, lc
    return out, last_h, last_c


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """reference: layers/nn.py dynamic_lstm — input is the pre-projected
    [N, T, 4H]; returns (hidden, cell)."""
    helper = LayerHelper("dynamic_lstm", name=name)
    hidden_size = size // 4
    w = helper.create_parameter(
        param_attr, shape=[hidden_size, 4 * hidden_size], dtype=dtype)
    b = helper.create_parameter(
        bias_attr, shape=[4 * hidden_size], dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": input, "Weight": w, "Bias": b}
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op(
        type="dynamic_lstm_v2",
        inputs=inputs,
        outputs={"Hidden": hidden, "Cell": cell},
        attrs={"hidden_size": hidden_size, "is_reverse": is_reverse})
    return hidden, cell


def gru(input, hidden_size, num_layers=1, is_reverse=False, param_attr=None,
        bias_attr=None, h0=None, name=None):
    """GRU over [N, T, D] → (hidden [N, T, H], last_h). Gate math follows
    the reference gru_op (update z, reset r, candidate c̃)."""
    helper = LayerHelper("gru", name=name)
    out = input
    last_h = None
    for layer in range(num_layers):
        D = out.shape[-1]
        w = helper.create_parameter(
            param_attr, shape=[D + hidden_size, 3 * hidden_size],
            dtype=input.dtype)
        b = helper.create_parameter(
            bias_attr, shape=[3 * hidden_size], dtype=input.dtype,
            is_bias=True)
        hidden = helper.create_variable_for_type_inference(input.dtype)
        lh = helper.create_variable_for_type_inference(input.dtype)
        inputs = {"Input": out, "Weight": w, "Bias": b}
        if h0 is not None and layer == 0:
            inputs["H0"] = h0
        helper.append_op(
            type="gru_v2",
            inputs=inputs,
            outputs={"Hidden": hidden, "LastH": lh},
            attrs={"hidden_size": hidden_size, "is_reverse": is_reverse})
        out, last_h = hidden, lh
    return out, last_h


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, name=None):
    """reference: layers/nn.py dynamic_gru — input pre-projected [N,T,3H]."""
    helper = LayerHelper("dynamic_gru", name=name)
    w = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[3 * size],
                                dtype=input.dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(input.dtype)
    lh = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Input": input, "Weight": w, "Bias": b}
    if h_0 is not None:
        inputs["H0"] = h_0
    helper.append_op(
        type="dynamic_gru_v2",
        inputs=inputs,
        outputs={"Hidden": hidden, "LastH": lh},
        attrs={"hidden_size": size, "is_reverse": is_reverse})
    return hidden, lh


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One beam-search step (reference: layers/nn.py:5554 → beam_search_op).
    pre_ids/pre_scores [B,K]; scores [B,K,W] candidate scores (accumulated
    unless is_accumulated=False); ids optional candidate ids. Returns
    (selected_ids, selected_scores[, parent_idx])."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference("int64")
    inputs = {"pre_ids": pre_ids, "pre_scores": pre_scores, "scores": scores}
    if ids is not None:
        inputs["ids"] = ids
    helper.append_op(type="beam_search", inputs=inputs,
                     outputs={"selected_ids": sel_ids,
                              "selected_scores": sel_scores,
                              "parent_idx": parent},
                     attrs={"beam_size": int(beam_size), "end_id": int(end_id),
                            "level": int(level),
                            "is_accumulated": bool(is_accumulated)})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, parent_idx, beam_size, end_id, name=None):
    """Assemble final translations from stacked per-step beam outputs
    (reference: layers/nn.py:5697 → beam_search_decode_op; the reference
    reads LoDTensorArrays, here the steps are stacked [T,B,K] tensors).
    Returns (sentence_ids [B,K,T] best-first, sentence_scores [B,K])."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_variable_for_type_inference("int64")
    sent_scores = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(type="beam_search_decode",
                     inputs={"Ids": ids, "ParentIdx": parent_idx,
                             "Scores": scores},
                     outputs={"SentenceIds": sent_ids,
                              "SentenceScores": sent_scores},
                     attrs={"beam_size": int(beam_size),
                            "end_id": int(end_id)})
    return sent_ids, sent_scores


def gather_tree(ids, parents):
    """Backtrack beams through parent pointers ([T,B,K] → [T,B,K])."""
    helper = LayerHelper("gather_tree")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="gather_tree", inputs={"Ids": ids,
                                                 "Parents": parents},
                     outputs={"Out": out})
    return out
