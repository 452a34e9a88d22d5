"""The CRF, beam and metric ops of the fluid path against the JAX
package's kernels on the same numpy inputs from a seed:

- `linear_chain_crf` (the NLL and, through the generic `_grad`, the
  emission and transition gradients), `crf_decoding` (the path, and the
  0/1 hit mask given a Label) and `chunk_eval` over IOB, IOE, IOBES and
  plain (`paddle_tpu_torch/ops/crf.py`);
- `beam_search`, `gather_tree` and `beam_search_decode` on hand-built
  trellises with ties (`ops/beam.py`), and the `beam_search` op against
  the selection functions the port's models use (`ops.beam.beam_search`,
  which `models/gpt.py` calls, and `ops/tensor.py`'s `stable_top_k`,
  which `models/transformer.py` calls);
- `auc` (its state carried across two calls), `precision_recall` and
  `positive_negative_pair` (`ops/metrics_ops.py`).

Tolerances: the CRF's log-space recursions and their gradients
`TOL["mm"]` of test_torch_fluid_ops.py (rtol 1e-4, atol 1e-4 of the
largest value), on float32; paths, ids, counts and masks exactly; the
metrics' rates rtol 1e-6. `precision_recall`'s JAX code leaves its
count dtype to JAX's default float, float64 under the suite's x64: the
port's float32 is held to it by value there.
"""

import numpy as np
import pytest
import torch

from test_torch_fluid_ops import _c, _lit, _run, _spec
from test_torch_sequence_ops import (cases_stay_on_meta, check_op,
                                     outputs_stay_on_meta)

LEN3 = _lit([6, 0, 3], "int64")
EMIT = _spec((3, 6, 4))
TRANS = _spec((6, 4))
LABEL = _spec((3, 6), "int4", "int64")

CRF_CASES = [
    _c("linear_chain_crf", {"Emission": [EMIT], "Transition": [TRANS],
                            "Label": [LABEL], "Length": [LEN3]}, {}, "mm"),
    _c("linear_chain_crf", {"Emission": [EMIT], "Transition": [TRANS],
                            "Label": [_spec((3, 6, 1), "int4", "int64")]},
       {}, "mm", name="linear_chain_crf_full_length_label3d"),
    _c("linear_chain_crf", {"Emission": [_spec((5, 4))], "Transition": [TRANS],
                            "Label": [_spec((5,), "int4", "int64")]},
       {}, "mm", name="linear_chain_crf_one_sequence"),
    _c("crf_decoding", {"Emission": [EMIT], "Transition": [TRANS],
                        "Length": [LEN3]}, {}, "mm"),
    _c("crf_decoding", {"Emission": [EMIT], "Transition": [TRANS],
                        "Label": [LABEL], "Length": [LEN3]}, {}, "mm",
       name="crf_decoding_hit_mask"),
    _c("crf_decoding", {"Emission": [_spec((5, 4))], "Transition": [TRANS]},
       {}, "mm", name="crf_decoding_one_sequence"),
]

_NTAG = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _chunk_case(scheme, excluded=()):
    hi = 3 * _NTAG[scheme] + 1            # 3 chunk types, then Other
    spec = _spec((4, 9), f"int{hi}", "int64")
    return _c("chunk_eval", {"Inference": [spec], "Label": [spec],
                             "SeqLength": [_lit([9, 0, 5, 7], "int64")]},
              {"num_chunk_types": 3, "chunk_scheme": scheme,
               "excluded_chunk_types": list(excluded)}, "ew",
              name=f"chunk_eval_{scheme}" + ("_excluded" if excluded else ""))


CHUNK_CASES = [_chunk_case(s) for s in ("IOB", "IOE", "IOBES", "plain")] + [
    _chunk_case("IOB", excluded=(1,))]


@pytest.mark.parametrize("op_type, spec, attrs, cls", CRF_CASES + CHUNK_CASES)
def test_crf_op_matches_jax(op_type, spec, attrs, cls):
    check_op(op_type, spec, attrs, cls)


@pytest.mark.parametrize("seed", range(4))
def test_chunk_eval_counts_match_jax_on_many_draws(seed):
    """Twenty draws a seed over every scheme: the counts exactly."""
    rng = np.random.RandomState(seed)
    for scheme, ntag in _NTAG.items():
        for _ in range(5):
            hi = 2 * ntag + 1
            ins = {"Inference": [rng.randint(0, hi, (3, 11)).astype("int64")],
                   "Label": [rng.randint(0, hi, (3, 11)).astype("int64")],
                   "SeqLength": [rng.randint(0, 12, (3,)).astype("int64")]}
            attrs = {"num_chunk_types": 2, "chunk_scheme": scheme}
            j = _run("jax", "chunk_eval", ins, attrs, {})
            t = _run("torch", "chunk_eval", ins, attrs, {})
            for k in ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks",
                      "Precision", "Recall", "F1-Score"):
                np.testing.assert_array_equal(t[k][0], j[k][0], err_msg=k)


def _beam_trellis():
    """B 2, K 3, W 4. Sentence 0 has equal candidates across beams
    (ties to the lower flat index); in sentence 1 beam 2 has finished
    (pre_id == end_id 0) and ties with a live candidate."""
    pre_ids = np.array([[4, 5, 6], [3, 2, 0]], "int64")
    pre_scores = np.array([[-1.0, -1.0, -2.0], [-0.5, -1.5, -0.7]],
                          "float32")
    scores = np.array([[[-1.2, -1.1, -1.1, -3.0],
                        [-1.1, -1.3, -1.2, -1.1],
                        [-2.5, -2.1, -2.1, -2.2]],
                       [[-0.9, -0.7, -2.0, -0.8],
                        [-1.6, -1.7, -0.7, -1.9],
                        [-5.0, -5.0, -5.0, -5.0]]], "float32")
    return pre_ids, pre_scores, scores


_BEAM_OUTS = {"selected_ids": ["i"], "selected_scores": ["s"],
              "parent_idx": ["p"]}


@pytest.mark.parametrize("attrs, with_ids", [
    ({"beam_size": 3, "end_id": 0}, False),
    ({"beam_size": 2, "end_id": 0}, True),
    ({"beam_size": 1, "end_id": 0}, False),
    ({"beam_size": 3, "end_id": 0, "is_accumulated": False}, False),
])
def test_beam_search_op_matches_jax(attrs, with_ids):
    pre_ids, pre_scores, scores = _beam_trellis()
    if not attrs.get("is_accumulated", True):
        scores = np.exp(scores)              # raw probabilities
    ins = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
           "scores": [scores]}
    if with_ids:
        ins["ids"] = [(np.arange(24).reshape(2, 3, 4) * 3 % 17 + 1)
                      .astype("int64")]
    j = _run("jax", "beam_search", ins, attrs, _BEAM_OUTS)
    t = _run("torch", "beam_search", ins, attrs, _BEAM_OUTS)
    for k in _BEAM_OUTS:
        assert t[k][0].dtype == j[k][0].dtype, k
        np.testing.assert_array_equal(t[k][0], j[k][0], err_msg=k)


def test_beam_search_op_is_the_models_selection():
    """The op's outputs are `ops.beam.beam_search`'s (models/gpt.py's
    step), and on live beams the same top-k as models/transformer.py's
    `stable_top_k` on the flat candidates, ties to the lower index."""
    from paddle_tpu_torch.models.transformer import stable_top_k
    from paddle_tpu_torch.ops.beam import beam_search

    pre_ids, pre_scores, scores = _beam_trellis()
    pre_ids[1, 2] = 7                        # every beam live
    attrs = {"beam_size": 3, "end_id": 0}
    op = _run("torch", "beam_search", {"pre_ids": [pre_ids],
                                       "pre_scores": [pre_scores],
                                       "scores": [scores]}, attrs,
              _BEAM_OUTS)
    fn = beam_search(torch.from_numpy(pre_ids), torch.from_numpy(pre_scores),
                     torch.from_numpy(scores), beam_size=3, end_id=0)
    for k in _BEAM_OUTS:
        np.testing.assert_array_equal(op[k][0], fn[k].numpy(), err_msg=k)
    vals, idx = stable_top_k(torch.from_numpy(scores).reshape(2, 12), 3)
    np.testing.assert_array_equal(op["selected_scores"][0], vals.numpy())
    np.testing.assert_array_equal(op["parent_idx"][0], (idx // 4).numpy())
    np.testing.assert_array_equal(op["selected_ids"][0], (idx % 4).numpy())


def _steps():
    """A 4-step trellis, B 2, K 3: ids, parents and accumulated scores;
    two beams of sentence 0 end with equal scores."""
    ids = np.array([[[5, 6, 7], [3, 4, 5]],
                    [[2, 0, 8], [9, 1, 1]],
                    [[0, 4, 3], [2, 2, 6]],
                    [[1, 0, 9], [0, 7, 3]]], "int64")
    parents = np.array([[[0, 0, 0], [0, 0, 0]],
                        [[0, 2, 1], [1, 0, 2]],
                        [[1, 0, 0], [2, 2, 0]],
                        [[2, 0, 1], [0, 1, 2]]], "int64")
    scores = np.array([[[-1., -2, -3], [-1, -1, -2]],
                       [[-2., -2, -3], [-2, -3, -3]],
                       [[-2., -3, -3], [-3, -3, -4]],
                       [[-3., -3, -4], [-4, -3.5, -3.5]]], "float32")
    return ids, parents, scores


def test_gather_tree_matches_jax():
    ids, parents, _ = _steps()
    j = _run("jax", "gather_tree", {"Ids": [ids], "Parents": [parents]}, {},
             {"Out": ["o"]})["Out"][0]
    t = _run("torch", "gather_tree", {"Ids": [ids], "Parents": [parents]},
             {}, {"Out": ["o"]})["Out"][0]
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


def test_beam_search_decode_matches_jax_with_tied_scores():
    ids, parents, scores = _steps()
    ins = {"Ids": [ids], "ParentIdx": [parents], "Scores": [scores]}
    outs = {"SentenceIds": ["i"], "SentenceScores": ["s"]}
    j = _run("jax", "beam_search_decode", ins, {"end_id": 0,
                                                "beam_size": 3}, outs)
    t = _run("torch", "beam_search_decode", ins, {"end_id": 0,
                                                  "beam_size": 3}, outs)
    for k in outs:
        assert t[k][0].dtype == j[k][0].dtype, k
        np.testing.assert_array_equal(t[k][0], j[k][0], err_msg=k)


def _auc_ins(rng, n, nt, stat=None):
    p = rng.uniform(size=(n, 1)).astype("float32")
    return {"Predict": [np.concatenate([1 - p, p], 1)],
            "Label": [(rng.uniform(size=(n, 1)) < p).astype("int64")],
            "StatPos": [np.zeros(nt + 1, "float32") if stat is None
                        else stat[0]],
            "StatNeg": [np.zeros(nt + 1, "float32") if stat is None
                        else stat[1]]}


def test_auc_state_carries_across_two_calls():
    rng = np.random.RandomState(0)
    attrs = {"num_thresholds": 200}
    stat_j = stat_t = None
    for call in range(2):
        ins = _auc_ins(rng, 64, 200)
        ins_j = dict(ins, **({} if stat_j is None else
                             {"StatPos": [stat_j[0]], "StatNeg": [stat_j[1]]}))
        ins_t = dict(ins, **({} if stat_t is None else
                             {"StatPos": [stat_t[0]], "StatNeg": [stat_t[1]]}))
        j = _run("jax", "auc", ins_j, attrs, {})
        t = _run("torch", "auc", ins_t, attrs, {})
        for k in ("StatPosOut", "StatNegOut"):
            np.testing.assert_array_equal(t[k][0], j[k][0], err_msg=k)
        np.testing.assert_allclose(t["AUC"][0], j["AUC"][0], rtol=1e-6)
        assert t["AUC"][0].dtype == j["AUC"][0].dtype
        stat_j = (j["StatPosOut"][0], j["StatNegOut"][0])
        stat_t = (t["StatPosOut"][0], t["StatNegOut"][0])
    assert stat_t[0].sum() + stat_t[1].sum() == 128
    assert 0.5 < float(t["AUC"][0][0]) < 1.0


def test_precision_recall_matches_jax():
    rng = np.random.RandomState(1)
    idx = rng.randint(0, 4, (12, 1)).astype("int64")
    idx[3, 0] = 6                            # out of range: dropped
    lbl = rng.randint(0, 4, (12, 1)).astype("int64")
    ins = {"MaxProbs": [rng.uniform(size=(12, 1)).astype("float32")],
           "Indices": [idx], "Labels": [lbl]}
    j = _run("jax", "precision_recall", ins, {"class_number": 4}, {})
    t = _run("torch", "precision_recall", ins, {"class_number": 4}, {})
    for k in ("BatchMetrics", "AccumMetrics", "AccumStatesInfo"):
        assert t[k][0].dtype == np.float32, k
        np.testing.assert_allclose(t[k][0], j[k][0], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("accumulate", [False, True])
def test_positive_negative_pair_matches_jax(accumulate):
    rng = np.random.RandomState(2)
    score = rng.randint(0, 4, (10, 2)).astype("float32")   # ties
    ins = {"Score": [score],
           "Label": [rng.randint(0, 3, (10, 1)).astype("float32")],
           "QueryID": [rng.randint(0, 3, (10, 1)).astype("int64")],
           "Weight": [rng.uniform(0.5, 2, (10, 1)).astype("float32")]}
    if accumulate:
        for k in ("Positive", "Negative", "Neutral"):
            ins[f"Accumulate{k}Pair"] = [_lit([1.5], "float32")]
    for col in (0, -1):
        j = _run("jax", "positive_negative_pair", ins, {"column": col}, {})
        t = _run("torch", "positive_negative_pair", ins, {"column": col}, {})
        for k in ("PositivePair", "NegativePair", "NeutralPair"):
            assert t[k][0].dtype == j[k][0].dtype, k
            np.testing.assert_allclose(t[k][0], j[k][0], rtol=1e-6,
                                       err_msg=k)
        assert j["NeutralPair"][0][0] > (1.5 if accumulate else 0)


def test_no_crf_beam_or_metric_op_leaves_the_device_it_was_given():
    """Each op's forward on meta inputs comes back on meta
    (`outputs_stay_on_meta`)."""
    cases_stay_on_meta(CRF_CASES + CHUNK_CASES)
    pre_ids, pre_scores, scores = _beam_trellis()
    outputs_stay_on_meta("beam_search", {"pre_ids": [pre_ids],
                                         "pre_scores": [pre_scores],
                                         "scores": [scores]},
                         {"beam_size": 2, "end_id": 0})
    ids, parents, step_scores = _steps()
    outputs_stay_on_meta("gather_tree", {"Ids": [ids], "Parents": [parents]},
                         {})
    outputs_stay_on_meta("beam_search_decode",
                         {"Ids": [ids], "ParentIdx": [parents],
                          "Scores": [step_scores]}, {"end_id": 0})
    rng = np.random.RandomState(0)
    outputs_stay_on_meta("auc", _auc_ins(rng, 8, 20), {"num_thresholds": 20})
    outputs_stay_on_meta("precision_recall",
                         {"MaxProbs": [np.ones((4, 1), "float32")],
                          "Indices": [_lit([[0], [1], [5], [1]], "int64")],
                          "Labels": [_lit([[0], [2], [1], [1]], "int64")]},
                         {"class_number": 3})
    outputs_stay_on_meta("positive_negative_pair",
                         {"Score": [np.ones((4, 1), "float32")],
                          "Label": [np.ones((4, 1), "float32")],
                          "QueryID": [np.zeros((4, 1), "int64")]}, {})


def test_every_crf_beam_and_metric_op_has_a_test():
    import inspect

    from paddle_tpu.core import registry as jreg

    mods = {}
    for t, d in jreg._REGISTRY.items():
        if not t.endswith("_grad"):
            m = inspect.getmodule(d.kernel).__name__.rsplit(".", 1)[-1]
            mods.setdefault(m, set()).add(t)
    assert mods["crf"] == {p.values[0] for p in CRF_CASES + CHUNK_CASES}
    assert mods["beam"] == {"beam_search", "gather_tree",
                            "beam_search_decode"}
    assert mods["metrics_ops"] == {"accuracy", "auc", "precision_recall",
                                   "positive_negative_pair"}


def test_crf_decoding_ties_go_to_the_first_tag():
    """All-equal emissions and transitions: every step ties, and both
    packages decode tag 0 throughout."""
    ins = {"Emission": [np.zeros((2, 5, 3), "float32")],
           "Transition": [np.zeros((5, 3), "float32")],
           "Length": [_lit([5, 2], "int64")]}
    for pkg in ("jax", "torch"):
        path = _run(pkg, "crf_decoding", ins, {}, {})["ViterbiPath"][0]
        np.testing.assert_array_equal(path, np.zeros((2, 5), "int64"))
