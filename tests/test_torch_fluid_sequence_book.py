"""The Paddle book's sequence programs in the port against the JAX
package, in their padded form (`chip_smoke.BOOK_SEQUENCE`):
understand_sentiment's stacked_lstm_net, label_semantic_roles' db_lstm
with its CRF, and machine_translation's GRU encoder-decoder with a
beam-search step program.

- Program identity at the book's widths: both packages build equal
  `desc.to_dict()` for every program of each (built only).
- Three steps at narrow widths (sentiment emb 16, hid 32, T 12; SRL
  word_dim 16, hid 32, depth 2, T 9; translation vocabulary 50, T 5),
  each from the JAX package's state, resynced by name with
  `convert.scope_from_numpy` (the LSTM, GRU and CRF parameters are
  plain tensors there): the loss at rtol 1e-5 and every trainable
  parameter's gradient within 1e-4 of the step's largest (measured:
  1.0e-6 at most).
- The decodes from one state: SRL's Viterbi paths and chunk counts
  exactly, the translation's beams (ids exactly, scores at rtol 1e-5),
  the sentiment test program's predictions at rtol 1e-5.
- The JAX package's `test_rnn_inference.py::
  test_sentiment_style_model_trains`, `test_crf.py::
  test_srl_style_crf_training_converges` and `test_beam_search.py::
  test_machine_translation_style_decode_loop`, run on the port with the
  same assertions.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import scope_from_numpy

torch.set_num_threads(2)

NARROW = {"sentiment": dict(emb=16, hid=32, T=12),
          "srl": dict(word_dim=16, hid=32, depth=2, T=9),
          "translation": dict(vocab=50, T=5)}
REL = 1e-5
GRAD_REL = 1e-4
PROGRAMS = ("main", "startup", "test", "encoder", "decode")


def _feed(name, rng):
    kw = NARROW[name]
    if name == "sentiment":
        return chip_smoke.sentiment_feed(rng, 8, kw["T"])
    if name == "srl":
        return chip_smoke.srl_feed(rng, 4, kw["T"])
    return chip_smoke.mt_feed(rng, 4, kw["T"], kw["vocab"])


def _dense(v):
    """A fetched value as an array (a sparse gradient comes back as a
    SelectedRows in a 0-d object array)."""
    if isinstance(v, np.ndarray) and v.dtype == object:
        v = v.item()
    return np.asarray(v.to_dense() if hasattr(v, "to_dense") else v)


@pytest.mark.parametrize("name", sorted(chip_smoke.BOOK_SEQUENCE))
def test_program_identity_at_full_width(name):
    build = chip_smoke.BOOK_SEQUENCE[name]
    j, t = build(pt), build(ptt)
    for k in PROGRAMS:
        if k in j:
            assert t[k].desc.to_dict() == j[k].desc.to_dict(), k
    ops = [op.type for op in t["main"].desc.block(0).ops]
    rev = [op.attrs["is_reverse"] for op in t["main"].desc.block(0).ops
           if op.type in ("dynamic_lstm_v2", "gru_v2")]
    if name == "sentiment":
        assert rev == [False, True, False]
        assert ops.count("sequence_pool") == 2 and "adagrad" in ops
    elif name == "srl":
        assert rev == [i % 2 == 1 for i in range(chip_smoke.SRL_DEPTH)]
        assert {"linear_chain_crf", "crf_decoding", "chunk_eval",
                "linear_chain_crf_grad"} <= set(ops)
    else:
        assert rev == [False, False] and "adam" in ops
        step = [op.type for op in t["test"].desc.block(0).ops]
        dec = [op.type for op in t["decode"].desc.block(0).ops]
        assert "beam_search" in step and "gru_v2" in step
        assert dec == ["beam_search_decode", "gather_tree"]


def _pair(name):
    """The narrow program in both packages, the JAX scope after its
    startup, the persistables' and trainable parameters' names."""
    build = chip_smoke.BOOK_SEQUENCE[name]
    j, t = build(pt, **NARROW[name]), build(ptt, **NARROW[name])
    for k in PROGRAMS:
        if k in j:
            assert t[k].desc.to_dict() == j[k].desc.to_dict(), k
    scj = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(j["startup"], scope=scj)
    pers = [v.name for v in j["startup"].list_vars() if v.persistable]
    params = [p.name for p in j["main"].all_parameters() if p.trainable]
    return j, t, scj, pers, params


def _resync(sct, scj, pers):
    return scope_from_numpy(sct, {n: scj.get(n) for n in pers},
                            ptt.CPUPlace())


@pytest.mark.parametrize("name", sorted(chip_smoke.BOOK_SEQUENCE))
def test_three_steps_match_jax(name):
    j, t, scj, pers, params = _pair(name)
    fetch = [j["loss"].name] + [p + "@GRAD" for p in params]
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    sct = ptt.Scope()
    rng = np.random.RandomState(0)
    for step in range(3):
        feed = _feed(name, rng)
        _resync(sct, scj, pers)
        want = [_dense(v) for v in exej.run(j["main"], feed=feed,
                                            fetch_list=fetch, scope=scj)]
        got = [_dense(v) for v in exet.run(t["main"], feed=feed,
                                           fetch_list=fetch, scope=sct)]
        np.testing.assert_allclose(got[0], want[0], rtol=REL)
        scale = max(float(np.abs(w).max()) for w in want[1:])
        for p, g, w in zip(params, got[1:], want[1:]):
            err = float(np.abs(g.astype(np.float64) - w).max())
            assert err <= GRAD_REL * scale, (step + 1, p, err / scale)


def _trained_pair(name, steps=2):
    """Two JAX steps, then both scopes at that state."""
    j, t, scj, pers, _ = _pair(name)
    rng = np.random.RandomState(1)
    exej = pt.Executor(pt.CPUPlace())
    for _ in range(steps):
        exej.run(j["main"], feed=_feed(name, rng), fetch_list=[j["loss"]],
                 scope=scj)
    return j, t, scj, _resync(ptt.Scope(), scj, pers), rng


def test_sentiment_test_program_predicts_as_jax():
    j, t, scj, sct, rng = _trained_pair("sentiment")
    feed = _feed("sentiment", rng)
    want = pt.Executor(pt.CPUPlace()).run(
        j["test"], feed=feed, fetch_list=[j["fetch"]["pred"]], scope=scj)[0]
    got = ptt.Executor(ptt.CPUPlace()).run(
        t["test"], feed=feed, fetch_list=[t["fetch"]["pred"]], scope=sct)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=REL, atol=1e-7)


def test_srl_decode_and_chunks_equal_jax():
    j, t, scj, sct, rng = _trained_pair("srl")
    feed = _feed("srl", rng)
    keys = ("decode", "num_correct", "precision", "recall", "f1")
    want = pt.Executor(pt.CPUPlace()).run(
        j["test"], feed=feed, fetch_list=[j["fetch"][k] for k in keys],
        scope=scj)
    got = ptt.Executor(ptt.CPUPlace()).run(
        t["test"], feed=feed, fetch_list=[t["fetch"][k] for k in keys],
        scope=sct)
    for k, g, w in zip(keys, got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    path = got[0]
    assert path.shape == (4, NARROW["srl"]["T"])
    assert (path[np.arange(path.shape[1])[None] >= feed["ln"][:, None]]
            == 0).all()


def test_translation_beams_equal_jax():
    j, t, scj, sct, rng = _trained_pair("translation")
    src = _feed("translation", rng)["s"][:2]
    want = chip_smoke.mt_decode(pt.Executor(pt.CPUPlace()), j, scj, src)
    got = chip_smoke.mt_decode(ptt.Executor(ptt.CPUPlace()), t, sct, src)
    np.testing.assert_array_equal(got["sent"], want["sent"])
    np.testing.assert_allclose(got["sent_sc"], want["sent_sc"], rtol=REL)
    np.testing.assert_array_equal(got["tree"], want["tree"])
    np.testing.assert_array_equal(got["steps"], want["steps"])
    assert got["sent"].shape == (2, chip_smoke.MT_BEAM, chip_smoke.MT_LEN)


# -- the JAX package's sequence-model tests, run on the port


def test_sentiment_style_model_trains():
    """tests/test_rnn_inference.py's: emb -> lstm -> max pool -> fc,
    Adam 0.01, 30 steps; the loss must halve."""
    rng = np.random.RandomState(0)
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        ids = ptt.layers.data(name="ids", shape=[12, 1], dtype="int64")
        label = ptt.layers.data(name="label", shape=[1], dtype="int64")
        emb = ptt.layers.embedding(input=ids, size=[50, 16])
        emb = ptt.layers.reshape(emb, shape=[-1, 12, 16])
        hidden, _, _ = ptt.layers.lstm(emb, hidden_size=16)
        pooled = ptt.layers.sequence_pool(hidden, "max")
        logits = ptt.layers.fc(input=pooled, size=2)
        loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        ptt.optimizer.Adam(0.01).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    IDS = rng.randint(0, 50, (16, 12, 1)).astype("int64")
    LAB = (IDS[:, 0] % 2).astype("int64")
    losses = [float(np.asarray(exe.run(main, feed={"ids": IDS, "label": LAB},
                                       fetch_list=[loss],
                                       scope=scope)[0]).reshape(()))
              for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5


def test_srl_style_crf_training_converges():
    """tests/test_crf.py's mini label_semantic_roles: embedding and fc
    emission, CRF cost, SGD 0.05, 60 steps; the NLL must halve and the
    decode recover the tag rule (tag = word % 3) on more than 95%."""
    rng = np.random.RandomState(7)
    V, D_TAG, T, N = 20, 3, 8, 16
    words = rng.randint(0, V, (N, T)).astype("int64")
    tags = (words % D_TAG).astype("int64")
    length = np.full((N,), T, "int64")

    main, startup = ptt.Program(), ptt.Program()
    with ptt.framework.unique_name.guard(), ptt.program_guard(main, startup):
        w = ptt.layers.data(name="w", shape=[T], dtype="int64")
        t = ptt.layers.data(name="t", shape=[T], dtype="int64")
        ln = ptt.layers.data(name="ln", shape=[], dtype="int64")
        emb = ptt.layers.embedding(w, size=[V, 16])
        emission = ptt.layers.fc(emb, size=D_TAG, num_flatten_dims=2)
        crf_cost = ptt.layers.linear_chain_crf(
            emission, t, param_attr=ptt.ParamAttr(name="crfw"), length=ln)
        loss = ptt.layers.mean(crf_cost)
        ptt.optimizer.SGD(learning_rate=0.05).minimize(loss)
    infer = ptt.Program()
    with ptt.framework.unique_name.guard(), \
            ptt.program_guard(infer, ptt.Program()):
        w2 = ptt.layers.data(name="w", shape=[T], dtype="int64")
        ln2 = ptt.layers.data(name="ln", shape=[], dtype="int64")
        emb2 = ptt.layers.embedding(w2, size=[V, 16])
        emission2 = ptt.layers.fc(emb2, size=D_TAG, num_flatten_dims=2)
        decode = ptt.layers.crf_decoding(
            emission2, param_attr=ptt.ParamAttr(name="crfw"), length=ln2)

    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        losses = []
        for _ in range(60):
            out = exe.run(main, feed={"w": words, "t": tags, "ln": length},
                          fetch_list=[loss])[0]
            losses.append(float(np.asarray(out).reshape(())))
        assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
        path = exe.run(infer, feed={"w": words, "ln": length},
                       fetch_list=[decode])[0]
        acc = (np.asarray(path) == tags).mean()
        assert acc > 0.95, acc


def test_machine_translation_style_decode_loop():
    """tests/test_beam_search.py's: a 1-layer GRU seq2seq on a copy
    task (Adam 0.01, 150 steps, the loss under 0.3), then a step-by-step
    beam decode with the beam_search op, assembled by
    beam_search_decode; the best beam copies more than 80% of the
    source."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.ir import OpDesc

    rng = np.random.RandomState(5)
    V, T, N, H = 12, 5, 64, 32
    END = 0
    src = rng.randint(2, V, (N, T)).astype("int64")
    tgt_in = np.concatenate([np.full((N, 1), 1, "int64"), src[:, :-1]], 1)
    tgt_out = src.copy()

    main, startup = ptt.Program(), ptt.Program()
    with ptt.framework.unique_name.guard(), ptt.program_guard(main, startup):
        s = ptt.layers.data(name="s", shape=[T], dtype="int64")
        ti = ptt.layers.data(name="ti", shape=[T], dtype="int64")
        to = ptt.layers.data(name="to", shape=[T], dtype="int64")
        semb = ptt.layers.embedding(s, size=[V, H],
                                    param_attr=ptt.ParamAttr(name="semb"))
        _, enc_last = ptt.layers.gru(semb, H,
                                     param_attr=ptt.ParamAttr(name="encg"),
                                     bias_attr=ptt.ParamAttr(name="encb"))
        temb = ptt.layers.embedding(ti, size=[V, H],
                                    param_attr=ptt.ParamAttr(name="temb"))
        dec, _ = ptt.layers.gru(temb, H, h0=enc_last,
                                param_attr=ptt.ParamAttr(name="decg"),
                                bias_attr=ptt.ParamAttr(name="decb"))
        logits = ptt.layers.fc(dec, size=V, num_flatten_dims=2,
                               param_attr=ptt.ParamAttr(name="proj_w"),
                               bias_attr=ptt.ParamAttr(name="proj_b"))
        loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(
            logits, ptt.layers.unsqueeze(to, axes=[2])))
        ptt.optimizer.Adam(learning_rate=0.01).minimize(loss)

    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        losses = [float(np.asarray(exe.run(
            main, feed={"s": src, "ti": tgt_in, "to": tgt_out},
            fetch_list=[loss])[0]).reshape(()))
            for _ in range(150)]
        assert losses[-1] < 0.3, (losses[0], losses[-1])

        K = 3
        step_prog = ptt.Program()
        with ptt.framework.unique_name.guard(), \
                ptt.program_guard(step_prog, ptt.Program()):
            s2 = ptt.layers.data(name="s", shape=[T], dtype="int64")
            h_in = ptt.layers.data(name="h", shape=[K, H], dtype="float32")
            pid = ptt.layers.data(name="pid", shape=[K], dtype="int64")
            psc = ptt.layers.data(name="psc", shape=[K], dtype="float32")
            semb2 = ptt.layers.embedding(
                s2, size=[V, H], param_attr=ptt.ParamAttr(name="semb"))
            _, enc2 = ptt.layers.gru(semb2, H,
                                     param_attr=ptt.ParamAttr(name="encg"),
                                     bias_attr=ptt.ParamAttr(name="encb"))
            pemb = ptt.layers.embedding(
                ptt.layers.unsqueeze(pid, axes=[2]), size=[V, H],
                param_attr=ptt.ParamAttr(name="temb"))
            pemb = ptt.layers.reshape(pemb, [-1, 1, H])
            hr = ptt.layers.reshape(h_in, [-1, H])
            dec2, h_out = ptt.layers.gru(
                pemb, H, h0=hr, param_attr=ptt.ParamAttr(name="decg"),
                bias_attr=ptt.ParamAttr(name="decb"))
            logits2 = ptt.layers.fc(ptt.layers.reshape(dec2, [-1, H]),
                                    size=V,
                                    param_attr=ptt.ParamAttr(name="proj_w"),
                                    bias_attr=ptt.ParamAttr(name="proj_b"))
            probs = ptt.layers.softmax(logits2)
            probs = ptt.layers.reshape(probs, [-1, K, V])
            sel, sc, par = ptt.layers.beam_search(
                pid, psc, None, probs, beam_size=K, end_id=END,
                is_accumulated=False, return_parent_idx=True)
            h_new = ptt.layers.reshape(h_out, [-1, K, H])
        enc_prog = ptt.Program()
        with ptt.framework.unique_name.guard(), \
                ptt.program_guard(enc_prog, ptt.Program()):
            s3 = ptt.layers.data(name="s", shape=[T], dtype="int64")
            semb3 = ptt.layers.embedding(
                s3, size=[V, H], param_attr=ptt.ParamAttr(name="semb"))
            _, enc3 = ptt.layers.gru(semb3, H,
                                     param_attr=ptt.ParamAttr(name="encg"),
                                     bias_attr=ptt.ParamAttr(name="encb"))

        B = 4
        srcb = src[:B]
        enc_state = np.asarray(exe.run(enc_prog, feed={"s": srcb},
                                       fetch_list=[enc3])[0])
        pre_ids = np.full((B, K), 1, "int64")
        pre_sc = np.full((B, K), 0.0, "float32")
        pre_sc[:, 1:] = -1e9
        h = np.tile(enc_state[:, None, :], (1, K, 1)).astype("float32")
        step_ids, step_par, step_sc = [], [], []
        for _ in range(T):
            sel_v, sc_v, par_v, h_v = (np.asarray(v) for v in exe.run(
                step_prog,
                feed={"s": srcb, "h": h, "pid": pre_ids, "psc": pre_sc},
                fetch_list=[sel, sc, par, h_new]))
            h = np.take_along_axis(h_v, par_v[:, :, None].astype(int), 1)
            pre_ids, pre_sc = sel_v, sc_v
            step_ids.append(sel_v)
            step_par.append(par_v)
            step_sc.append(sc_v)
        attrs = {"beam_size": K, "end_id": END}
        desc = OpDesc(type="beam_search_decode", attrs=attrs)
        out = treg.get_op_def("beam_search_decode").call(
            {"Ids": [torch.from_numpy(np.stack(step_ids))],
             "ParentIdx": [torch.from_numpy(np.stack(step_par))],
             "Scores": [torch.from_numpy(np.stack(step_sc))]},
            attrs, treg.KernelCtx(desc, device="cpu"))
        best = out["SentenceIds"][0].numpy()[:, 0, :]
        acc = (best == srcb).mean()
        assert acc > 0.8, (acc, best[:2], srcb[:2])


def test_f22_layers_sums_raises_in_both_packages():
    """`layers.sums(input=[...])` reads its input's dtype before it
    records the input, so it raises in both packages (ROADMAP F22);
    `layers.sum`, the same `sum` op, is what the SRL program calls."""
    for pkg in (pt, ptt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            x = pkg.layers.data(name="x", shape=[3], dtype="float32")
            with pytest.raises(AttributeError, match="dtype"):
                pkg.layers.sums(input=[x, x])
            out = pkg.layers.sum([x, x])
        assert [op.type for op in main.desc.block(0).ops] == ["sum"]
        assert out.dtype is not None
