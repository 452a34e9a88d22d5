"""The Paddle book's programs that need the fluid op library's core, in
the port against the JAX package: the image classifier VGG-16-BN
(`chip_smoke.vgg_bn_program`, the book's `vgg_bn_drop` on CIFAR-10
shapes) and the three embedding programs of `tests/test_book.py`
(`chip_smoke.BOOK_EMBEDDING`: `lookup_table`, `cos_sim`,
`hierarchical_sigmoid`).

- Program identity: VGG-16-BN at the book's widths, built in both
  packages, gives equal `desc.to_dict()` for main, startup and the
  `for_test` clone (built only; nothing runs at that size here).
- Three steps at narrow widths (channels / 8, batch 8, every drop rate
  0: the packages' dropout streams differ), each from the JAX
  package's state (resynced, as `test_torch_fluid_program.py` does):
  the loss at rtol 1e-5, the accuracy exactly, the batch norms'
  running means and variances within 1e-5 of their largest values,
  and the gradients in `chip_smoke.vgg_grad_errors`' two classes,
  against the step's largest gradient: those above the last batch norm
  within 1e-4 (measured: 4.9e-5), those under a batch norm within 1e-3
  (measured: 2.3e-5). The JAX package's batch norm takes a one-pass f32
  variance, whose gradient carries a per-channel term set by rounding:
  its own one-device and 8-device steps differ by up to 2.5e-2 of the
  step's largest gradient under a batch norm at batch 32 (ROADMAP
  F13).
- The `for_test` clone from the trained scope: the same predictions
  within 1e-5, and the running stats left as they were.
- The embedding programs build the JAX package's descs and train on the
  port as `tests/test_book.py` requires of the JAX package.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import scope_from_numpy

torch.set_num_threads(2)

NARROW = dict(drop=0.0, width=8)
BATCH = 8
REL = 1e-5
GRAD_REL = 1e-4
UNDER_BN_REL = 1e-3


def _vgg_feed(rng, bs=BATCH):
    return {"img": rng.standard_normal((bs, 3, 32, 32)).astype("float32"),
            "label": rng.randint(0, 10, (bs, 1)).astype("int64")}


def _close(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max(initial=0.0)
    assert err <= REL * np.abs(want).max(initial=0.0), (what, float(err))


def test_vgg_program_identity_at_full_width():
    mj, sj, tj, _, _ = chip_smoke.vgg_bn_program(pt)
    mt, st, tt, _, _ = chip_smoke.vgg_bn_program(ptt)
    assert mt.desc.to_dict() == mj.desc.to_dict()
    assert st.desc.to_dict() == sj.desc.to_dict()
    assert tt.desc.to_dict() == tj.desc.to_dict()
    types = [op.type for op in mt.desc.block(0).ops]
    assert types.count("batch_norm") == 14 and "cross_entropy" in types
    assert types.count("conv2d") == 13 and types.count("dropout") == 10
    assert all(op.attrs.get("is_test") for op in tt.desc.block(0).ops
               if op.type in ("batch_norm", "dropout"))


def _vgg_pair():
    """The narrow VGG-16-BN in both packages, the JAX scope after its
    startup, and the persistables' names."""
    jax_prog = chip_smoke.vgg_bn_program(pt, **NARROW)
    port_prog = chip_smoke.vgg_bn_program(ptt, **NARROW)
    assert port_prog[0].desc.to_dict() == jax_prog[0].desc.to_dict()
    scj = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(jax_prog[1], scope=scj)
    pers = [v.name for v in jax_prog[1].list_vars() if v.persistable]
    return jax_prog, port_prog, scj, pers


def _resync(sct, scj, pers):
    return scope_from_numpy(sct, {n: scj.get(n) for n in pers},
                            ptt.CPUPlace())


def test_vgg_three_steps_match_jax():
    (mj, _, _, lj, aj), (mt, _, _, lt, at), scj, pers = _vgg_pair()
    params = [p.name for p in mj.all_parameters() if p.trainable]
    stats = chip_smoke.bn_stat_names(mj)
    assert len(stats) == 28
    fetch = [lj.name, aj.name] + [p + "@GRAD" for p in params]
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    sct = ptt.Scope()
    rng = np.random.RandomState(0)
    for step in range(3):
        feed = _vgg_feed(rng)
        _resync(sct, scj, pers)
        want = exej.run(mj, feed=feed, fetch_list=fetch, scope=scj)
        got = exet.run(mt, feed=feed, fetch_list=fetch, scope=sct)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_array_equal(got[1], want[1])
        errs = chip_smoke.vgg_grad_errors(mj, params, got[2:], want[2:])
        assert errs["grad"] <= GRAD_REL and \
            errs["grad_under_bn"] <= UNDER_BN_REL, (step + 1, errs)
        for n in stats:
            _close(sct.get(n), scj.get(n), f"{n} step {step + 1}")


def test_vgg_for_test_clone_matches_jax():
    """Two training steps on the JAX side, then the clone's predictions
    in both from that state; the clone leaves the running stats be."""
    (mj, _, tj, lj, _), (_, _, tt, _, _), scj, pers = _vgg_pair()
    exej = pt.Executor(pt.CPUPlace())
    rng = np.random.RandomState(1)
    for _ in range(2):
        exej.run(mj, feed=_vgg_feed(rng), fetch_list=[lj], scope=scj)
    sct = _resync(ptt.Scope(), scj, pers)
    stats = chip_smoke.bn_stat_names(mj)
    before = {n: sct.get(n).copy() for n in stats}
    predict = next(op.inputs["X"][0] for op in tt.desc.block(0).ops
                   if op.type == "cross_entropy")
    feed = _vgg_feed(rng)
    want = exej.run(tj, feed=feed, fetch_list=[predict], scope=scj)[0]
    got = ptt.Executor(ptt.CPUPlace()).run(tt, feed=feed,
                                           fetch_list=[predict], scope=sct)[0]
    _close(got, want, "the clone's predictions")
    for n in stats:
        np.testing.assert_array_equal(sct.get(n), before[n])


@pytest.mark.parametrize("name", sorted(chip_smoke.BOOK_EMBEDDING))
def test_book_embedding_program_trains(name):
    """The JAX package's desc, and the loss falls as `tests/test_book.py`
    requires."""
    build = chip_smoke.BOOK_EMBEDDING[name]
    main, startup, loss = build(ptt)
    assert main.desc.to_dict() == build(pt)[0].desc.to_dict()
    feed, steps, share = chip_smoke.book_embedding_feeds()[name]
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].reshape(()))
              for _ in range(steps)]
    assert losses[-1] < losses[0] * share, (losses[0], losses[-1])
