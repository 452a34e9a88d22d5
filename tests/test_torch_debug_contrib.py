"""`paddle_tpu_torch.debugger` and `paddle_tpu_torch.contrib` against the
JAX package's on the book's VGG-16-BN program (`chip_smoke.vgg_bn_program`,
built in each package): the same DOT text and node gauges, and the same
`memory_usage` band, `op_freq_statistic` counts and `summary` totals."""

import os

import pytest

import paddle_tpu as pj
import paddle_tpu_torch as ptt

import chip_smoke

_PKGS = {"jax": pj, "torch": ptt}


def _vgg(pkg, width=1):
    return chip_smoke.vgg_bn_program(_PKGS[pkg], width=width)


def _dot_gauge(dbg):
    """The node counts the last rendering set on the debugger's gauge."""
    return {kind: dbg.DOT_NODES.value(kind=kind) for kind in ("op", "var")}


@pytest.mark.parametrize("which", ["main", "test_program"])
def test_dot_text_equals_the_jax_packages(which):
    from paddle_tpu import debugger as jdbg

    from paddle_tpu_torch import debugger as tdbg

    progs = {}
    for pkg in _PKGS:
        main, _, test_prog, _, _ = _vgg(pkg)
        progs[pkg] = main if which == "main" else test_prog
    hi = [progs["jax"].global_block().desc.ops[3].output_names()[0]]
    skip = ["label"]
    want = jdbg.block_to_dot(progs["jax"].global_block(), skip_vars=skip,
                             highlight=hi)
    got = tdbg.block_to_dot(progs["torch"].global_block(), skip_vars=skip,
                            highlight=hi)
    assert got == want
    assert got.startswith("digraph program {") and got.endswith("}")
    assert _dot_gauge(tdbg) == _dot_gauge(jdbg)
    assert tdbg.DOT_NODES.name == jdbg.DOT_NODES.name
    assert _dot_gauge(tdbg)["op"] == len(
        progs["torch"].global_block().desc.ops)


def test_draw_program_writes_the_dot_text(tmp_path):
    from paddle_tpu import debugger as jdbg

    from paddle_tpu_torch import debugger as tdbg

    paths = {}
    for name, dbg, pkg in (("jax", jdbg, "jax"), ("torch", tdbg, "torch")):
        main, *_ = _vgg(pkg, width=8)
        paths[name] = dbg.draw_program(main, path=str(tmp_path / f"{name}.dot"))
    texts = {k: open(p).read() for k, p in paths.items()}
    assert texts["torch"] == texts["jax"]
    # the default path lies in the temp directory, which honours TMPDIR
    main, *_ = _vgg("torch", width=8)
    old = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = str(tmp_path)
    import tempfile

    tempfile.tempdir = None
    try:
        p = tdbg.draw_program(main)
    finally:
        if old is None:
            os.environ.pop("TMPDIR")
        else:
            os.environ["TMPDIR"] = old
        tempfile.tempdir = None
    assert p == str(tmp_path / "program.dot") and os.path.exists(p)


@pytest.mark.parametrize("batch", [1, 32, 128])
def test_memory_usage_equals_the_jax_packages(batch):
    from paddle_tpu.contrib import memory_usage as jmem

    from paddle_tpu_torch.contrib import memory_usage as tmem

    for which in (0, 2):
        want = jmem(_vgg("jax")[which], batch)
        got = tmem(_vgg("torch")[which], batch)
        assert got == want
        lower, upper, unit = got
        assert 0 < lower <= upper and unit in ("KB", "MB", "GB")


def test_op_freq_statistic_equals_the_jax_packages():
    from paddle_tpu.contrib import op_freq_statistic as jfreq

    from paddle_tpu_torch.contrib import op_freq_statistic as tfreq

    want = jfreq(_vgg("jax")[0])
    got = tfreq(_vgg("torch")[0])
    assert got == want
    uni = dict(got[0])
    assert uni["conv2d"] == 13 and uni["batch_norm"] == 14
    assert dict(got[1])["elementwise_add,batch_norm"] == 14


def test_summary_equals_the_jax_packages(capsys):
    from paddle_tpu.contrib import summary as jsum

    from paddle_tpu_torch.contrib import summary as tsum

    for batch in (1, 32):
        want = jsum(_vgg("jax")[2], batch)
        want_text = capsys.readouterr().out
        got = tsum(_vgg("torch")[2], batch)
        assert got == want
        assert capsys.readouterr().out == want_text
    params, flops = got
    assert params > 14e6 and flops > 0


def test_contrib_refuses_what_is_not_a_program():
    from paddle_tpu_torch.contrib import (memory_usage, op_freq_statistic,
                                          summary)

    for fn in (lambda: memory_usage(object(), 1),
               lambda: op_freq_statistic([]), lambda: summary("x")):
        with pytest.raises(TypeError, match="expects a Program"):
            fn()
    with pytest.raises(ValueError, match="positive"):
        memory_usage(_vgg("torch", width=8)[0], 0)
