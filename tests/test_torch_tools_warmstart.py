"""The port's `tools/warmstart.py` against the JAX package's engine: the
phases that a `bake-decode` artifact names are exactly the phase grid
(`_phase_keys()`) of a JAX `DecodeEngine` of the same DecodeConfig,
built and never warmed, for the default, chunked and speculative grids.
An engine of the same seed adopts every phase, from an artifact baked
in this process or in another; another seed or another grid adopts
none. `inspect` runs by file path without importing torch. (The JAX
package's own warmstart round trips fail in every run on record, so
its artifact is no oracle here: the grid is.)"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import jax

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving.decode import DecodeConfig as JDecodeConfig
from paddle_tpu.serving.decode import DecodeEngine as JDecodeEngine

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.observability import events
from paddle_tpu_torch.serving import decode as tdecode
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.tools import load

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOL = os.path.join(_REPO, "paddle_tpu_torch", "tools", "warmstart.py")


WS = load("warmstart")

# the three grids of bake-decode: the flags each adds to the defaults
GRIDS = {"default": [], "chunked": ["--prefill-chunk", "8"],
         "speculative": ["--spec-k", "2"]}


def _run(argv):
    """(rc, stdout) of the tool's main(argv) in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = WS.main(argv)
    return rc, out.getvalue()


def _args(argv):
    """The bake-decode Namespace the tool's parser makes of `argv`."""
    return WS.build_parser().parse_args(["bake-decode"] + argv)


def _phases(path):
    with open(path) as f:
        art = json.load(f)
    return sorted((e["phase"], e["size"]) for e in art["entries"])


def _jax_phase_keys(extra):
    """`_phase_keys()` of a JAX DecodeEngine in bake-decode's config for
    the flags `extra`, never warmed."""
    a = _args(["--out", "unused", "--cpu"] + extra)
    cfg = jgpt.GPTConfig.tiny()
    params, _ = jgpt.init(jax.random.key(a.seed), cfg)
    max_len = a.max_len or cfg.max_len
    slots = sorted({int(s) for s in a.slots.split(",")})
    kw = {"prefill_chunk": a.prefill_chunk} if a.prefill_chunk else {
        "prefill_buckets": sorted({int(b) for b in
                                   a.prefill_buckets.split(",")})}
    dc = JDecodeConfig(block_size=a.block_size,
                       num_blocks=1 + max(slots) * -(-max_len //
                                                    a.block_size),
                       decode_slots=slots, max_len=max_len,
                       precision=a.precision, spec_k=a.spec_k, **kw)
    eng = JDecodeEngine(params, cfg, dc,
                        draft=(params, cfg) if a.spec_k else None)
    try:
        return sorted(eng._phase_keys())
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def baked(tmp_path_factory):
    """{grid: (artifact path, bake line)} for seed 0 on the CPU."""
    root = tmp_path_factory.mktemp("ws")
    out = {}
    for name, extra in GRIDS.items():
        path = str(root / f"{name}.warmstart")
        rc, text = _run(["bake-decode", "--out", path, "--cpu"] + extra)
        assert rc == 0, text
        out[name] = (path, json.loads(text))
    return out


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_bake_decode_names_the_jax_engines_phase_grid(baked, grid):
    path, line = baked[grid]
    want = _jax_phase_keys(GRIDS[grid])
    assert _phases(path) == want
    assert line["entries"] == line["phases_ready"] == len(want)
    # the bake line's keys are the JAX tool's
    assert set(line) == {"artifact", "preset", "seed", "phase_grid",
                         "phases_ready", "entries", "precision",
                         "warmup_seconds", "artifact_bytes"}


def _adopted(argv, path):
    """(phases adopted, the last warmstart event) of an engine that
    bake-decode would build from `argv`, loading `path`."""
    eng = WS.decode_engine(_args(["--out", "unused", "--cpu"] + argv))
    try:
        n = eng.load_warmstart(path)
    finally:
        eng.stop()
    return n, events.recent(1, kind="warmstart")[-1]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_same_seed_adopts_every_phase_and_others_none(baked, grid):
    path, line = baked[grid]
    n, ev = _adopted(GRIDS[grid], path)
    assert n == line["entries"] > 0 and ev["action"] == "load_decode"
    # another seed: the model digest differs
    n, ev = _adopted(GRIDS[grid] + ["--seed", "1"], path)
    assert n == 0 and ev["action"] == "reject" and "digest" in ev["reason"]
    # another grid: one slot count fewer
    n, ev = _adopted(GRIDS[grid] + ["--slots", "4"], path)
    assert n == 0 and ev["action"] == "reject"


def test_another_process_bakes_what_this_one_adopts(tmp_path):
    """The weights come from a CPU generator: a bake in a fresh process
    has this process's model digest."""
    path = str(tmp_path / "sub.warmstart")
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.warmstart",
         "bake-decode", "--out", path, "--cpu", "--spec-k", "2"],
        cwd=_REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout)
    assert _adopted(["--spec-k", "2"], path)[0] == line["entries"] > 0


_INSPECT_PROBE = r"""
import importlib.util, json, sys
tool, art = sys.argv[1:3]
spec = importlib.util.spec_from_file_location("_ws", tool)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
rc = mod.main(["inspect", art])
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("torch", "numpy", "paddle_tpu_torch", "jax", "paddle_tpu"))
assert not bad, bad
sys.exit(rc)
"""


def test_inspect_by_file_path_imports_no_torch(baked):
    path, line = baked["speculative"]
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", _INSPECT_PROBE, _TOOL, path],
                       capture_output=True, text=True, timeout=60, env=env)
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout)
    assert rep["format"] == tdecode.DECODE_WARMSTART_FORMAT
    assert rep["entries"] == line["entries"]
    assert sorted(s["phase"] for s in rep["signatures"]) == sorted(
        f"{k}@{n}" for k, n in _phases(path))
    assert rep["phase_grid"] == {"decode": [4, 8], "prefill": [8, 16, 32],
                                 "spec_k": 2}


def test_inspect_names_every_environment_key():
    assert set(WS.ENV_KEYS) == set(compile_cache.environment_meta("cpu"))
    assert WS.DECODE_FORMAT == tdecode.DECODE_WARMSTART_FORMAT


def _save_mlp(dirname):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[12], dtype="float32")
        pred = pt.layers.fc(input=x, size=3, act="softmax")
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    pt.io.save_inference_model(dirname, ["x"], [pred], exe,
                               main_program=main)


def test_bake_and_inspect_a_predict_artifact(tmp_path):
    model = str(tmp_path / "model")
    _save_mlp(model)
    path = str(tmp_path / "p.warmstart")
    rc, text = _run(["bake", "--model-dir", model, "--out", path,
                     "--buckets", "1,2,4", "--cpu"])
    assert rc == 0
    line = json.loads(text)
    assert line["buckets"] == [1, 2, 4] and line["entries"] == 3
    assert line["buckets_ready"] == 3
    with open(path) as f:
        assert json.load(f)["format"] == tengine.WARMSTART_FORMAT
    rc, text = _run(["inspect", path])
    rep = json.loads(text)
    assert rc == 0 and rep["buckets"] == [1, 2, 4]
    assert [s["feeds"] for s in rep["signatures"]] == [
        [f"x:[{b}, 12]:float32"] for b in (1, 2, 4)]
    # an engine of the same program adopts every bucket
    eng = tengine.Engine(tengine.ServingConfig(
        model, buckets=(1, 2, 4), use_tpu=False, warmstart=path))
    assert eng.warmstart_adopted == 3


@pytest.mark.parametrize("content,what", [
    (b"\x80\x04not json", "cannot read"),
    (b'{"format": "x"}', "not a warmstart artifact"),
    (b'{"entries": [{"signature": 3}]}', "malformed"),
    (b'{"format": "paddle_tpu_torch-decode-warmstart-v1", '
     b'"entries": [{"size": 4}]}', "malformed")])
def test_inspect_refuses_a_broken_artifact(tmp_path, capsys, content, what):
    path = tmp_path / "bad.warmstart"
    path.write_bytes(content)
    assert WS.main(["inspect", str(path)]) == 2
    assert what in capsys.readouterr().err


def test_bake_decode_refuses_an_unknown_preset(tmp_path, capsys):
    assert WS.main(["bake-decode", "--out", str(tmp_path / "x"),
                    "--preset", "gpt2", "--cpu"]) == 2
    assert "unknown --preset" in capsys.readouterr().err


def test_without_cpu_the_tool_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WS.main(["bake-decode", "--out", str(tmp_path / "x")])
