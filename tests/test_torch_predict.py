"""The port's predict path on the CPU against the JAX package: the int8
runtime ops, model dirs across packages, post-training int8, the
analysis passes, the Predictor, the Batcher, the Engine and POST
/v1/predict.

Tolerances, each measured here:
- The three `quantized_*` ops equal the JAX ops bit for bit at f32: the
  same f32 activation quantization, exact int32 sums, the same f32
  dequantization order.
- A model dir's f32 replies through the other package's Predictor: the
  LeNet rung's logits differ only by the order of f32 sums in the convs
  and products (measured under 1e-6 of the largest logit; held to 1e-5).
- bf16 replies, the port's Predictor and Engine against the JAX
  package's bf16 Predictor on the same dir and rows: measured equal bit
  for bit (both cast the params once and the feed to bf16, and round
  each op's result to bf16); held to half a bf16 step (2**-8) of the
  largest |logit|, room for a sum order moving one small logit's
  rounding. bf16 itself moves the logits by 1.4-2.7 such steps from
  f32 (0.54-1.07% of the largest, measured), so a missed cast fails.
- `calibrate_and_quantize` in both packages from one dir: the same
  program and the same int8 weights and weight scales, bit for bit.
  The activation scales are each package's own f32 forward's abs-max
  over 127: the first conv's input is the feed itself (equal bit for
  bit), the later ones differ by f32 rounding of the activations
  (measured under 1e-6 relative; held to 1e-5). The int8 replies of the
  two packages' Predictors on the same quantized dir: an activation
  value that lands on a rounding boundary moves by one int8 step, so
  they are held to 1e-3 of the largest logit (measured under 1e-5).
- `validate_program`'s findings equal the JAX package's exactly.
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import analysis as janalysis
from paddle_tpu.core import ir as jir
from paddle_tpu.inference import AnalysisConfig as JAnalysisConfig
from paddle_tpu.inference import create_paddle_predictor as jcreate
from paddle_tpu.ops import quant as jquant
from paddle_tpu.slim import quantization as jslim

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.ops import quant as tquant
from paddle_tpu_torch.serving import (Batcher, BucketPolicy, Engine,
                                      EngineError, QueueFullError,
                                      RequestTimeout, Server, ServerClosed,
                                      ServingConfig)
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.slim import quantization as tslim

from chip_smoke import lenet_rung_logits, lenet_rung_program, synthetic_mnist

torch.set_num_threads(2)

F32_REPLY_TOL = 1e-5
ACT_SCALE_RTOL = 1e-5
INT8_REPLY_TOL = 1e-3
BF16_REPLY_STEPS = 0.5
BF16_STEP = 2.0 ** -8


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the int8 runtime ops ---------------------------------------------------


def _int8_weight(rs, shape, axis):
    w = rs.normal(0, 0.3, shape).astype(np.float32)
    q, s = tslim._quantize_array(w, axis=axis)
    return q, s


OP_CASES = {
    "conv_groups_dilation_pads4_bias": (
        "quantized_conv2d", {"strides": [2, 1], "paddings": [1, 2, 0, 1],
                             "dilations": [2, 1], "groups": 2}),
    "conv_pads2": ("quantized_conv2d", {"strides": [1, 1],
                                        "paddings": [1, 1]}),
    "mul_x_num_col_dims_2": ("quantized_mul", {"x_num_col_dims": 2}),
    "matmul_3d": ("quantized_matmul", {}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_quantized_ops_match_jax_bit_for_bit(case):
    op, attrs = OP_CASES[case]
    rs = np.random.RandomState(len(case))
    if op == "quantized_conv2d":
        x = rs.normal(size=(2, 4, 9, 8)).astype(np.float32)
        q, s = _int8_weight(rs, (6, 4 // attrs.get("groups", 1), 3, 3), 0)
        ins = {"Input": [x], "Filter": [q], "Scale": [s]}
        if "bias" in case:
            ins["Bias"] = [rs.normal(size=(6,)).astype(np.float32)]
        out = "Output"
    else:
        x = rs.normal(size=(2, 3, 5)).astype(np.float32)
        q, s = _int8_weight(rs, (5, 7), -1)
        ins = {"X": [x], "Y": [q], "Scale": [s]}
        out = "Out"
    attrs = dict(attrs, x_scale=float(np.abs(x).max() / 127.0) * 0.9)
    fn = {"quantized_conv2d": (jquant.quantized_conv2d,
                               tquant.quantized_conv2d),
          "quantized_mul": (jquant.quantized_mul, tquant.quantized_mul),
          "quantized_matmul": (jquant.quantized_matmul,
                               tquant.quantized_matmul)}[op]
    want = np.asarray(fn[0]({k: [jnp.asarray(v) for v in vs]
                             for k, vs in ins.items()}, attrs, None)[out])
    got = fn[1]({k: [_t(v) for v in vs] for k, vs in ins.items()}, attrs,
                None)[out]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_registry_holds_the_three_int8_ops():
    """The registry against the JAX package's: every op registered at
    import is one of its op types, 392 of them (ROADMAP item 15 counts
    403 there): 104 through the predict path's slice, then the 17 c_*
    ops and increment, equal, cond, assign, lookup_table_v2 and
    one_hot_v2 of the fluid path's data parallelism, then the other
    125 of the JAX package's ops/compare.py, tensor.py, nn.py,
    classify.py and control_flow.py, then the other 14 optimizer ops,
    the three SelectedRows ops of misc.py and its log_loss, then the
    five the dygraph layers reach (misc.py's conv3d_transpose, row_conv
    and spectral_norm, sequence_conv and tree_conv), then the 33 of the
    sequence models (the other 16 of sequence.py, rnn.py's 8, crf.py's
    3, beam.py's 3, and metrics_ops.py's auc, precision_recall and
    positive_negative_pair), then quant.py's ten fake-quant ops and the
    other 33 of misc.py, then text_match.py's other 9 and detection.py's
    32. The
    `*_grad` defs a lookup makes
    (after a program was differentiated in this process) are not
    counted."""
    from paddle_tpu.core import registry as jregistry
    from paddle_tpu_torch.core import registry

    for op in ("quantized_mul", "quantized_matmul", "quantized_conv2d"):
        assert registry.has_op(op)
        assert registry.get_op_def(op).grad is None
    ported = registry.registered_ops(made_at_lookup=False)
    assert set(ported) <= set(jregistry.registered_ops())
    assert len(ported) == 392


def test_registry_count_holds_after_the_fluid_program_tests():
    """The count of the test above after tests/test_torch_fluid_program.py
    ran in the same process (differentiating its programs makes
    `*_grad` defs at lookup), with a `*_grad` lookup made here too."""
    import subprocess
    import sys

    from paddle_tpu_torch.core import registry

    assert registry.has_op("mul_grad")
    assert "mul_grad" in registry.registered_ops()
    assert "mul_grad" not in registry.registered_ops(made_at_lookup=False)
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", os.path.join(here, "test_torch_fluid_program.py"),
         os.path.join(here, "test_torch_predict.py") +
         "::test_registry_holds_the_three_int8_ops"],
        cwd=os.path.dirname(here), capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert " passed" in r.stdout and "failed" not in r.stdout


# -- model dirs across packages --------------------------------------------


def _train_and_save(pt, dirname, steps=3):
    """The LeNet rung built with `pt`, a few Adam steps on the CPU, then
    saved as an inference model fetching the logits."""
    main, startup, loss = lenet_rung_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    x, y = synthetic_mnist(64, seed=1)
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            exe.run(main, feed={"x": x, "y": y}, fetch_list=[loss])
        pt.io.save_inference_model(dirname, ["x"], [lenet_rung_logits(main)],
                                   exe, main_program=main)
    return x


def _port_predictor(dirname, precision=None, buckets=None):
    cfg = AnalysisConfig(dirname)
    cfg.disable_gpu()
    if precision:
        cfg.set_precision(precision)
    if buckets:
        cfg.enable_bucketing(buckets=buckets)
    return create_paddle_predictor(cfg)


def _jax_predictor(dirname, precision=None):
    cfg = JAnalysisConfig(dirname)
    cfg.disable_gpu()
    if precision:
        cfg.set_precision(precision)
    return jcreate(cfg)


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_model") / "lenet")
    _train_and_save(jfluid, d)
    return d


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_model") / "lenet")
    _train_and_save(tfluid, d)
    return d


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_model_dir_serves_equal_f32_replies_in_both_packages(
        saved_by, jax_dir, port_dir):
    d = jax_dir if saved_by == "jax" else port_dir
    with open(os.path.join(d, "__model__")) as f:
        payload = json.load(f)
    assert payload["feed_names"] == ["x"]
    x = synthetic_mnist(5, seed=2)[0]
    want = _jax_predictor(d).predict(x=x)
    pred = _port_predictor(d)
    got = pred.predict(x=x)
    assert list(got) == list(want) == pred.get_output_names()
    for name in want:
        assert got[name].shape == want[name].shape
        gap = _gap(got[name], np.asarray(want[name]))
        print(f"{saved_by} dir, f32 replies: {gap:.3g}")
        assert gap <= F32_REPLY_TOL


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_bf16_replies_equal_the_jax_packages(saved_by, jax_dir, port_dir):
    """The port's bf16 Predictor, and its bf16 Engine (bucket-padded
    batches), against the JAX package's bf16 Predictor on the same rows;
    both far from the f32 replies, so the cast really happened."""
    d = jax_dir if saved_by == "jax" else port_dir
    jbf = _jax_predictor(d, precision="bf16")
    jf32 = _jax_predictor(d)
    pred = _port_predictor(d, precision="bf16")
    eng = Engine(_engine_cfg(d, precision="bf16", buckets=(4, 8)))
    name = pred.get_output_names()[0]
    for n in (1, 3, 8):
        x = synthetic_mnist(n, seed=30 + n)[0]
        want = np.asarray(jbf.predict(x=x)[name], np.float64)
        f32 = np.asarray(jf32.predict(x=x)[name], np.float64)
        bf16_move = _gap(want, f32)
        assert bf16_move > 2 * BF16_REPLY_STEPS * BF16_STEP
        for who, got in (("predictor", pred.predict(x=x)[name]),
                         ("engine", eng.run_batch({"x": x})[name])):
            assert got.shape == want.shape == (n, 10)
            steps = _gap(got, want) / BF16_STEP
            print(f"{saved_by} dir, {who}, {n} rows: {steps:.3g} bf16 "
                  f"steps from the JAX package (bf16 moved f32 by "
                  f"{bf16_move:.3g})")
            assert steps <= BF16_REPLY_STEPS


def test_io_round_trips_persistables_across_packages(jax_dir, tmp_path):
    """The port loads the JAX package's .npy files into its scope and
    saves them back unchanged (save_persistables and the combined
    .npz); the JAX package loads the port's."""
    prog, feeds, fetches = None, None, None
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        prog, feeds, fetches = tfluid.io.load_inference_model(jax_dir, exe)
        names = [v.name for v in tfluid.io.get_program_persistable_vars(prog)]
        assert names and all(isinstance(scope.find_var(n), torch.Tensor)
                             for n in names)
        tfluid.io.save_persistables(exe, str(tmp_path / "npy"),
                                    main_program=prog)
        tfluid.io.save_persistables(exe, str(tmp_path / "npz"),
                                    main_program=prog, filename="all.npz")
    for n in names:
        src = np.load(os.path.join(jax_dir, tfluid.io.var_filename(n)
                                   + ".npy"))
        np.testing.assert_array_equal(
            np.load(str(tmp_path / "npy" / (n + ".npy"))), src)
        np.testing.assert_array_equal(
            np.load(str(tmp_path / "npz" / "all.npz"))[n], src)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jprog, _, _ = jfluid.io.load_inference_model(jax_dir, jexe)
        jfluid.io.load_persistables(jexe, str(tmp_path / "npz"),
                                    main_program=jprog, filename="all.npz")
        for n in names:
            np.testing.assert_array_equal(np.asarray(jscope.find_var(n)),
                                          scope.get(n))


# -- post-training int8 -----------------------------------------------------


def _calibration(n_batches=3, rows=16):
    x, _ = synthetic_mnist(n_batches * rows, seed=3)
    return lambda: iter([{"x": x[i:i + rows]}
                         for i in range(0, len(x), rows)])


@pytest.fixture(scope="module")
def quantized(jax_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("ptq")
    src_j, src_t = str(root / "src_j"), str(root / "src_t")
    shutil.copytree(jax_dir, src_j)
    shutil.copytree(jax_dir, src_t)
    out_j, out_t = str(root / "q_j"), str(root / "q_t")
    scales_j = jslim.calibrate_and_quantize(src_j, _calibration(),
                                            save_model_path=out_j)
    scales_t = tslim.calibrate_and_quantize(src_t, _calibration(),
                                            save_model_path=out_t,
                                            place=tfluid.CPUPlace())
    return out_j, out_t, scales_j, scales_t


def _x_scales(payload):
    return {i: op["attrs"].pop("x_scale")
            for i, op in enumerate(payload["program"]["blocks"][0]["ops"])
            if "x_scale" in op["attrs"]}


def test_calibrate_and_quantize_writes_what_the_jax_package_writes(
        quantized):
    out_j, out_t, scales_j, scales_t = quantized
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_t))
    with open(os.path.join(out_j, "__model__")) as f:
        pj = json.load(f)
    with open(os.path.join(out_t, "__model__")) as f:
        pt = json.load(f)
    xj, xt = _x_scales(pj), _x_scales(pt)
    aj, at = pj.pop("act_scales"), pt.pop("act_scales")
    assert pj == pt                 # the same program, x_scale aside
    types = [op["type"] for op in pt["program"]["blocks"][0]["ops"]]
    assert types.count("quantized_conv2d") == 2 and \
        types.count("quantized_mul") == 3
    assert set(xj) == set(xt) and set(aj) == set(at) == set(scales_t)
    assert at["x"] == aj["x"]       # the feed itself
    gaps = {k: abs(at[k] - aj[k]) / aj[k] for k in aj}
    print(f"activation scales, relative gaps: {gaps}")
    for k in aj:
        assert gaps[k] <= ACT_SCALE_RTOL, k
    for i in xj:
        assert abs(xt[i] - xj[i]) <= ACT_SCALE_RTOL * xj[i]
    for fn in os.listdir(out_j):
        if fn.endswith(".npy"):
            a, b = np.load(os.path.join(out_j, fn)), \
                np.load(os.path.join(out_t, fn))
            assert a.dtype == b.dtype, fn
            np.testing.assert_array_equal(a, b, err_msg=fn)
    with open(os.path.join(out_j, tslim.QUANT_META_FILE)) as f:
        mj = json.load(f)
    with open(os.path.join(out_t, tslim.QUANT_META_FILE)) as f:
        assert json.load(f) == mj


def test_int8_replies_equal_in_both_packages(quantized):
    out_j, out_t, _, _ = quantized
    x = synthetic_mnist(6, seed=4)[0]
    want = _jax_predictor(out_j).predict(x=x)
    for d in (out_j, out_t):
        got = _port_predictor(d).predict(x=x)
        for name in want:
            gap = _gap(got[name], np.asarray(want[name]))
            print(f"int8 replies ({os.path.basename(d)}): {gap:.3g}")
            assert gap <= INT8_REPLY_TOL


def test_weight_only_quantization_round_trips(jax_dir, tmp_path):
    """quantize_inference_model's <w>@INT8/<w>@SCALE files load back
    through load_quantized_vars to the JAX package's float weights."""
    for mod, d in ((jslim, tmp_path / "j"), (tslim, tmp_path / "t")):
        mod.quantize_inference_model(jax_dir, str(d))
    assert sorted(os.listdir(tmp_path / "j")) == \
        sorted(os.listdir(tmp_path / "t"))
    want = jslim.load_quantized_vars(str(tmp_path / "j"))
    got = tslim.load_quantized_vars(str(tmp_path / "t"))
    assert set(got) == set(want) and want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    x = synthetic_mnist(3, seed=5)[0]
    a = _port_predictor(str(tmp_path / "t")).predict(x=x)
    b = _jax_predictor(str(tmp_path / "j")).predict(x=x)
    for name in b:
        assert _gap(a[name], np.asarray(b[name])) <= F32_REPLY_TOL


# -- analysis ----------------------------------------------------------------


def test_validate_program_findings_equal_the_jax_packages(jax_dir):
    with open(os.path.join(jax_dir, "__model__")) as f:
        payload = json.load(f)
    prog = payload["program"]
    block = prog["blocks"][0]
    # a dangling input: the last op reads a var nothing writes
    block["ops"][-1]["inputs"].setdefault("Y", []).append("ghost")
    out = []
    for ir, an in ((jir, janalysis), (tir, tanalysis)):
        desc = ir.ProgramDesc.from_dict(prog)
        findings = an.validate_program(
            desc, feed_names=payload["feed_names"],
            fetch_names=payload["fetch_names"] + ["never_made"],
            is_test=True, level=0)
        out.append([f.to_dict() for f in findings])
    assert out[0] == out[1]
    passes = {(f["pass"], f["severity"]) for f in out[1]}
    assert ("def_use", "error") in passes
    assert any(f.get("var") == "ghost" for f in out[1])
    assert any(f.get("var") == "never_made" for f in out[1])
    with pytest.raises(tanalysis.AnalysisError):
        tanalysis.validate_program(tir.ProgramDesc.from_dict(prog),
                                   feed_names=["x"], fetch_names=[],
                                   level=2)
    assert tanalysis.pass_names() == janalysis.pass_names()


# -- the Predictor ------------------------------------------------------------


def test_predictor_buckets_and_signature_cache(port_dir):
    """Bucketed requests of 1-8 rows prepare only their buckets'
    signatures; padded rows are sliced off; warm() runs a bucket once;
    a bf16 policy keeps one signature per bucket (the feed cast to the
    policy's dtype) and casts the params once."""
    pred = _port_predictor(port_dir, buckets=(1, 2, 4, 8))
    assert all(pred.warm(b) for b in (1, 2, 4, 8))
    assert len(pred.signatures()) == 4
    x = synthetic_mnist(8, seed=6)[0]
    full = pred.predict(x=x)
    name = pred.get_output_names()[0]
    for n in (1, 3, 5, 7, 8):
        out = pred.predict(x=x[:n])[name]
        assert out.shape == (n, 10)
        np.testing.assert_allclose(out, full[name][:n], rtol=1e-5,
                                   atol=1e-6)
    assert len(pred.signatures()) == 4
    assert {s[0][1][0] for s in pred.signatures()} == {1, 2, 4, 8}
    bf = _port_predictor(port_dir, precision="bf16", buckets=(4, 8))
    bf.predict(x=x[:3])
    bf.predict(x=x[:6])
    sigs = bf.signatures()
    assert len(sigs) == 2 and all(s[0][2] == "bfloat16" for s in sigs)
    state = bf._program_state()
    assert all(v.dtype == torch.bfloat16 for v in state.values()
               if v.is_floating_point())
    assert bf._program_state() is state           # cast once, shared
    h = pred.predict_handle(x=x[:2])
    assert set(h.result()) == {name}


def test_predictor_runs_on_the_card_by_default(port_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        create_paddle_predictor(AnalysisConfig(port_dir))
    with pytest.raises(NotImplementedError, match="item 21"):
        AnalysisConfig(port_dir).enable_native_engine()


# -- the Batcher ----------------------------------------------------------------


class _Gate:
    """A run_batch that records each batch's rows and blocks until
    released."""

    def __init__(self, block=False, fail=False):
        self.batches = []
        self.release = threading.Event()
        if not block:
            self.release.set()
        self.fail = fail

    def __call__(self, feeds):
        self.batches.append(int(feeds["x"].shape[0]))
        self.release.wait(30)
        if self.fail:
            raise RuntimeError("model exploded")
        return {"y": feeds["x"] * 2, "stats": np.arange(3)}


def _submit_all(batcher, sizes, results, first=0, **kw):
    def one(i, n):
        try:
            results[i] = batcher.submit(
                {"x": np.full((n, 2), i, np.float32)}, **kw)
        except Exception as e:  # noqa: BLE001
            results[i] = e

    threads = [threading.Thread(target=one, args=(i, n))
               for i, n in enumerate(sizes, first)]
    for t in threads:
        t.start()
    return threads


def test_batcher_coalesces_within_max_wait_and_splits_outputs():
    """Three requests inside one long window fill the largest bucket,
    which dispatches them at once as one batch."""
    gate = _Gate()
    b = Batcher(gate, BucketPolicy(max_batch=8), max_wait_ms=5000,
                output_batched=lambda k: False if k == "stats" else None)
    results = {}
    t0 = time.monotonic()
    for t in _submit_all(b, [2, 3, 3], results):
        t.join(10)
    b.stop()
    assert gate.batches == [8] and time.monotonic() - t0 < 5
    for i, n in enumerate([2, 3, 3]):
        np.testing.assert_array_equal(results[i]["y"],
                                      np.full((n, 2), 2 * i, np.float32))
        np.testing.assert_array_equal(results[i]["stats"], np.arange(3))
    assert b.outcome_counts()["ok"] == 3


def test_batcher_dispatches_alone_after_max_wait_and_caps_at_the_bucket():
    gate = _Gate()
    b = Batcher(gate, BucketPolicy(max_batch=4), max_wait_ms=20)
    t0 = time.monotonic()
    out = b.submit({"x": np.ones((1, 2), np.float32)})
    assert time.monotonic() - t0 >= 0.02 and out["y"].shape == (1, 2)
    results = {}
    for t in _submit_all(b, [3, 3], results):
        t.join(10)
    b.stop()
    assert gate.batches[1:] == [3, 3]   # 6 rows never share a bucket of 4
    with pytest.raises(ValueError, match="largest bucket"):
        Batcher(gate, BucketPolicy(max_batch=4)).submit(
            {"x": np.ones((5, 2), np.float32)})


def test_batcher_queue_full_deadline_drain_and_engine_error():
    gate = _Gate(block=True)
    b = Batcher(gate, BucketPolicy(max_batch=2), max_queue=1,
                max_wait_ms=1)
    results = {}
    threads = _submit_all(b, [2], results)
    assert _wait_for(lambda: gate.batches == [2])   # claimed, in flight
    threads += _submit_all(b, [1], results, first=1)
    assert _wait_for(lambda: b.depth() == 1)
    with pytest.raises(QueueFullError):
        b.submit({"x": np.ones((1, 2), np.float32)})
    with pytest.raises(RequestTimeout):
        Batcher(_Gate(block=True), BucketPolicy(max_batch=2),
                max_wait_ms=1).submit({"x": np.ones((1, 2), np.float32)},
                                      timeout_s=0.05)
    gate.release.set()
    b.stop()                             # drain: both finish
    for t in threads:
        t.join(10)
    assert results[0]["y"].shape == (2, 2) and results[1]["y"].shape == \
        (1, 2)
    with pytest.raises(ServerClosed):
        b.submit({"x": np.ones((1, 2), np.float32)})
    counts = b.outcome_counts()
    assert counts["ok"] == 2 and counts["rejected"] == 2
    bad = Batcher(_Gate(fail=True), BucketPolicy(max_batch=2),
                  max_wait_ms=1)
    with pytest.raises(EngineError, match="model exploded"):
        bad.submit({"x": np.ones((1, 2), np.float32)})
    bad.stop()
    # a QoS policy is checked when the Batcher is built
    with pytest.raises(ValueError, match="at least one tier"):
        Batcher(gate, BucketPolicy(), qos={"tiers": []})


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


# -- the Engine ------------------------------------------------------------------


def _engine_cfg(d, **kw):
    return ServingConfig(d, use_tpu=False, **kw)


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_engine_warms_every_bucket_and_accounts(precision, jax_dir,
                                                tmp_path):
    d = str(tmp_path / "m")
    shutil.copytree(jax_dir, d)
    kw = {} if precision == "f32" else {"calibration": _calibration(),
                                        "accuracy_check_batches": 2}
    eng = Engine(_engine_cfg(d, precision=precision, **kw))
    assert eng.warmup() == 7 and eng.policy.buckets == (1, 2, 4, 8, 16,
                                                        32, 64)
    assert len(eng._pred.signatures()) == 7
    assert eng.analysis == {"errors": 0, "warnings": 0, "infos": 0}
    before = tengine.BATCHES.value(bucket="4")
    pad = tengine.PAD_ROWS.value()
    x = synthetic_mnist(3, seed=7)[0]
    out = eng.run_batch({"x": x})
    assert next(iter(out.values())).shape == (3, 10)
    assert tengine.BATCHES.value(bucket="4") == before + 1
    assert tengine.PAD_ROWS.value() == pad + 1
    assert len(eng._pred.signatures()) == 7
    st = eng.status()
    assert st["precision"] == precision and st["warmed"]
    if precision == "f32":
        assert st["accuracy_delta"] is None
    else:
        delta = st["accuracy_delta"]
        assert delta["vs"] == "f32" and delta["batches"] == 2
        assert 0 < delta["max_abs"] < 0.5 and delta["mean_abs"] > 0
        assert tengine.ACCURACY_DELTA.value(stat="max_abs") == \
            delta["max_abs"]
    if precision == "int8":
        sib = d + ".int8"
        with open(os.path.join(sib, tengine.QUANT_SRC_FILE)) as f:
            assert json.load(f)["source_model_digest"] == \
                Engine._digest_model_file(d)
        assert eng._served_dir == sib
        # a restart without calibration reuses the sibling
        again = Engine(_engine_cfg(d, precision="int8"))
        assert again._served_dir == sib


def test_engine_warmstart_round_trip(port_dir, tmp_path):
    eng = Engine(_engine_cfg(port_dir, buckets=(1, 4)))
    eng.warmup()
    art = str(tmp_path / "warm.json")
    assert eng.export_warmstart(art) == 2
    other = Engine(_engine_cfg(port_dir, buckets=(1, 4), warmstart=art))
    assert other.warmstart_adopted == 2
    assert all(other._pred._cache.values())
    with open(art, "w") as f:
        f.write("junk")
    assert Engine(_engine_cfg(port_dir, warmstart=art)).warmstart_adopted \
        == 0


def test_serving_config_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="unknown precision policy"):
        ServingConfig(precision="mixed_f16")
    with pytest.raises(ValueError, match="unknown precision"):
        ServingConfig(precision="fp8")
    # the SLO spec is Server.start()'s to hand to observability.slo
    spec = {"slos": []}
    assert ServingConfig(slo_spec=spec).slo_spec is spec
    # the QoS policy is the Server's to check (QoSPolicy.from_spec)
    spec = {"tiers": ["high", "low"]}
    assert ServingConfig(qos=spec).qos == spec
    assert ServingConfig(host="0.0.0.0", port=5, warmup=False).port == 5


# -- HTTP -----------------------------------------------------------------------


def _post(port, payload, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_predict_replies_and_every_error_code(port_dir):
    srv = Server(_engine_cfg(port_dir, buckets=(1, 2, 4), max_queue=1,
                             max_wait_ms=1))
    eng = srv.engine
    gate = threading.Event()
    gate.set()
    state = {"fail": False}
    real = eng.run_batch

    def run_batch(feeds):
        gate.wait(30)
        if state["fail"]:
            raise RuntimeError("model exploded")
        return real(feeds)

    eng.run_batch = run_batch
    port = srv.start(0)
    try:
        assert _get(port, "/v1/healthz") == (200, {"status": "ok",
                                                   "state": "serving"})
        x = synthetic_mnist(3, seed=8)[0]
        code, body, hdrs = _post(port, {"feeds": {"x": x.tolist()}})
        assert code == 200 and body["batch"] == 3
        want = _port_predictor(port_dir).predict(x=x)
        for k, v in want.items():
            np.testing.assert_allclose(np.asarray(body["outputs"][k]), v,
                                       rtol=1e-6, atol=1e-6)
        assert "X-Request-Id" in hdrs
        for bad in ({}, {"feeds": {}}, {"feeds": {"x": [[1, 2], [3]]}},
                    {"feeds": {"x": np.zeros((5, 1, 28, 28)).tolist()}}):
            assert _post(port, bad)[0] == 400
        assert _post(port, {"feeds": {"x": x.tolist()},
                            "model": "nope"})[0] == 404
        # 503: one batch in flight, one queued, the third refused
        gate.clear()
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            _post(port, {"feeds": {"x": x[:1].tolist()}})))
            for _ in range(2)]
        threads[0].start()
        assert _wait_for(lambda: srv._batcher.inflight() == 1)
        threads[1].start()
        assert _wait_for(lambda: srv._batcher.depth() == 1)
        assert _post(port, {"feeds": {"x": x[:1].tolist()}})[0] == 503
        gate.set()
        for t in threads:
            t.join(30)
        assert [r[0] for r in results] == [200, 200]
        # 500: the engine raises
        state["fail"] = True
        code, body, _ = _post(port, {"feeds": {"x": x[:1].tolist()}})
        assert code == 500 and "model exploded" in body["error"]
        state["fail"] = False
        st = _get(port, "/v1/status")[1]
        assert st["precision"] == "f32" and st["buckets"] == [1, 2, 4]
        assert st["requests"]["error"] == 1
        # 503 + Retry-After while draining
        srv.drain(timeout=5)
        code, _, hdrs = _post(port, {"feeds": {"x": x[:1].tolist()}})
        assert code == 503 and hdrs.get("Retry-After") == "1"
        assert _get(port, "/v1/healthz")[0] == 503
    finally:
        srv.stop()


def test_http_predict_deadline_is_504(port_dir):
    srv = Server(_engine_cfg(port_dir, buckets=(1,), max_wait_ms=1))
    real = srv.engine.run_batch
    srv.engine.run_batch = lambda feeds: (time.sleep(0.5), real(feeds))[1]
    port = srv.start(0)
    try:
        x = synthetic_mnist(1, seed=9)[0]
        code, body, _ = _post(port, {"feeds": {"x": x.tolist()},
                                     "timeout_s": 0.1})
        assert code == 504 and "timed out" in body["error"]
    finally:
        srv.stop()


def test_http_models_has_a_predict_and_a_decode_row(port_dir):
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = gpt.GPTConfig.tiny()
    cfg.dtype = "float32"
    params, _ = gpt.init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    dec = DecodeEngine(params, cfg, DecodeConfig(
        block_size=8, num_blocks=32, decode_slots=(2,),
        prefill_buckets=(8,), precision="f32", max_len=32), device="cpu")
    srv = Server(_engine_cfg(port_dir, buckets=(1, 2), model_id="lenet"),
                 decode={"gpt": dec})
    port = srv.start(0)
    try:
        code, body = _get(port, "/v1/models")
        rows = {r["id"]: r for r in body["models"]}
        assert set(rows) == {"gpt", "lenet"}
        assert rows["lenet"]["kind"] == "predict" and rows["lenet"]["default"]
        assert rows["lenet"]["warmed"] and rows["lenet"]["buckets"] == [1, 2]
        assert rows["lenet"]["digest"] == Engine._digest_model_file(port_dir)
        assert rows["gpt"]["kind"] == "decode" and rows["gpt"]["decode"][
            "warmed"]
        x = synthetic_mnist(2, seed=10)[0]
        assert _post(port, {"feeds": {"x": x.tolist()},
                            "model": "lenet"})[0] == 200
        assert _post(port, {"feeds": {"x": x.tolist()},
                            "model": "gpt"})[0] == 400
        assert srv.load()["models"] == ["gpt", "lenet"]
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="needs a model_dir"):
        Server(ServingConfig())
    # more predict slots are served (tests/test_torch_multitenant.py);
    # a slot that names the default one is refused
    with pytest.raises(ValueError, match="duplicates the default slot"):
        Server(_engine_cfg(port_dir), models={"default":
                                              _engine_cfg(port_dir)})


# -- SLOs, time series, memory and executor telemetry on a served model -------


SERVE_SLO_SPEC = {"slos": [
    {"name": "predict-availability", "type": "availability",
     "target": 0.999,
     "errors": {"metric": "paddle_tpu_serving_requests_total",
                "labels": {"outcome": "error"}},
     "total": {"metric": "paddle_tpu_serving_requests_total"}},
    {"name": "predict-latency", "type": "latency", "target": 0.95,
     "metric": "paddle_tpu_serving_request_seconds", "threshold_s": 30.0}]}


def test_server_records_time_series_and_evaluates_slos(port_dir, tmp_path,
                                                       monkeypatch):
    """ServingConfig(slo_spec=...) with PADDLE_TPU_TS_DIR set: start()
    starts the recorder and the SLO evaluator, /v1/slo (on the metrics
    server) reports both objectives at burn 0 on traffic that fails
    nothing, stop() stops both, and the dir's increase of
    paddle_tpu_serving_requests_total is the requests served. Each
    predict batch is one executor step (mode "infer"); /v1/status
    carries the memwatch block."""
    from paddle_tpu_torch.observability import aggregate, httpd, slo
    from paddle_tpu_torch.observability import telemetry, timeseries

    ts_dir = str(tmp_path / "ts")
    monkeypatch.setenv("PADDLE_TPU_TS_DIR", ts_dir)
    monkeypatch.setenv("PADDLE_TPU_TS_INTERVAL_S", "0.2")
    monkeypatch.setenv("PADDLE_TPU_SLO_INTERVAL_S", "0.2")
    assert timeseries.current_recorder() is None
    steps0 = telemetry.EXEC_STEPS.value(mode="infer")
    batches0 = sum(tengine.BATCHES.value(bucket=str(b)) for b in (1, 2, 4))
    srv = Server(_engine_cfg(port_dir, buckets=(1, 2, 4),
                             slo_spec=SERVE_SLO_SPEC))
    port = srv.start(0)
    mport = httpd.start_http_server(0)
    x = synthetic_mnist(12, seed=5)[0]
    try:
        assert timeseries.current_recorder() is not None
        assert slo.current_engine() is not None
        for i in range(12):
            code, body, _ = _post(port, {"feeds": {"x": x[i:i + 1].tolist()}})
            assert code == 200, body
        time.sleep(0.5)
        code, status = _get(port, "/v1/status")
        assert code == 200 and "owners" in status["memory"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/v1/slo", timeout=30) as r:
            assert r.status == 200
            rows = json.loads(r.read())["slos"]
        assert sorted(r["name"] for r in rows) == \
            ["predict-availability", "predict-latency"]
        for row in rows:
            assert row["state"] == "ok"
            assert all(w["burn_short"] == 0 and w["burn_long"] == 0
                       for w in row["windows"]), row
    finally:
        httpd.stop_http_server()
        srv.stop()
    assert timeseries.current_recorder() is None
    assert slo.current_engine() is None
    store = aggregate.TSStore.load(ts_dir)
    assert store.increase("paddle_tpu_serving_requests_total", 1e9) == 12
    batches = sum(tengine.BATCHES.value(bucket=str(b))
                  for b in (1, 2, 4)) - batches0
    assert telemetry.EXEC_STEPS.value(mode="infer") - steps0 >= batches > 0
