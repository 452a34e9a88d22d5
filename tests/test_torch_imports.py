"""Import hygiene of the PyTorch port: `paddle_tpu_torch` and
`chip_smoke.py` load neither jax nor any module of the JAX package, and
the stdlib modules the port copied from the JAX package have not
drifted from their sources."""

import os
import re
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "paddle_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
names = ["paddle_tpu_torch"]
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "paddle_tpu"
             or m.startswith("paddle_tpu."))
print(len(names), bad, " ".join(names))
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20, r.stdout
    # the training, NMT, ResNet, sequence-parallel, resilience, fluid,
    # KV-reuse, pipeline, inference and fleet slices' modules, the
    # fluid path's data parallelism and the trainer's front end
    # (optimizers, SelectedRows, readers, metrics, trainer) are among
    # those imported
    for name in ("paddle_tpu_torch.models.bert",
                 "paddle_tpu_torch.parallel.train",
                 "paddle_tpu_torch.core.precision",
                 "paddle_tpu_torch.kernels.flash_attention",
                 "paddle_tpu_torch.kernels.flash_attention_bias",
                 "paddle_tpu_torch.models.transformer",
                 "paddle_tpu_torch.kernels.fused_dense_bn",
                 "paddle_tpu_torch.models.resnet",
                 "paddle_tpu_torch.parallel.mesh",
                 "paddle_tpu_torch.parallel.sharding",
                 "paddle_tpu_torch.core.ring",
                 "paddle_tpu_torch.ops.ring_attention",
                 "paddle_tpu_torch.parallel.checkpoint",
                 "paddle_tpu_torch.resilience.checkpoint_manager",
                 "paddle_tpu_torch.resilience.policy",
                 "paddle_tpu_torch.observability.health",
                 "paddle_tpu_torch.core.async_exec",
                 "paddle_tpu_torch.core.registry",
                 "paddle_tpu_torch.core.lowering",
                 "paddle_tpu_torch.core.executor",
                 "paddle_tpu_torch.layers",
                 "paddle_tpu_torch.optimizer",
                 "paddle_tpu_torch.models.lenet",
                 "paddle_tpu_torch.serving.kv_reuse",
                 "paddle_tpu_torch.parallel.pipeline",
                 "paddle_tpu_torch.observability.telemetry",
                 "paddle_tpu_torch.observability.perfwatch",
                 "paddle_tpu_torch.observability.memwatch",
                 "paddle_tpu_torch.observability.device_peaks",
                 "paddle_tpu_torch.observability.timeseries",
                 "paddle_tpu_torch.observability.aggregate",
                 "paddle_tpu_torch.observability.slo",
                 "paddle_tpu_torch.observability.httpd",
                 "paddle_tpu_torch.profiler",
                 "paddle_tpu_torch.ops.int8",
                 "paddle_tpu_torch.ops.quant",
                 "paddle_tpu_torch.models.vgg",
                 "paddle_tpu_torch.io",
                 "paddle_tpu_torch.inference",
                 "paddle_tpu_torch.analysis.passes",
                 "paddle_tpu_torch.slim.quantization",
                 "paddle_tpu_torch.serving.bucketing",
                 "paddle_tpu_torch.serving.batcher",
                 "paddle_tpu_torch.serving.engine",
                 "paddle_tpu_torch.serving.qos",
                 "paddle_tpu_torch.serving.registry",
                 "paddle_tpu_torch.serving.router",
                 "paddle_tpu_torch.serving.autoscale",
                 "paddle_tpu_torch.serving.replica",
                 "paddle_tpu_torch.distributed",
                 "paddle_tpu_torch.distributed.rendezvous",
                 "paddle_tpu_torch.distributed.launch_serve",
                 "paddle_tpu_torch.core.compiler",
                 "paddle_tpu_torch.ops.collective",
                 "paddle_tpu_torch.ops.control_flow",
                 "paddle_tpu_torch.core.lockstep",
                 "paddle_tpu_torch.parallel.spmd_executor",
                 "paddle_tpu_torch.parallel.collective",
                 "paddle_tpu_torch.parallel.strategy",
                 "paddle_tpu_torch.parallel.role_maker",
                 "paddle_tpu_torch.parallel.fleet",
                 "paddle_tpu_torch.incubate.fleet.collective",
                 "paddle_tpu_torch.incubate.fleet.base.role_maker",
                 "paddle_tpu_torch.core.selected_rows",
                 "paddle_tpu_torch.ops.misc",
                 "paddle_tpu_torch.ops.optimizer_ops",
                 "paddle_tpu_torch.amp.decorator",
                 "paddle_tpu_torch.metrics",
                 "paddle_tpu_torch.data_feeder",
                 "paddle_tpu_torch.reader",
                 "paddle_tpu_torch.reader_decorators",
                 "paddle_tpu_torch.dataset_loader",
                 "paddle_tpu_torch.trainer",
                 # eager mode, the debugger and contrib
                 "paddle_tpu_torch.dygraph",
                 "paddle_tpu_torch.dygraph.tracer",
                 "paddle_tpu_torch.dygraph.varbase",
                 "paddle_tpu_torch.dygraph.base",
                 "paddle_tpu_torch.dygraph.layers",
                 "paddle_tpu_torch.dygraph.nn",
                 "paddle_tpu_torch.dygraph.jit",
                 "paddle_tpu_torch.dygraph.parallel",
                 "paddle_tpu_torch.dygraph.checkpoint",
                 "paddle_tpu_torch.dygraph.learning_rate_scheduler",
                 "paddle_tpu_torch.ops.sequence",
                 "paddle_tpu_torch.ops.text_match",
                 "paddle_tpu_torch.ops.detection",
                 "paddle_tpu_torch.debugger",
                 "paddle_tpu_torch.contrib",
                 "paddle_tpu_torch.contrib.utils"):
        assert name in r.stdout.split(), name


def _sources():
    for root, _, files in os.walk(_PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)
    yield os.path.join(_REPO, "chip_smoke.py")


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"import jax|from jax|paddle_tpu\.|"
                     r"from paddle_tpu\b(?!_)|import paddle_tpu\b(?!_)")
    hits = []
    for path in _sources():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pat.search(line):
                    hits.append(f"{os.path.relpath(path, _REPO)}:{i}: "
                                f"{line.strip()}")
    assert not hits, "\n".join(hits)


def test_copied_httpbase_matches_its_source():
    src = os.path.join(_REPO, "paddle_tpu", "observability", "httpbase.py")
    copy = os.path.join(_PKG, "observability", "httpbase.py")
    with open(copy) as f:
        lines = f.read().splitlines(keepends=True)
    assert "paddle_tpu/observability/httpbase.py" in lines[0]
    body = "".join(lines[2:])
    with open(src) as f:
        assert body == f.read()


# The fluid path's stdlib modules, copied verbatim (a two-line header
# naming the source, then the same body). Where a docstring names the
# package (core/framework.py, backward.py), the copy says
# paddle_tpu_torch. where the source says paddle_tpu.; nothing else
# differs.
FLUID_COPIES = (["core/ir.py", "core/flags.py", "core/framework.py",
                 "core/backward.py", "backward.py", "layer_helper.py",
                 "initializer.py", "param_attr.py", "regularizer.py",
                 "clip.py", "nets.py", "amp/fp16_lists.py",
                 "amp/decorator.py", "metrics.py", "data_feeder.py",
                 "reader_decorators.py",
                 "dygraph/learning_rate_scheduler.py", "dygraph/layers.py",
                 "slim/nas.py", "slim/core.py", "slim/distillation.py"]
                + ["layers/" + f for f in sorted(os.listdir(
                    os.path.join(_REPO, "paddle_tpu", "layers")))
                   if f.endswith(".py")])


@pytest.mark.parametrize("rel", FLUID_COPIES)
def test_copied_fluid_module_matches_its_source(rel):
    with open(os.path.join(_PKG, rel)) as f:
        lines = f.read().splitlines(keepends=True)
    assert f"paddle_tpu/{rel}" in lines[0]
    with open(os.path.join(_REPO, "paddle_tpu", rel)) as f:
        want = f.read()
    assert "".join(lines[2:]) == want.replace("paddle_tpu.",
                                              "paddle_tpu_torch.")


def _module_names(module):
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in vars(module) if not n.startswith("_")]
    return sorted(names)


@pytest.mark.parametrize("module", [
    "dygraph", "dygraph.base", "dygraph.nn", "dygraph.layers",
    "dygraph.jit", "dygraph.parallel", "dygraph.checkpoint",
    "dygraph.learning_rate_scheduler", "debugger", "contrib",
    "contrib.utils"])
def test_port_has_every_public_name_of_the_jax_module(module):
    """Every public name of the JAX package's eager mode, debugger and
    contrib modules exists in the port's module of the same path (the
    modules and typing names they import aside)."""
    import importlib
    import inspect

    want = importlib.import_module(f"paddle_tpu.{module}")
    got = importlib.import_module(f"paddle_tpu_torch.{module}")
    missing = [n for n in _module_names(want)
               if not inspect.ismodule(getattr(want, n))
               and getattr(getattr(want, n), "__module__", "") != "typing"
               and not hasattr(got, n)]
    assert not missing, missing
    assert "enable_dygraph" in dir(importlib.import_module("paddle_tpu_torch"))


# The fluid path's data parallelism: the transpilers, the strategy, the
# role makers and the incubate re-exports are stdlib-only in the JAX
# package and copied as FLUID_COPIES are (a two-line header naming the
# source, the body with paddle_tpu. read as paddle_tpu_torch.; nothing
# else differs). fleet.py, spmd_executor.py and core/compiler.py are
# ports, not copies.
DP_COPIES = ["parallel/collective.py", "parallel/strategy.py",
             "parallel/role_maker.py",
             "incubate/fleet/collective/__init__.py",
             "incubate/fleet/base/role_maker.py"]


@pytest.mark.parametrize("rel", DP_COPIES)
def test_copied_data_parallel_module_matches_its_source(rel):
    test_copied_fluid_module_matches_its_source(rel)


def test_chip_smoke_prints_no_result_without_a_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when there
    is no CUDA device, from the repo and from a directory that holds
    nothing but the script."""
    import shutil

    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("this machine has a GPU")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), alone)
    for cwd, script in ((_REPO, "chip_smoke.py"), (str(tmp_path), str(alone))):
        r = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_every_cuda_source_is_built():
    """`_build.SOURCES` names every CUDA source under kernels/csrc, the
    fused matmul+BN kernels with the four attention kernels, so one
    build compiles them all."""
    from paddle_tpu_torch.kernels import _build

    csrc = os.path.join(_PKG, "kernels", "csrc")
    on_disk = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sorted(_build.SOURCES.values()) == on_disk
    assert _build.SOURCES["fused_dense_bn"] == "fused_dense_bn.cu"


# serving/kv_reuse.py, copied with declared changes: (source text, its
# replacement), each source text once in the source. The JAX package
# guards the allocator with its analysis.lockcheck lock, which the port
# does not have (ROADMAP item 21): the copy imports threading and takes
# a plain lock. Every other line, the function and class bodies and the
# hash seed included, is the source's.
KV_REUSE_CHANGES = [
    ("import hashlib\nfrom collections",
     "import hashlib\nimport threading\nfrom collections"),
    ("""        from ..analysis import lockcheck as _lockcheck

        self._lock = _lockcheck.Lock(
            name="serving.kv_reuse.ReuseBlockAllocator._lock")
""", """        # a plain lock: the port has no lock-order checker (the JAX
        # package's analysis.lockcheck, ROADMAP item 21)
        self._lock = threading.Lock()
"""),
    ("so all state is guarded by a lockcheck-named lock\n",
     "so all state is guarded by one plain lock\n"),
]


def test_kv_reuse_copy_differs_only_by_its_declared_changes():
    with open(os.path.join(_PKG, "serving", "kv_reuse.py")) as f:
        lines = f.read().splitlines(keepends=True)
    assert "paddle_tpu/serving/kv_reuse.py" in lines[0]
    with open(os.path.join(_REPO, "paddle_tpu", "serving",
                           "kv_reuse.py")) as f:
        src = f.read()
    for old, new in KV_REUSE_CHANGES:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert "".join(lines[3:]) == src


def _copy_and_source(rel, header_lines):
    with open(os.path.join(_PKG, rel)) as f:
        lines = f.read().splitlines(keepends=True)
    assert f"paddle_tpu/{rel}" in lines[0]
    with open(os.path.join(_REPO, "paddle_tpu", rel)) as f:
        return "".join(lines[header_lines:]), f.read()


def test_bucketing_copy_matches_its_source():
    body, src = _copy_and_source("serving/bucketing.py", 2)
    assert body == src


def reword_lines(src, lines):
    """`src` with each numbered line (1-based) replaced by its new text:
    the copies reword a few lines of their sources, named by line so a
    moved or edited source line fails the drift test."""
    out = src.splitlines(keepends=True)
    for n, new in lines.items():
        assert out[n - 1] != new + "\n", n
        out[n - 1] = new + "\n"
    return "".join(out)


# slim/quantization.py, copied with declared changes: calibration runs
# on a `place` argument (the card by default) where the source
# calibrates on the CPU, and two comment lines are reworded (the
# source's lines 27 and 74).
SLIM_REWORDED = {
    27: "# Calibration/quantization visibility: the passes",
    74: '    """reference: contrib/slim post-training quantizer. Weight-only:'}
SLIM_CHANGES = [
    ("    from ..core.places import CPUPlace\n",
     "    from ..core.places import default_place\n"),
    ("""                           quantizable_op_type: Optional[Sequence[str]] = None
                           ) -> Dict[str, float]:""",
     """                           quantizable_op_type: Optional[Sequence[str]] = None,
                           place=None) -> Dict[str, float]:"""),
    ("""    int8 gemm/conv kernels. Returns {activation_var: scale}.\"\"\"""",
     """    int8 gemm/conv kernels. Returns {activation_var: scale}.

    Calibration runs on `place`, CUDAPlace(0) when None.\"\"\""""),
    ("    exe = Executor(CPUPlace())",
     "    exe = Executor(place if place is not None else default_place())"),
]


def test_slim_quantization_copy_differs_only_by_its_declared_changes():
    body, src = _copy_and_source("slim/quantization.py", 5)
    src = reword_lines(src, SLIM_REWORDED)
    for old, new in SLIM_CHANGES:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert body == src


def _public_methods(path, cls):
    import ast

    tree = ast.parse(open(path).read())
    node = next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == cls)
    return {n.name for n in node.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


def test_analysis_config_has_every_method_of_the_jax_package():
    """An AST name diff: every public method of the JAX package's
    `AnalysisConfig` is defined on the port's. `switch_ir_optim`,
    `enable_memory_optim` and `enable_profile` set their flags, as the
    JAX package's do, and nothing reads them."""
    from paddle_tpu.inference import AnalysisConfig as JAnalysisConfig
    from paddle_tpu_torch.inference import AnalysisConfig

    want = _public_methods(os.path.join(_REPO, "paddle_tpu", "inference.py"),
                           "AnalysisConfig")
    got = _public_methods(os.path.join(_REPO, "paddle_tpu_torch",
                                       "inference.py"), "AnalysisConfig")
    assert want and not want - got, sorted(want - got)
    cfg = AnalysisConfig("some/dir")
    cfg.switch_ir_optim(False)
    cfg.switch_ir_optim()
    cfg.enable_memory_optim()
    jcfg = JAnalysisConfig("some/dir")
    assert cfg._enable_profile is jcfg._enable_profile is False
    cfg.enable_profile()
    jcfg.enable_profile()
    assert cfg._enable_profile is jcfg._enable_profile is True


# The fleet tier's stdlib modules. rendezvous.py is a verbatim copy (a
# two-line header, then the source). qos.py, router.py, registry.py,
# autoscale.py and distributed/launch_serve.py are copied with declared
# changes (a three-line header): each takes a plain threading lock
# where the source takes its analysis.lockcheck lock, which the port
# does not have (ROADMAP item 21); registry.py reads a warmstart
# artifact's model digest from JSON, the port's artifact format, where
# the source unpickles it; launch_serve.py spawns and names this
# package's modules; and a few comment lines, named by source line
# number, drop the JAX package's change numbers (FLEET_REWORDED).
FLEET_VERBATIM = ["distributed/rendezvous.py"]

FLEET_REWORDED = {
    "serving/router.py": {
        25: "* **circuit breaking** — every endpoint is wrapped in a",
        31: "  half-open forever (the breaker's leak-fix contract, extended "
            "here to the",
        65: "* **elastic membership** — point the router at the same",
        630: "                # the breaker wedges (the breaker's contract)"},
    "serving/registry.py": {
        10: "`publish()` copies a model's warmstart artifact (`Engine.",
        18: "computation: the silent wrong-answer failure mode the warmstart "
            "binding"},
    "serving/autoscale.py": {
        32: "seconds because replicas boot from the warmstart artifact;"},
    "distributed/launch_serve.py": {
        4: "--ps_supervise` (their per-slot pattern, applied to serving):"},
}

_LOCKCHECK = re.compile(
    r"        # deferred import: the analysis package must not load during\n"
    r"        # package bootstrap; constructors only run after it\n"
    r"        from \.\.analysis import lockcheck as _lockcheck\n\n"
    r"        self\._lock = _lockcheck\.Lock\(\s*\"[^\"]+\"\)\n")
PLAIN_LOCK = ("        # a plain lock: the port has no lock-order checker (the JAX\n"
              "        # package's analysis.lockcheck, ROADMAP item 21)\n"
              "        self._lock = threading.Lock()\n")

FLEET_CHANGES = {
    "serving/qos.py": [
        ("import time\nfrom typing",
         "import threading\nimport time\nfrom typing")],
    "serving/router.py": [],
    "serving/registry.py": [
        ("import shutil\nimport time\n",
         "import shutil\nimport threading\nimport time\n"),
        ("""    import pickle

    try:
        with open(path, "rb") as f:
            art = pickle.loads(f.read())
""", """    try:
        with open(path, "rb") as f:
            art = json.loads(f.read())
""")],
    "serving/autoscale.py": [],
    "distributed/launch_serve.py": [],
}


def plain_lock(src):
    """`src` with its one analysis.lockcheck lock made a plain lock."""
    assert len(_LOCKCHECK.findall(src)) == 1
    return _LOCKCHECK.sub(lambda _: PLAIN_LOCK, src)


def fleet_copy_text(rel):
    """The text the port's copy of `rel` must hold below its header."""
    with open(os.path.join(_REPO, "paddle_tpu", rel)) as f:
        src = f.read()
    if rel in FLEET_VERBATIM:
        return src
    src = reword_lines(src, FLEET_REWORDED.get(rel, {}))
    for old, new in FLEET_CHANGES[rel]:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    if "lockcheck" in src:
        src = plain_lock(src)
    return src.replace("paddle_tpu.", "paddle_tpu_torch.")


@pytest.mark.parametrize("rel", FLEET_VERBATIM + sorted(FLEET_CHANGES))
def test_fleet_copy_differs_only_by_its_declared_changes(rel):
    with open(os.path.join(_PKG, rel)) as f:
        lines = f.read().splitlines(keepends=True)
    assert f"paddle_tpu/{rel}" in lines[0]
    header = 2 if rel in FLEET_VERBATIM else 3
    assert "".join(lines[header:]) == fleet_copy_text(rel)


# The fluid trainer's front end: reader.py, dataset_loader.py and
# trainer.py are copied with declared changes (a three-line header):
# the device stage puts a batch on the loader's places' card
# (`async_exec.prefetch_device`; the JAX package's `jax.device_put`
# takes jax's default device), each Hogwild thread makes the executor's
# card current before its first step, and the docstrings that describe
# the XLA step or the C++ datafeed describe the port's instead.
FRONT_END_CHANGES = {
    "reader.py": [
        ("""(operators/reader/buffered_reader.cc). The TPU-native pipeline keeps the
same shape: a background thread runs the user generator into a bounded
host queue (core/async_exec.Prefetcher — producer errors propagate to
the iterating consumer, and the thread is joined when iteration stops
early), and with `use_double_buffer` + places a second Prefetcher stage
runs `jax.device_put` (sharded over the active SPMD mesh) into a
bounded double buffer, so batch N+1 is on device while step N computes
and batch N+2 is being collated on the host.
""", """(operators/reader/buffered_reader.cc). The port's pipeline keeps the
same shape: a background thread runs the user generator into a bounded
host queue (core/async_exec.Prefetcher — producer errors propagate to
the iterating consumer, and the thread is joined when iteration stops
early), and with `use_double_buffer` + places a second Prefetcher stage
(core/async_exec.DevicePrefetcher) copies each batch to the places'
card, from pinned memory on a side stream, into a bounded double
buffer, so batch N+1 is on device while step N computes and batch N+2
is being collated on the host.
"""),
        ("""from .core.async_exec import (DevicePrefetcher, Prefetcher,
                              device_prefetch_wanted)""",
         """from .core.async_exec import (DevicePrefetcher, Prefetcher,
                              device_prefetch_wanted, prefetch_device)"""),
        ("""            # prefetch-to-device: batches go up via jax.device_put
            # (sharded over the active SPMD mesh) two batches ahead
            device = DevicePrefetcher(host, depth=2)""",
         """            # prefetch-to-device: batches go up to the places' card
            # two batches ahead
            device = DevicePrefetcher(
                host, depth=2, device=prefetch_device(self._places))"""),
    ],
    "dataset_loader.py": [
        ("""    consumer by a bounded background thread (core/async_exec): a
    `jax.device_put` stage (sharded over the active SPMD mesh) when""",
         """    consumer by a bounded background thread (core/async_exec): a
    stage that copies them to the places' card when"""),
        ("""        from .core.async_exec import (DevicePrefetcher, Prefetcher,
                                      device_prefetch_wanted)""",
         """        from .core.async_exec import (DevicePrefetcher, Prefetcher,
                                      device_prefetch_wanted,
                                      prefetch_device)"""),
        ("""        pf = DevicePrefetcher(src, depth=self._prefetch_depth) \\""",
         """        pf = DevicePrefetcher(src, depth=self._prefetch_depth,
                              device=prefetch_device(self._places)) \\"""),
    ],
    "trainer.py": [
        ("""Round-1: a host-side trainer loop over a Dataset's file shards feeding the
compiled step (HogwildWorker semantics, hogwild_worker.cc:163); the C++
datafeed library (paddle_tpu/data/) supplies the pipelined batch source.
""", """A host-side trainer loop over a dataset's batches feeding the executor's
step (HogwildWorker semantics, hogwild_worker.cc:163); any object with
`_iter_batches()`, or an iterable such as a `DataLoader`, is a source.
"""),
        ("""1 restores the per-step loop), dispatched as one cached executable each
(core/executor.run_stream), with losses fetched lazily — the host only""",
         """1 restores the per-step loop), dispatched as one run_chained call each
(core/executor.run_stream), with losses fetched lazily — the host only"""),
        ("""    thread_num; here the XLA step is the device worker, so the desc keeps""",
         """    thread_num; here the executor's step is the device worker, so the desc keeps"""),
        ("""    compiled step against the SHARED scope (reference:
    hogwild_worker.cc:163 TrainFiles). Dispatch is serialized by a shared
    lock — the XLA step donates parameter buffers for the in-place
    update; with the streaming driver the lock covers the window
    dispatch (next() on the stream) while execution itself overlaps via
    jax async dispatch, and threads additionally overlap on the C++
    reader pipeline and host-side batch prep.\"\"\"""",
         """    executor's step against the SHARED scope (reference:
    hogwild_worker.cc:163 TrainFiles). Dispatch is serialized by a shared
    lock — a step reads the scope's params and writes their updates
    back; with the streaming driver the lock covers the window
    dispatch while execution itself overlaps via CUDA's asynchronous
    launches, and threads additionally overlap on their readers and
    host-side batch prep. Each thread makes the executor's card
    current before its first step.\"\"\""""),
        ("""    def train(self):
        window = _stream_window()""",
         """    def train(self):
        _make_device_current(self.executor)
        window = _stream_window()"""),
        ("""def train_from_dataset(executor, program=None, dataset=None, scope=None,
                       thread=0, debug=False, fetch_list=None,
                       fetch_info=None, print_period=100):
    from""", """def _make_device_current(executor):
    \"\"\"A new thread's current CUDA device is card 0: make the
    executor's card current before the thread's first CUDA work.\"\"\"
    device = getattr(executor, "device", None)
    if getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.set_device(device)


def train_from_dataset(executor, program=None, dataset=None, scope=None,
                       thread=0, debug=False, fetch_list=None,
                       fetch_info=None, print_period=100):
    from"""),
        ("""    — with NativeDataset, pass trainer_id=worker_id,
    num_trainers=num_workers so the C++ reader shards the filelist.""",
         """    — give each worker its own shard of the data (the JAX package's
    NativeDataset takes trainer_id=worker_id, num_trainers=num_workers)."""),
    ],
}


def front_end_copy_text(rel):
    """The text the port's copy of `rel` must hold below its header."""
    with open(os.path.join(_REPO, "paddle_tpu", rel)) as f:
        src = f.read().replace("paddle_tpu.", "paddle_tpu_torch.")
    for old, new in FRONT_END_CHANGES[rel]:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


@pytest.mark.parametrize("rel", sorted(FRONT_END_CHANGES))
def test_front_end_copy_differs_only_by_its_declared_changes(rel):
    with open(os.path.join(_PKG, rel)) as f:
        lines = f.read().splitlines(keepends=True)
    assert f"paddle_tpu/{rel}" in lines[0]
    assert "".join(lines[3:]) == front_end_copy_text(rel)


def _public_names(path):
    """The public top-level names a module defines (functions, classes,
    assignments), read from its AST."""
    import ast

    tree = ast.parse(open(path).read())
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", [
    "optimizer.py", "ops/optimizer_ops.py", "core/async_exec.py",
    "core/selected_rows.py", "reader.py", "metrics.py", "data_feeder.py",
    "reader_decorators.py", "dataset_loader.py", "trainer.py",
    "amp/decorator.py"])
def test_front_end_module_has_every_public_name_of_the_jax_package(rel):
    want = _public_names(os.path.join(_REPO, "paddle_tpu", rel))
    got = _public_names(os.path.join(_PKG, rel))
    assert want and not want - got, sorted(want - got)


def test_executor_has_the_streaming_and_dataset_entry_points():
    want = _public_methods(os.path.join(_REPO, "paddle_tpu", "core",
                                        "executor.py"), "Executor")
    got = _public_methods(os.path.join(_PKG, "core", "executor.py"),
                          "Executor")
    assert {"run_stream", "train_from_dataset",
            "infer_from_dataset"} <= got
    assert not want - got, sorted(want - got)


# The compression passes that rewrite scope values: slim/qat.py,
# prune.py and float16.py are copied with declared changes (a four-line
# header): a scope value is a tensor that may lie on the card, so it is
# read with core.async_exec.to_numpy where the source takes np.asarray, and
# written back with convert.like_value (a tensor on the value's device)
# or convert.cast_value where the source writes a numpy or jax array.
SLIM_COPY_CHANGES = {
    'qat.py': [
        ('import numpy as np\n\nfrom ..core.framework import Program\n',
         'import numpy as np\n\nfrom ..convert import like_value\nfrom ..core.async_exec import to_numpy\nfrom ..core.framework import Program\n'),
        ('                        w = np.asarray(val)\n',
         '                        w = to_numpy(val)\n'),
        ('                        scope.set_var(x, dq.astype(w.dtype))\n',
         '                        scope.set_var(x, like_value(\n                            val, dq.astype(w.dtype)))\n'),
    ],
    'prune.py': [
        ('import numpy as np\n\nfrom ..core.framework import Program\n',
         'import numpy as np\n\nfrom ..convert import like_value\nfrom ..core.async_exec import to_numpy\nfrom ..core.framework import Program\n'),
        ('            w = np.asarray(val)\n',
         '            w = to_numpy(val)\n'),
        ('            scope.set_var(name, (w * mask).astype(w.dtype))\n',
         '            scope.set_var(name, like_value(val, (w * mask).astype(w.dtype)))\n'),
        ('            scope.set_var(mname, mask.astype("float32"))\n',
         '            scope.set_var(mname, like_value(scope.find_var(name),\n                                            mask.astype("float32")))\n'),
        ('            keep = np.asarray(scope.find_var(name)).copy()\n',
         '            val = scope.find_var(name)\n            keep = like_value(val, to_numpy(val).copy())\n'),
    ],
    'float16.py': [
        ('import numpy as np\n\nfrom ..core.framework import Program\n',
         'from ..convert import cast_value\nfrom ..core.framework import Program\n'),
        ('    import jax.numpy as jnp\n\n    assert dtype',
         '    assert dtype'),
        ('            scope.set_var(name, jnp.asarray(np.asarray(val), dtype))\n',
         '            scope.set_var(name, cast_value(val, dtype))\n'),
    ],
}


@pytest.mark.parametrize("name", sorted(SLIM_COPY_CHANGES))
def test_slim_pass_copy_differs_only_by_its_declared_changes(name):
    with open(os.path.join(_PKG, "slim", name)) as f:
        lines = f.read().splitlines(keepends=True)
    assert f"paddle_tpu/slim/{name}" in lines[0]
    with open(os.path.join(_REPO, "paddle_tpu", "slim", name)) as f:
        src = f.read().replace("paddle_tpu.", "paddle_tpu_torch.")
    for old, new in SLIM_COPY_CHANGES[name]:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert "".join(lines[4:]) == src


def test_slim_exports_every_name_of_the_jax_package_without_pyyaml():
    """`paddle_tpu_torch.slim` has every name `paddle_tpu.slim` exports
    and imports, in a fresh interpreter, with PyYAML and jax unimportable
    (the card has no PyYAML; only a YAML string config needs it)."""
    import paddle_tpu.slim as jslim

    want = [n for n in dir(jslim) if not n.startswith("_")]
    code = ("import builtins, sys\n"
            "real = builtins.__import__\n"
            "def imp(name, *a, **k):\n"
            "    if name.split('.')[0] in ('yaml', 'jax', 'paddle_tpu'):\n"
            "        raise ImportError(name)\n"
            "    return real(name, *a, **k)\n"
            "builtins.__import__ = imp\n"
            "import paddle_tpu_torch.slim as s, paddle_tpu_torch.slim.core\n"
            "print(' '.join(sorted(n for n in dir(s))))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = set(r.stdout.split())
    assert not set(want) - got, sorted(set(want) - got)


# The package inits' names (ROADMAP F25): what `dir()` of each shows
# after a fresh `import` of both packages, in a subprocess so no other
# test's imports add submodules. The port excuses item 21's
# parameter-server surface (`DistributeTranspiler`,
# `DistributeTranspilerConfig`) and the JAX package's `dataset`,
# `io_fs` and `version` modules, which it does not carry; it aliases
# `TPUPinnedPlace` to `CUDAPinnedPlace`.
_INIT_EXCUSED = {"": {"DistributeTranspiler", "DistributeTranspilerConfig",
                      "dataset", "io_fs", "version"},
                 ".parallel": set(), ".models": set(), ".core": set()}

_INIT_PROBE = r"""
import importlib, json
out = {}
for pkg in ("paddle_tpu", "paddle_tpu_torch"):
    importlib.import_module(pkg)
for sub in ("", ".parallel", ".models", ".core"):
    out[sub] = [sorted(n for n in dir(importlib.import_module(p + sub))
                       if not n.startswith("__"))
                for p in ("paddle_tpu", "paddle_tpu_torch")]
print(json.dumps(out))
"""


def test_package_inits_export_the_jax_packages_names():
    """Each of the port's top-level, `parallel`, `models` and `core`
    inits has every name the JAX package's has (F25), but the excused
    ones; `from paddle_tpu_torch.parallel import train_loop` works."""
    import json

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _INIT_PROBE], cwd=_REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    names = json.loads(r.stdout.strip().splitlines()[-1])
    for sub, (jax_names, port_names) in names.items():
        missing = set(jax_names) - set(port_names) - _INIT_EXCUSED[sub]
        assert not missing, (sub or "top level", sorted(missing))
        assert not _INIT_EXCUSED[sub] & set(port_names), sub
    from paddle_tpu_torch.core.places import CUDAPinnedPlace
    from paddle_tpu_torch.parallel import train_loop
    from paddle_tpu_torch.parallel.train import train_loop as defined

    import paddle_tpu_torch

    assert train_loop is defined
    assert paddle_tpu_torch.TPUPinnedPlace is CUDAPinnedPlace
    assert paddle_tpu_torch.backward_module is paddle_tpu_torch.backward


def test_copied_detection_map_kernel_matches_its_source():
    """`ops/detection.py`'s `_np_detection_map_update` is the JAX
    package's, line for line, after a two-line header naming it."""
    import inspect

    from paddle_tpu.ops import detection as jdet

    from paddle_tpu_torch.ops import detection as tdet

    want = inspect.getsource(jdet._np_detection_map_update)
    got = inspect.getsource(tdet._np_detection_map_update)
    assert got == want
    with open(os.path.join(_PKG, "ops", "detection.py")) as f:
        text = f.read()
    at = text.index(got)
    header = text[:at].rstrip("\n").splitlines()[-2:]
    assert header == [
        "# Copied from the JAX package: paddle_tpu/ops/detection.py's",
        "# `_np_detection_map_update` (tests/test_torch_imports.py checks it)."]
