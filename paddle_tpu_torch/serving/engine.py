"""Bucket-aware serving engine: the Predictor wrapped for batch traffic.
Counterpart of the JAX package's `serving/engine.py`.

Owns the BucketPolicy, builds the Predictor with bucketing enabled (so
every dispatched batch lands on one of the configured signatures),
warms every bucket at startup (each bucket's step runs once, so no live
request pays a first run), and accounts per-bucket dispatch latency,
batch counts and padding rows in the metrics registry
(`paddle_tpu_serving_bucket_seconds{bucket}`,
`..._batches_total{bucket}`, `..._pad_rows_total`,
`..._warmup_seconds`, `..._accuracy_delta{stat}`, the JAX package's
names). At precision "int8" it serves a calibrated, quantized sibling of
the model dir (`<model_dir>.int8`, `slim.calibrate_and_quantize`), and
at bf16 and int8 it measures the replies' deviation from f32 on the
calibration batches at boot (`accuracy_delta`).

`ServingConfig` keeps the JAX package's signature. A decode-only server
reads only `host`, `port`, `warmup` and `qos` (the server's QoS policy,
a `qos.QoSPolicy` or its `from_spec` dict, which every predict slot's
Batcher applies). Not ported: `slo_spec` (the SLO evaluator, ROADMAP
item 18) raises when set.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..core import compile_cache as _cc
from ..core import precision as _precision
from ..core.places import CPUPlace, CUDAPlace
from ..inference import AnalysisConfig, Predictor, create_paddle_predictor
from ..observability import events as _events
from ..observability import metrics as _m
from ..observability import tracing as _tracing
from ..resilience.atomic import json_dump, write_bytes
from .bucketing import BucketPolicy, common_batch

__all__ = ["ServingConfig", "Engine", "WARMSTART_FORMAT", "QUANT_SRC_FILE"]

WARMSTART_FORMAT = "paddle_tpu_torch-warmstart-v1"

# written into the .int8 sibling after calibrate_and_quantize: records
# the sha256 of the SOURCE model's __model__ so later boots with
# calibration= still configured can prove the sibling was quantized
# from this very program and skip recalibration
QUANT_SRC_FILE = "__quant_source__.json"

BUCKET_SECONDS = _m.histogram(
    "paddle_tpu_serving_bucket_seconds",
    "Engine dispatch wall time per bucket (pad + run + slice)",
    labelnames=("bucket",))
BATCHES = _m.counter(
    "paddle_tpu_serving_batches_total",
    "Dispatched batches per bucket", labelnames=("bucket",))
PAD_ROWS = _m.counter(
    "paddle_tpu_serving_pad_rows_total",
    "Padding rows added by bucketing (wasted accelerator rows)")
WARMUP_SECONDS = _m.gauge(
    "paddle_tpu_serving_warmup_seconds",
    "Wall seconds the last warmup spent warming all buckets")
ACCURACY_DELTA = _m.gauge(
    "paddle_tpu_serving_accuracy_delta",
    "Reduced-precision reply deviation from the f32 reference on the "
    "calibration batches (stat=max_abs|mean_abs), set at engine boot "
    "for int8/bf16 precision", labelnames=("stat",))

SERVED_PRECISIONS = ("f32", "bf16", "mixed_bf16", "int8")


class ServingConfig:
    """Knobs of the serving server (SERVING.md §Configuration).
    host=None binds 127.0.0.1; port=0 binds an ephemeral port.
    warmup=True: `Server.start` warms every engine before it binds.
    use_tpu=True serves on the card (`cuda:{device_id}`), False on the
    CPU."""

    def __init__(self, model_dir: Optional[str] = None, *,
                 buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 64,
                 max_queue: int = 128,
                 max_wait_ms: float = 5.0,
                 timeout_s: float = 30.0,
                 warmup: bool = True,
                 aot: bool = True,
                 warmstart: Optional[str] = None,
                 use_tpu: bool = True,
                 device_id: int = 0,
                 host: Optional[str] = None,
                 port: int = 0,
                 precision: str = "f32",
                 calibration=None,
                 accuracy_check_batches: int = 4,
                 slo_spec=None,
                 qos=None,
                 model_id: str = "default"):
        self.model_dir = model_dir
        self.buckets = tuple(buckets) if buckets is not None else None
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_wait_ms = float(max_wait_ms)
        self.timeout_s = float(timeout_s)
        self.warmup = bool(warmup)
        self.aot = bool(aot)
        self.warmstart = warmstart
        self.use_tpu = bool(use_tpu)
        self.device_id = int(device_id)
        self.host = host
        self.port = int(port)
        # precision: "f32" (default), "bf16"/"mixed_bf16" (policy-based
        # reduced precision per bucket), or "int8" (calibrated
        # post-training quantization of the saved model — needs
        # `calibration`, a callable returning an iterable of feed dicts,
        # unless a previously quantized sibling dir exists).
        # accuracy_check_batches bounds the boot-time f32-vs-reduced
        # reply comparison that feeds /v1/status accuracy_delta (0
        # disables the check).
        if precision not in SERVED_PRECISIONS:
            # typos fail with the policy module's full-list message;
            # valid-but-unserved policies (mixed_f16) must ALSO fail
            # fast
            _precision.get_policy(precision)
            raise ValueError(
                f"unknown precision policy {precision!r} for serving; "
                "choose from ['f32', 'bf16', 'mixed_bf16', 'int8']")
        self.precision = str(precision)
        self.calibration = calibration
        self.accuracy_check_batches = int(accuracy_check_batches)
        if slo_spec is not None:
            raise NotImplementedError(
                "ServingConfig(slo_spec=...): the SLO evaluator is not "
                "ported (ROADMAP item 18)")
        self.slo_spec = None
        # per-tenant QoS policy (a qos.QoSPolicy or its from_spec dict;
        # None = single-tenant FIFO)
        self.qos = qos
        self.model_id = str(model_id)


class Engine:
    """Predictor + BucketPolicy with warmup and per-bucket accounting.
    `run_batch` is the callable the Batcher dispatches to; it is also
    safe to call directly (single-caller deployments that want bucketing
    without the queue)."""

    def __init__(self, config: ServingConfig,
                 predictor: Optional[Predictor] = None):
        self.config = config
        self.policy = BucketPolicy(max_batch=config.max_batch,
                                   buckets=config.buckets)
        self.precision = config.precision
        self.accuracy_delta: Optional[Dict] = None
        # the directory whose program is actually served (== model_dir
        # except under int8, where it is the calibrated+quantized
        # sibling); warmstart digests bind to THIS program
        self._served_dir = config.model_dir
        if predictor is None:
            if self.precision == "int8":
                self._served_dir = self._prepare_int8_model()
            # ALWAYS pin the policy: an explicit ServingConfig precision
            # must win over PADDLE_TPU_PRECISION / program attrs. "int8"
            # pins f32: the quantized program's int8 math lives in the
            # quantized_* ops, and its f32 glue must match the
            # f32-computed calibration scales
            predictor = create_paddle_predictor(self._analysis_config(
                self._served_dir,
                self.precision if self.precision in ("bf16", "mixed_bf16")
                else "f32"))
        else:
            if self.precision == "int8":
                raise ValueError(
                    "ServingConfig(precision='int8') cannot adopt an "
                    "externally built predictor — post-training "
                    "quantization rewrites the saved model; build the "
                    "Engine from model_dir instead")
            have = getattr(getattr(predictor, "_policy", None),
                           "name", None)
            if self.precision != "f32" and have != self.precision:
                raise ValueError(
                    f"externally built predictor was loaded under "
                    f"policy {have or 'f32'!r} but ServingConfig("
                    f"precision={self.precision!r}) was requested — "
                    "status and accuracy accounting would misreport; "
                    "call set_precision on its AnalysisConfig instead")
            # an externally built predictor must agree on the signature
            # set or live traffic would prepare off-bucket shapes that
            # warmup never touched — the engine's policy wins
            predictor.config._bucketing = self.policy
        self._pred = predictor
        self.warmed = False
        self.warmstart_adopted = 0
        # boot-time static analysis of the served program (the
        # reference's AnalysisPredictor runs its ir_analysis passes at
        # exactly this point); PADDLE_TPU_VALIDATE=2 refuses to serve a
        # program with error-severity findings
        self.analysis: Optional[Dict[str, int]] = self._validate_boot()
        if config.warmstart:
            self.load_warmstart(config.warmstart)
        if self.precision != "f32" and config.model_dir \
                and config.calibration is not None \
                and config.accuracy_check_batches > 0:
            self._measure_accuracy_delta()

    def _analysis_config(self, model_dir: str, precision: str
                         ) -> AnalysisConfig:
        cfg = self.config
        acfg = AnalysisConfig(model_dir)
        if cfg.use_tpu:
            acfg.enable_use_gpu(device_id=cfg.device_id)
        else:
            acfg.disable_gpu()
        if cfg.aot:
            acfg.enable_aot()
        acfg.set_precision(precision)
        acfg.enable_bucketing(buckets=self.policy.buckets)
        return acfg

    def _validate_boot(self) -> Dict[str, int]:
        """Static-analysis walk over the served program. AnalysisError
        propagates at PADDLE_TPU_VALIDATE=2 — a bad deploy fails at
        boot, not on the first live request."""
        from ..analysis import validate_level, validate_program

        findings = validate_program(
            self._pred._program.desc,
            feed_names=self._pred.get_input_names(),
            fetch_names=self._pred.get_output_names(),
            policy=self._pred._policy,
            is_test=True, level=validate_level(), where="serving")
        out = {"errors": 0, "warnings": 0, "infos": 0}
        for f in findings:
            out[f.severity + "s"] = out.get(f.severity + "s", 0) + 1
        return out

    # -- reduced-precision boot helpers ---------------------------------

    def _calibration_reader(self):
        """`config.calibration` as the callable-returning-an-iterable
        contract calibrate_and_quantize expects (a plain list/tuple of
        feed dicts is wrapped)."""
        cal = self.config.calibration
        if callable(cal):
            return cal
        return lambda: iter(cal)

    def _prepare_int8_model(self) -> str:
        """Calibrate + quantize the saved model into a `.int8` sibling
        dir and serve THAT program (int8 products, int32 accumulation,
        replies in f32). Calibration runs on the config's place. With no
        calibration configured, a previously quantized sibling is reused
        so restarts don't re-calibrate."""
        cfg = self.config
        if not cfg.model_dir:
            raise ValueError("ServingConfig(precision='int8') needs a "
                             "model_dir (externally built predictors "
                             "cannot be post-training quantized)")
        from ..slim.quantization import (QUANT_META_FILE,
                                         calibrate_and_quantize)

        int8_dir = cfg.model_dir.rstrip("/\\") + ".int8"
        src_digest = self._digest_model_file(cfg.model_dir)
        src_path = os.path.join(int8_dir, QUANT_SRC_FILE)
        recorded = None
        if os.path.exists(src_path):
            try:
                with open(src_path) as f:
                    recorded = json.load(f).get("source_model_digest")
            except (OSError, ValueError):
                recorded = None
        complete = os.path.exists(os.path.join(int8_dir, QUANT_META_FILE))
        if cfg.calibration is None:
            if complete:
                if recorded is not None and src_digest is not None \
                        and recorded != src_digest:
                    # quantized from a DIFFERENT model (model_dir was
                    # replaced since): serving it silently would answer
                    # with the old model's weights
                    raise ValueError(
                        f"previously quantized sibling {int8_dir} was "
                        f"built from a different model than the current"
                        f" {cfg.model_dir} — pass calibration= to "
                        "requantize it")
                _events.emit("quantize", action="serving_reuse",
                             dir=int8_dir)
                return int8_dir
            raise ValueError(
                "ServingConfig(precision='int8') needs calibration= (a "
                "callable returning an iterable of feed dicts) — no "
                f"previously quantized model found at {int8_dir}")
        # calibration configured: still reuse a sibling quantized from
        # THIS program (source-digest marker)
        if complete and src_digest is not None \
                and recorded == src_digest:
            _events.emit("quantize", action="serving_reuse",
                         dir=int8_dir, source_digest=src_digest)
            return int8_dir
        shutil.rmtree(int8_dir, ignore_errors=True)
        act_scales = calibrate_and_quantize(
            cfg.model_dir, self._calibration_reader(),
            save_model_path=int8_dir,
            place=CUDAPlace(cfg.device_id) if cfg.use_tpu else CPUPlace())
        if src_digest is not None:
            json_dump({"source_model_digest": src_digest}, src_path)
        _events.emit("quantize", action="serving_calibrate",
                     dir=int8_dir, activations=len(act_scales))
        return int8_dir

    def _measure_accuracy_delta(self):
        """Boot-time accuracy accounting for reduced-precision serving:
        run the first `accuracy_check_batches` calibration batches
        through an f32 reference predictor AND this engine's predictor
        (both bucket-padded, so no off-bucket signature is prepared) and
        record the reply deviation in /v1/status + the metrics registry.
        A failure here downgrades to accuracy_delta=None with an event —
        never a boot failure."""
        cfg = self.config
        try:
            batches = list(itertools.islice(
                iter(self._calibration_reader()()),
                int(cfg.accuracy_check_batches)))
            if not batches:
                return
            # the reference MUST be f32
            ref = create_paddle_predictor(
                self._analysis_config(cfg.model_dir, "f32"))
            max_d, sum_d, n_vals = 0.0, 0.0, 0
            for feed in batches:
                a = ref.predict(**feed)
                b = self._pred.predict(**feed)
                for name in a:
                    if name not in b:
                        continue
                    d = np.abs(np.asarray(a[name], np.float32)
                               - np.asarray(b[name], np.float32))
                    if d.size:
                        max_d = max(max_d, float(d.max()))
                        sum_d += float(d.sum())
                        n_vals += d.size
            self.accuracy_delta = {
                "vs": "f32", "max_abs": max_d,
                "mean_abs": sum_d / max(n_vals, 1),
                "batches": len(batches)}
            ACCURACY_DELTA.set(max_d, stat="max_abs")
            ACCURACY_DELTA.set(self.accuracy_delta["mean_abs"],
                               stat="mean_abs")
            _events.emit("quantize", action="accuracy_check",
                         precision=self.precision, **self.accuracy_delta)
        except Exception as e:
            self.accuracy_delta = None
            _events.emit("quantize", action="accuracy_check_failed",
                         precision=self.precision, error=str(e)[:200])

    def output_batched(self, name: str) -> Optional[bool]:
        """Does fetch `name` carry the batch dim? From the Predictor's
        declared shapes (None when unknown, letting the batcher fall
        back to its shape heuristic)."""
        return getattr(self._pred, "_fetch_batched", {}).get(name)

    def warmup(self) -> int:
        """Warm every configured bucket (its step run once on zero
        feeds); returns how many bucket signatures are ready.
        Idempotent (the Predictor caches per signature)."""
        t0 = time.perf_counter()
        ready = 0
        for b in self.policy.buckets:
            try:
                if self._pred.warm(b):
                    ready += 1
            except ValueError:
                # dynamic non-batch dims: the first live batch per
                # bucket prepares instead; serving still works
                break
        WARMUP_SECONDS.set(time.perf_counter() - t0)
        self.warmed = True
        return ready

    # -- warmstart artifact (fingerprints of warmed buckets) ------------

    @staticmethod
    def _digest_model_file(model_dir: Optional[str]) -> Optional[str]:
        """sha256 of `model_dir`'s __model__ program file, None when it
        is unreadable or there is no dir."""
        if not model_dir:
            return None
        try:
            with open(os.path.join(model_dir, "__model__"), "rb") as f:
                return hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return None

    def _model_digest(self) -> Optional[str]:
        """Content digest of the served model's program (__model__
        file): an artifact baked from a DIFFERENT program must never be
        adopted. None when there is no model dir."""
        return self._digest_model_file(self._served_dir)

    def export_warmstart(self, path: str) -> int:
        """Write the warmstart artifact (JSON, atomic): the environment
        meta, the model digest, the buckets and one entry per warmed
        signature, carrying its fingerprint. Call after warmup();
        returns how many signatures it carries."""
        entries = self._pred.serialize_warm()
        art = dict(_cc.environment_meta(self._pred._device),
                   format=WARMSTART_FORMAT,
                   model_digest=self._model_digest(),
                   buckets=[int(b) for b in self.policy.buckets],
                   created_at=time.time(),
                   entries=[{"signature": [[n, list(s), d]
                                           for n, s, d in sig],
                             **entry} for sig, entry in entries.items()])
        write_bytes(path, json.dumps(art, sort_keys=True).encode())
        _events.emit("warmstart", action="export", path=path,
                     entries=len(entries),
                     buckets=[int(b) for b in self.policy.buckets])
        return len(entries)

    def load_warmstart(self, path: str) -> int:
        """Adopt the warmed signatures of a warmstart artifact (each
        warmed now). Returns how many were adopted (also
        `warmstart_adopted` / `/v1/status`); 0 (with a `warmstart`
        reject event) when the artifact is unreadable, from another
        environment, or baked from a different model."""
        self.warmstart_adopted = self._load_warmstart(path)
        return self.warmstart_adopted

    def _load_warmstart(self, path: str) -> int:
        try:
            with open(path, "rb") as f:
                art = json.loads(f.read())
            if not isinstance(art, dict) \
                    or art.get("format") != WARMSTART_FORMAT:
                raise ValueError("not a warmstart artifact")
        except (OSError, ValueError) as e:
            _events.emit("warmstart", action="reject", path=path,
                         reason=f"unreadable: {str(e)[:200]}")
            return 0
        env = _cc.environment_meta(self._pred._device)
        stored = {k: art.get(k) for k in env}
        if stored != env:
            _events.emit("warmstart", action="reject", path=path,
                         reason=f"environment mismatch: artifact "
                                f"{stored} vs process {env}")
            return 0
        if art.get("model_digest") != self._model_digest():
            _events.emit("warmstart", action="reject", path=path,
                         reason="model digest mismatch — artifact baked "
                                "from a different program")
            return 0
        try:
            entries = {tuple((n, tuple(s), d) for n, s, d
                             in e["signature"]): e
                       for e in art.get("entries") or []}
            adopted = self._pred.adopt_warm(entries)
        except Exception as e:
            _events.emit("warmstart", action="reject", path=path,
                         reason=f"unadoptable entries: {str(e)[:200]}")
            return 0
        _events.emit("warmstart", action="load", path=path,
                     entries=len(entries), adopted=adopted)
        return adopted

    def run_batch(self, feeds: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
        """One bucket-shaped dispatch: the Predictor pads to the bucket,
        runs the prepared signature, and slices back; this layer adds
        the per-bucket latency/count/padding accounting."""
        n = common_batch(feeds)
        if not n:
            raise ValueError("feeds must share a leading batch dim >= 1")
        bucket = self.policy.bucket_for(n) or n
        t0 = time.perf_counter()
        # no-op without a sampled ambient context (the batcher activates
        # its lead request's trace around this call)
        with _tracing.trace_span("serve.dispatch", cat="serve",
                                 bucket=int(bucket), rows=int(n)):
            out = self._pred.predict_handle(**feeds).result()
        BUCKET_SECONDS.observe(time.perf_counter() - t0,
                               bucket=str(bucket))
        BATCHES.inc(bucket=str(bucket))
        if bucket != n:
            PAD_ROWS.inc(bucket - n)
        return out

    def status(self) -> Dict:
        return {
            "buckets": [int(b) for b in self.policy.buckets],
            "warmed": self.warmed,
            "precision": self.precision,
            "accuracy_delta": self.accuracy_delta,
            "analysis": self.analysis,
            "warmstart_adopted": self.warmstart_adopted,
            "batches": {str(b): BATCHES.value(bucket=str(b))
                        for b in self.policy.buckets},
            "feeds": self._pred.get_input_names(),
            "fetches": self._pred.get_output_names(),
        }
