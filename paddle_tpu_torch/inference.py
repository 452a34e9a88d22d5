"""Inference predictor — the deployment API, on the port.

Reference: paddle/fluid/inference/ — `PaddlePredictor`/`AnalysisPredictor`
(api/paddle_api.h:204, api/analysis_predictor.h:47): load a saved
inference model, prepare it, and expose Run() with a config object
(AnalysisConfig). Counterpart of the JAX package's `inference.py`.

The JAX package compiles one XLA executable per input signature. The
port runs the loaded program op by op (`core/lowering.py`) on the
program's persistable state, moved to the device and, under a policy
with `cast_state`, cast to the policy's width once at the first
request (never per request), and keeps one prepared step per input
signature. `warm(b)` runs bucket b's step once on zero feeds, the
port's counterpart of an AOT compile; a signature cache that stays at
the bucket set is the same closed-world check as the JAX package's
compile count.

Devices are explicit: an `AnalysisConfig` runs on the card
(`CUDAPlace(device_id)`) unless `disable_gpu()` asks for the CPU. The
native C++ engine (`enable_native_engine`) is not ported (ROADMAP item
21).
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import io
from .core import lowering
from .core import precision as _precision
from .core.async_exec import FetchHandle
from .core.executor import Executor, Scope, scope_guard
from .core.ir import normalize_dtype
from .core.places import CPUPlace, CUDAPlace
from .core.registry import dtype_name, torch_dtype
from .observability import telemetry as _telemetry
from .ops import quant as _quant

__all__ = ["AnalysisConfig", "PaddleTensor", "Predictor",
           "create_paddle_predictor"]


class AnalysisConfig:
    """reference: inference/api/analysis_config.cc, with the JAX
    package's methods. `switch_ir_optim`, `enable_memory_optim` and
    `enable_profile` set their flags, which nothing reads, as there."""

    def __init__(self, model_dir: Optional[str] = None):
        self.model_dir = model_dir
        self._use_tpu = True            # the accelerator: the card
        self._device_id = 0
        self._enable_profile = False
        self._aot = False               # warm each signature at first use
        self._bucketing = None          # serving.bucketing.BucketPolicy
        self._precision = None          # core.precision policy name

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_tpu = True
        self._device_id = device_id

    def disable_gpu(self):
        """Run on the CPU."""
        self._use_tpu = False

    def switch_ir_optim(self, x=True):
        """Accepted for scripts written against the reference: the port
        runs the program as loaded and reads no IR-optimisation flag."""
        self._ir_optim = x

    def enable_memory_optim(self):
        """Accepted for scripts written against the reference: the port
        reads no memory-optimisation flag (the CUDA caching allocator
        reuses buffers on its own)."""
        self._memory_optim = True

    def enable_profile(self):
        """Sets the flag, which nothing reads, as in the JAX package:
        profile a Predictor with `paddle_tpu_torch.profiler`."""
        self._enable_profile = True

    def enable_aot(self):
        """Warm every signature when it is first prepared (the JAX
        package compiles it ahead of time there)."""
        self._aot = True

    def enable_bucketing(self, max_batch: int = 64, buckets=None):
        """Round every Run() batch up to the nearest configured bucket
        (powers of two up to `max_batch` by default, or an explicit
        `buckets` sequence), padding feeds and slicing outputs back to
        the true batch, so bs=1..64 traffic prepares at most
        log2(64)+1 signatures. Batches larger than the biggest bucket
        run at their exact shape. See SERVING.md §Bucket policy."""
        from .serving.bucketing import BucketPolicy

        self._bucketing = BucketPolicy(max_batch=max_batch,
                                       buckets=buckets)

    def set_precision(self, name: Optional[str]):
        """Serve under a named precision policy ("f32" | "bf16" |
        "mixed_bf16"): floating feeds take the policy's compute dtype
        and the program runs under its autocast. Resolution order: this
        config > the loaded program's precision attr >
        PADDLE_TPU_PRECISION > f32."""
        if name is not None:
            _precision.get_policy(name)  # fail fast on typos
        self._precision = name

    def enable_native_engine(self):
        raise NotImplementedError(
            "the native C++ engine (native/, capi.py) is not ported "
            "(ROADMAP item 21); serve through the Predictor")


class PaddleTensor:
    """reference: api/paddle_api.h PaddleTensor — named ndarray."""

    def __init__(self, data, name: str = ""):
        self.name = name
        self.data = np.asarray(data)

    @property
    def shape(self):
        return self.data.shape


class Predictor:
    """reference: AnalysisPredictor. Loads the model once; each distinct
    input signature is prepared once and cached."""

    def __init__(self, config: AnalysisConfig):
        self.config = config
        place = CUDAPlace(config._device_id) if config._use_tpu \
            else CPUPlace()
        self._exe = Executor(place)
        self._device = self._exe.device
        self._scope = Scope()
        with scope_guard(self._scope):
            (self._program, self._feed_names,
             self._fetch_vars) = io.load_inference_model(
                config.model_dir, self._exe)
        self._fetch_names = [v if isinstance(v, str) else v.name
                             for v in self._fetch_vars]
        self._program._is_test = True
        # one policy per Predictor, resolved at load: config >
        # program attr (a model saved under a policy keeps it) > env
        self._policy = _precision.resolve(self._program,
                                          explicit=config._precision)
        # signature -> warm (its step has run once)
        self._cache: Dict[Tuple, bool] = {}
        self._state: Optional[Dict[str, torch.Tensor]] = None
        # which fetches carry the batch dim (declared leading dim is
        # dynamic): bucketing must never slice an output whose fixed
        # leading dim merely coincides with the bucket size. None =
        # shape undeclared → fall back to the runtime-shape heuristic.
        self._fetch_batched: Dict[str, Optional[bool]] = {
            name: self._var_batched(name) for name in self._fetch_names}
        # feeds get the symmetric treatment: a feed whose declared
        # leading dim is fixed (lookup tables, masks) must be neither
        # counted toward the batch size nor padded
        self._feed_batched: Dict[str, Optional[bool]] = {
            name: self._var_batched(name) for name in self._feed_names}

    def _var_batched(self, name: str) -> Optional[bool]:
        """Does `name`'s declared leading dim carry the batch (-1/0 =
        dynamic)? None when the shape is undeclared."""
        var = self._find_var(name)
        shape = var.shape if var is not None else None
        if shape is None:
            return None
        return bool(shape) and shape[0] in (-1, 0)

    def _find_var(self, name: str):
        """First match across blocks (a sub-block local must not shadow
        the outer var)."""
        for b in self._program.desc.blocks:
            if name in b.vars:
                return b.vars[name]
        return None

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def signatures(self) -> List[Tuple]:
        """The prepared signatures, in the order they were first
        seen."""
        return list(self._cache)

    def _feed_dtype(self, declared) -> torch.dtype:
        """The dtype a feed declared `declared` runs at under the
        policy."""
        return self._policy.feed_dtype(
            torch_dtype(normalize_dtype(declared)))

    def _forward(self, feeds: Dict[str, torch.Tensor], state):
        env = dict(state)
        env.update(feeds)
        with torch.no_grad(), _precision.autocast(self._policy):
            lowering.lower_block(self._program.desc, 0, env, rng_key=None,
                                 is_test=True, device=self._device)
        return [env[n] for n in self._fetch_names]

    def _zero_feeds(self, sig) -> Dict[str, torch.Tensor]:
        return {n: torch.zeros(s, dtype=torch_dtype(d), device=self._device)
                for n, s, d in sig}

    def _program_state(self) -> Dict[str, torch.Tensor]:
        """The program's persistable values on the device, shared by
        every signature; under a `cast_state` policy cast to its compute
        dtype here, once, and the int8 ops' weights laid out as their
        products' operands here, once."""
        if self._state is None:
            policy = self._policy
            state = {}
            for b in self._program.desc.blocks:
                for name, v in b.vars.items():
                    if not v.persistable or name in state:
                        continue
                    val = self._scope.find_var(name)
                    if val is None:
                        continue
                    t = torch.as_tensor(val, device=self._device)
                    if policy.cast_state:
                        t = _precision.cast_floating(t,
                                                     policy.compute_dtype)
                    state[name] = t
            for b in self._program.desc.blocks:
                for op in b.ops:
                    if op.type not in _quant.WEIGHT_SLOTS:
                        continue
                    name = op.inputs[_quant.WEIGHT_SLOTS[op.type]][0]
                    if name in state:
                        _quant.lay_out_weight(op.type, op.attrs,
                                              state[name])
            self._state = state
        return self._state

    def _prepare(self, sig, warm: Optional[bool] = None):
        """Enter `sig` in the signature cache, warming it when `warm`
        (default: `enable_aot`)."""
        if sig not in self._cache:
            self._cache[sig] = False
            if self.config._aot if warm is None else warm:
                self._warm(sig)

    def _warm(self, sig) -> bool:
        if not self._cache[sig]:
            self._forward(self._zero_feeds(sig), self._program_state())
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            self._cache[sig] = True
        return True

    def _feed_sig(self, batch_size: int):
        """Signature tuple for the declared feed shapes at `batch_size`
        (leading dynamic dim replaced; any other dynamic dim is an
        error — such a model must be warmed by running a real batch)."""
        entries = []
        for name in self._feed_names:
            var = self._find_var(name)
            if var is None or var.shape is None:
                raise ValueError(f"feed '{name}' has no declared shape; "
                                 "cannot warm ahead of traffic")
            shape = [int(d) for d in var.shape]
            if shape and shape[0] in (-1, 0):
                shape[0] = int(batch_size)
            if any(d < 1 for d in shape):
                raise ValueError(
                    f"feed '{name}' has non-batch dynamic dims "
                    f"{tuple(var.shape)}; warm it with a real batch")
            entries.append((name, tuple(shape),
                            dtype_name(self._feed_dtype(var.dtype))))
        return tuple(sorted(entries))

    def warm(self, batch_size: int) -> bool:
        """Prepare and run the signature for `batch_size` once on zero
        feeds, so no live request pays the first run — a bucketed
        serving deployment warms every configured bucket at startup.
        Returns whether the signature is warm."""
        sig = self._feed_sig(batch_size)
        self._prepare(sig, warm=False)
        return self._warm(sig)

    # -- warmstart (fingerprints of warmed signatures) -----------------

    def _fingerprint(self, sig) -> str:
        """What a warmed signature must match to be adopted: the
        signature, the program, the policy and the device."""
        doc = {"signature": [[n, list(s), d] for n, s, d in sig],
               "program": self._program.desc.to_dict(),
               "fetches": self._fetch_names, "policy": self._policy.name,
               "device": str(self._device)}
        return hashlib.sha256(json.dumps(doc, sort_keys=True,
                                         default=str).encode()).hexdigest()

    def serialize_warm(self) -> Dict[Tuple, Dict]:
        """{signature: {"fingerprint": ...}} for every warmed signature,
        the payload of a serving warmstart artifact. Nothing compiled
        can be carried across processes here, so an entry is the
        signature's fingerprint only (as the decode engine's)."""
        return {sig: {"fingerprint": self._fingerprint(sig)}
                for sig, warm in self._cache.items() if warm}

    def adopt_warm(self, entries: Dict[Tuple, Dict]) -> int:
        """Warm each signature of `entries` whose fingerprint matches
        this process's (the inverse of serialize_warm, called by the
        serving engine at boot). A malformed or mismatched entry is
        skipped, never raised: it costs a cold bucket, not a boot.
        Returns how many signatures were adopted."""
        adopted = 0
        for sig, entry in entries.items():
            try:
                sig = tuple((str(n), tuple(int(d) for d in s), str(dt))
                            for n, s, dt in sig)
                if entry["fingerprint"] != self._fingerprint(sig):
                    continue
                self._prepare(sig, warm=False)
                self._warm(sig)
                adopted += 1
            except Exception:
                continue
        return adopted

    def run(self, inputs: Sequence[PaddleTensor]) -> List[PaddleTensor]:
        return self.run_handle(inputs).result()

    def run_handle(self, inputs: Sequence[PaddleTensor]):
        """Dispatch without fetching: returns a lazy
        core.async_exec.FetchHandle whose `.result()` is the
        List[PaddleTensor] `run` would return — pad-slice bucketing
        included. The device computes while the caller (the serving
        Engine) does other host work."""
        feeds = {}
        for i, t in enumerate(inputs):
            name = t.name or self._feed_names[i]
            var = self._find_var(name)
            arr = np.asarray(t.data)
            if var is not None:
                want = np.dtype(normalize_dtype(var.dtype)) \
                    if normalize_dtype(var.dtype) != "bfloat16" \
                    else np.dtype(np.float32)
                if arr.dtype != want:
                    arr = arr.astype(want)
            feeds[name] = arr
        # opt-in shape bucketing: pad the batch up to its bucket so the
        # signature cache stays bounded by the bucket set, then slice
        # outputs back to the true batch (rows whose leading dim is the
        # bucket)
        policy = self.config._bucketing
        true_n = bucket = None
        if policy is not None:
            from .serving.bucketing import common_batch

            batched = {k: v for k, v in feeds.items()
                       if self._feed_batched.get(k) is not False}
            n = common_batch(batched) if batched else None
            if n:
                b = policy.bucket_for(n)
                if b is not None and b != n:
                    feeds = {k: (policy.pad_batch(v, b) if k in batched
                                 else v)
                             for k, v in feeds.items()}
                    true_n, bucket = n, b
        tensors = {}
        for name, arr in feeds.items():
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(self._device)
            var = self._find_var(name)
            if var is not None:
                want = self._feed_dtype(var.dtype)
                if t.dtype != want:
                    t = t.to(want)
            tensors[name] = t
        sig = tuple(sorted((n, tuple(v.shape), dtype_name(v.dtype))
                           for n, v in tensors.items()))
        # the dispatch is an executor step (mode "infer"): the port runs
        # the program here, where the JAX package dispatches its jitted
        # signature
        with _telemetry.executor_step("infer") as rec:
            rec.set_feed(tensors)
            self._prepare(sig)
            outs = self._forward(tensors, self._program_state())

        def postprocess(arrs):
            results = []
            for a, name in zip(arrs, self._fetch_names):
                if true_n is not None and a.ndim \
                        and a.shape[0] == bucket \
                        and self._fetch_batched.get(name) is not False:
                    a = a[:true_n]
                results.append(PaddleTensor(a, name=name))
            return results

        return FetchHandle(outs, site="infer", numpy=True).map(postprocess)

    # numpy-dict convenience API
    def predict(self, **feeds) -> Dict[str, np.ndarray]:
        return self.predict_handle(**feeds).result()

    def predict_handle(self, **feeds):
        """Lazy predict: dispatch now, numpy dict on `.result()`."""
        tensors = [PaddleTensor(v, name=k) for k, v in feeds.items()]
        return self.run_handle(tensors).map(
            lambda ts: {t.name: t.data for t in ts})


def create_paddle_predictor(config: AnalysisConfig) -> Predictor:
    """reference: api/paddle_api.h:346 CreatePaddlePredictor."""
    return Predictor(config)
