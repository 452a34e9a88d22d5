# Copied from the JAX package: paddle_tpu/slim/core.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Config-driven compression orchestration.

Reference: contrib/slim/core/compressor.py:236 `Compressor` — the YAML-
driven driver that owns the train/eval loops and schedules compression
strategies (quantization / sensitivity pruning / distillation) across
epochs via on_compression_begin / on_epoch_begin / on_epoch_end /
on_compression_end hooks (strategy base: contrib/slim/core/strategy.py).

Same shape here: `Compressor(place, scope, train_program, ...)` +
`.config(yaml_or_dict)` + `.run()`. Strategies wrap the existing slim
primitives (qat.QuantizationTransformPass, prune.Pruner/
SensitivePruneStrategy, distillation soft-label loss) with epoch
scheduling; the YAML schema mirrors the reference's
`strategies:` / `compressor:` sections.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.framework import Program


def _strip_training_ops(train_program: Program) -> Program:
    """Forward-only clone for evaluation: drop backward / optimizer /
    lr-schedule ops so an eval pass can NEVER mutate parameters or
    optimizer state (the reference Compressor takes a separate
    eval_program for the same reason, compressor.py:236)."""
    from ..core.framework import OpRole

    p = train_program.clone(for_test=True)
    drop = OpRole.Backward | OpRole.Optimize | OpRole.LRSched
    for b in p.desc.blocks:
        b.ops = [op for op in b.ops
                 if not int(op.attrs.get(OpRole.AttrName, 0)) & drop]
    p._rebuild_from_desc()
    return p


class CompressionContext:
    """What strategies see: the live training state.

    train_program is the PERSISTENT student program — mutating
    strategies (QAT insertion, mask application) always target it.
    active_program is what the train loop executes THIS epoch; the loop
    resets it to train_program at every epoch start, so a strategy that
    swaps it (distillation) holds the swap exactly for the epochs its
    hooks run — restoration is automatic, including when the range
    covers the final epoch."""

    def __init__(self, place, scope, train_program, startup_program,
                 executor, eval_fn, epoch=0, has_eval=False,
                 distill_program=None):
        self.place = place
        self.scope = scope
        self.train_program = train_program
        self.active_program = train_program
        self.distill_program = distill_program
        self.startup_program = startup_program
        self.executor = executor
        self.eval_fn = eval_fn
        self.has_eval = has_eval
        self.epoch = epoch
        self.eval_history: List[float] = []


class Strategy:
    """Hook base (reference: contrib/slim/core/strategy.py)."""

    start_epoch = 0
    end_epoch = 10 ** 9

    def on_compression_begin(self, ctx: CompressionContext):
        pass

    def on_epoch_begin(self, ctx: CompressionContext):
        pass

    def on_epoch_end(self, ctx: CompressionContext):
        pass

    def on_compression_end(self, ctx: CompressionContext):
        pass


class QuantizationStrategy(Strategy):
    """Schedule QAT: insert fake-quant ops at start_epoch (reference:
    slim/quantization/quantization_strategy.py)."""

    def __init__(self, start_epoch: int = 0, end_epoch: int = 10 ** 9,
                 weight_bits: int = 8,
                 activation_bits: int = 8,
                 weight_quantize_type: str = "channel_wise_abs_max",
                 activation_quantize_type: str = "moving_average_abs_max"):
        self.start_epoch = int(start_epoch)
        self.end_epoch = int(end_epoch)
        self.kw = dict(weight_bits=weight_bits,
                       activation_bits=activation_bits,
                       weight_quantize_type=weight_quantize_type,
                       activation_quantize_type=activation_quantize_type)
        self.applied = False

    def on_epoch_begin(self, ctx):
        if self.applied or ctx.epoch < self.start_epoch:
            return
        from .qat import QuantizationTransformPass

        QuantizationTransformPass(**self.kw).apply(
            ctx.train_program, ctx.startup_program)
        # the startup program already ran (compression begin); seed the
        # freshly-created quant state vars straight into the live scope
        # with the same values init_scales emits
        desc = ctx.train_program.global_block().desc
        for name in desc.vars:
            if not name.endswith((".quant_in_scale", ".quant_state",
                                  ".quant_accum")):
                continue
            if ctx.scope.find_var(name) is None:
                val = 1.0 if name.endswith(".quant_state") else 0.001
                ctx.scope.set_var(name, np.full((1,), val, np.float32))
        self.applied = True


class SensitivePruneStrategyScheduled(Strategy):
    """Sensitivity-driven pruning at start_epoch (reference:
    slim/prune/prune_strategy.py:241 SensitivePruneStrategy): measure the
    eval-metric drop per (param, ratio), pick the largest per-param ratio
    under `max_metric_drop`, prune, and pin masks through the remaining
    epochs."""

    def __init__(self, pruned_params: Sequence[str],
                 start_epoch: int = 0, end_epoch: int = 10 ** 9,
                 max_metric_drop: float = 0.05,
                 sensitivity_ratios: Sequence[float] = (0.1, 0.3, 0.5, 0.7),
                 mode: str = "ratio"):
        self.start_epoch = int(start_epoch)
        self.end_epoch = int(end_epoch)
        self.params = list(pruned_params)
        self.max_drop = float(max_metric_drop)
        self.ratios = list(sensitivity_ratios)
        self.mode = mode
        self.applied = False
        self.chosen: Dict[str, float] = {}

    def on_epoch_begin(self, ctx):
        if self.applied or ctx.epoch < self.start_epoch:
            return
        if not ctx.has_eval:
            raise ValueError(
                "SensitivePruneStrategy needs the Compressor's eval_func: "
                "without a metric every prune ratio shows zero drop and "
                "the maximum candidate ratio would be chosen blindly")
        from .prune import Pruner, SensitivePruneStrategy

        pruner = Pruner(self.mode)
        strat = SensitivePruneStrategy(pruner, self.ratios)
        sens = strat.sensitivity(ctx.scope, self.params, ctx.eval_fn)
        self.chosen = strat.pick_ratios(sens, self.max_drop)
        masks = pruner.prune(ctx.scope, self.params, self.chosen)
        pruner.apply_masks(ctx.train_program, ctx.scope, masks)
        self.applied = True


class UniformPruneStrategy(Strategy):
    """Fixed-ratio magnitude pruning at start_epoch (reference:
    slim/prune/prune_strategy.py UniformPruneStrategy)."""

    def __init__(self, pruned_params: Sequence[str], ratio: float = 0.5,
                 start_epoch: int = 0, end_epoch: int = 10 ** 9,
                 mode: str = "ratio"):
        self.start_epoch = int(start_epoch)
        self.end_epoch = int(end_epoch)
        self.params = list(pruned_params)
        self.ratio = float(ratio)
        self.mode = mode
        self.applied = False

    def on_epoch_begin(self, ctx):
        if self.applied or ctx.epoch < self.start_epoch:
            return
        from .prune import Pruner

        pruner = Pruner(self.mode)
        masks = pruner.prune(ctx.scope, self.params,
                             {"*": self.ratio})
        pruner.apply_masks(ctx.train_program, ctx.scope, masks)
        self.applied = True


class DistillationStrategy(Strategy):
    """Schedule knowledge distillation for an epoch range (reference:
    slim/distillation/distillation_strategy.py — trains on the
    distillation graph within [start_epoch, end_epoch] and on the plain
    student graph outside it). The distill program (student + spliced
    teacher + distill loss + optimizer, built with
    slim.distillation.merge) comes from the Compressor's
    `distill_program` argument — YAML cannot carry a Program. Since the
    run loop resets active_program every epoch, no restore bookkeeping
    is needed; hooks only fire inside the range."""

    def __init__(self, start_epoch: int = 0, end_epoch: int = 10 ** 9):
        self.start_epoch = int(start_epoch)
        self.end_epoch = int(end_epoch)
        self.distilled_epochs: List[int] = []

    def on_epoch_begin(self, ctx):
        if ctx.distill_program is None:
            raise ValueError(
                "DistillationStrategy needs Compressor(distill_program=...) "
                "— build it with slim.distillation.merge + a distill loss")
        ctx.active_program = ctx.distill_program
        self.distilled_epochs.append(ctx.epoch)


_STRATEGY_TYPES = {
    "QuantizationStrategy": QuantizationStrategy,
    "SensitivePruneStrategy": SensitivePruneStrategyScheduled,
    "UniformPruneStrategy": UniformPruneStrategy,
    "DistillationStrategy": DistillationStrategy,
}


class Compressor:
    """reference: contrib/slim/core/compressor.py:236.

    train_reader: callable -> iterable of feed dicts (one epoch).
    eval_func: callable(program, executor, scope) -> float metric
               (higher = better), or None to skip eval.
    """

    def __init__(self, place, scope, train_program: Program,
                 startup_program: Optional[Program] = None,
                 train_reader: Optional[Callable] = None,
                 train_fetch_list: Optional[Sequence] = None,
                 eval_func: Optional[Callable] = None,
                 distill_program: Optional[Program] = None,
                 epoch: int = 1):
        from ..core.executor import Executor

        self.place = place
        self.scope = scope
        self.train_program = train_program
        self.startup_program = startup_program
        self.train_reader = train_reader
        self.train_fetch_list = list(train_fetch_list or [])
        self.eval_func = eval_func
        # student + spliced teacher + distill loss (+ optimizer), for
        # DistillationStrategy epochs (reference: teacher_programs arg)
        self.distill_program = distill_program
        self.epoch = int(epoch)
        self.strategies: List[Strategy] = []
        self.executor = Executor(place)
        # eval runs on a forward-only clone of the PERSISTENT student
        # program (never the distill graph — the student params live in
        # the shared scope, so evaluating the student is both correct
        # and teacher-free) so an eval or sensitivity probe can never
        # take an optimizer step; regenerated when a strategy mutates
        # the program, keeping only the latest version's clone
        self._eval_prog = None
        self._eval_prog_version = None

    def _eval_program(self) -> Program:
        ver = getattr(self.train_program, "_version", None)
        if self._eval_prog is None or self._eval_prog_version != ver:
            self._eval_prog = _strip_training_ops(self.train_program)
            self._eval_prog_version = ver
        return self._eval_prog

    # -- configuration (YAML path / YAML string / dict) ----------------------

    def config(self, config) -> "Compressor":
        if isinstance(config, str):
            import os

            import yaml

            if os.path.exists(config):
                text = open(config).read()
            elif "\n" in config or ":" in config:
                text = config        # inline YAML
            else:
                raise FileNotFoundError(
                    f"compressor config file not found: {config!r}")
            config = yaml.safe_load(text)
            if not isinstance(config, dict):
                raise ValueError(
                    "compressor config must parse to a mapping with "
                    "'strategies'/'compressor' sections")
        strategies = config.get("strategies", {}) or {}
        for name, spec in strategies.items():
            spec = dict(spec or {})
            cls_name = spec.pop("class", None) or name
            cls = _STRATEGY_TYPES.get(cls_name)
            if cls is None:
                raise ValueError(
                    f"unknown compression strategy '{cls_name}' "
                    f"(known: {sorted(_STRATEGY_TYPES)})")
            if cls is DistillationStrategy and self.distill_program is None:
                raise ValueError(
                    "DistillationStrategy configured but the Compressor "
                    "was built without distill_program= — fail now, not "
                    "after training up to its start_epoch")
            self.strategies.append(cls(**spec))
        comp = config.get("compressor", {}) or {}
        if "epoch" in comp:
            self.epoch = int(comp["epoch"])
        return self

    # -- the driver loop -----------------------------------------------------

    def _eval(self, ctx) -> Optional[float]:
        if self.eval_func is None:
            return None
        m = float(self.eval_func(self._eval_program(), self.executor,
                                 self.scope))
        ctx.eval_history.append(m)
        return m

    def run(self) -> CompressionContext:
        from ..core.executor import scope_guard

        ctx = CompressionContext(
            self.place, self.scope, self.train_program,
            self.startup_program, self.executor,
            eval_fn=lambda: (self.eval_func(self._eval_program(),
                                            self.executor, self.scope)
                             if self.eval_func else 0.0),
            has_eval=self.eval_func is not None,
            distill_program=self.distill_program)
        with scope_guard(self.scope):
            if self.startup_program is not None:
                self.executor.run(self.startup_program)
            for s in self.strategies:
                s.on_compression_begin(ctx)
            for e in range(self.epoch):
                ctx.epoch = e
                # reset each epoch: a swap (distillation) lasts exactly
                # as long as its strategy's hooks keep setting it
                ctx.active_program = ctx.train_program
                for s in self.strategies:
                    if s.start_epoch <= e <= s.end_epoch:
                        s.on_epoch_begin(ctx)
                if self.train_reader is not None:
                    for feed in self.train_reader():
                        self.executor.run(ctx.active_program, feed=feed,
                                          fetch_list=self.train_fetch_list)
                for s in self.strategies:
                    if s.start_epoch <= e <= s.end_epoch:
                        s.on_epoch_end(ctx)
                self._eval(ctx)
            # a swap covering the final epoch must not leak out of run():
            # the returned ctx and on_compression_end always see the
            # persistent student program as active
            ctx.active_program = ctx.train_program
            for s in self.strategies:
                s.on_compression_end(ctx)
        return ctx
