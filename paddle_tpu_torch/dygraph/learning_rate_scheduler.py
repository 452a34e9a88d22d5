# Copied from the JAX package: paddle_tpu/dygraph/learning_rate_scheduler.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Dygraph LR schedulers (reference: python/paddle/fluid/dygraph/
learning_rate_scheduler.py) — plain Python step functions in eager mode."""

from __future__ import annotations

import math

__all__ = ["LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
           "CosineDecay", "NoamDecay"]


class LearningRateDecay:
    def __init__(self, begin=0, step=1, dtype="float32"):
        self.step_num = begin
        self.step_size = step

    def __call__(self):
        lr = self.step()
        self.step_num += self.step_size
        return lr

    def step(self):
        raise NotImplementedError


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1):
        super().__init__(begin, step)
        self.boundaries = boundaries
        self.values = values

    def step(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return self.values[i]
        return self.values[-1]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate, staircase=False,
                 begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.decay_steps = learning_rate, decay_steps
        self.decay_rate, self.staircase = decay_rate, staircase

    def step(self):
        d = self.step_num / self.decay_steps
        if self.staircase:
            d = math.floor(d)
        return self.lr * math.exp(-self.decay_rate * d)


class ExponentialDecay(NaturalExpDecay):
    def step(self):
        d = self.step_num / self.decay_steps
        if self.staircase:
            d = math.floor(d)
        return self.lr * (self.decay_rate ** d)


class InverseTimeDecay(NaturalExpDecay):
    def step(self):
        d = self.step_num / self.decay_steps
        if self.staircase:
            d = math.floor(d)
        return self.lr / (1 + self.decay_rate * d)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.decay_steps = learning_rate, decay_steps
        self.end_lr, self.power, self.cycle = end_learning_rate, power, cycle

    def step(self):
        s = min(self.step_num, self.decay_steps)
        frac = 1 - s / self.decay_steps
        return (self.lr - self.end_lr) * (frac ** self.power) + self.end_lr


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.spe, self.epochs = learning_rate, step_each_epoch, epochs

    def step(self):
        epoch = self.step_num // self.spe
        return 0.5 * self.lr * (1 + math.cos(math.pi * epoch / self.epochs))


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1, learning_rate=1.0):
        super().__init__(begin, step)
        self.d_model, self.warmup, self.lr = d_model, warmup_steps, learning_rate

    def step(self):
        n = max(self.step_num, 1)
        return self.lr * (self.d_model ** -0.5) * min(n ** -0.5,
                                                      n * self.warmup ** -1.5)
