"""Server LR schedules — ``make_lr_schedule`` and ``PlateauTracker``, which
the JAX package keeps in ``msrflute_tpu/optim/factory.py``.

Host-side: round index -> LR scalar (reference ``utils/utils.py:151-224``),
in Python floats, so each schedule equals the JAX package's at every
step.  ``val_loss`` (ReduceLROnPlateau) depends on validation results and
lives in :class:`PlateauTracker`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional


def make_lr_schedule(cfg, base_lr: float) -> Callable[[int], float]:
    if cfg is None or cfg.get("type", "step_lr") in ("constant", "val_loss"):
        return lambda step: base_lr
    kind = cfg.get("type", "step_lr")
    if kind == "step_lr":
        step_size = int(cfg.get("step_size", 1))
        gamma = float(cfg.get("gamma", 1.0))
        return lambda step: base_lr * (gamma ** (step // max(step_size, 1)))
    if kind == "multi_step_lr":
        milestones = sorted(cfg.get("milestones") or [])
        gamma = float(cfg.get("gamma", 1.0))
        return lambda step: base_lr * (
            gamma ** sum(1 for m in milestones if step >= m))
    if kind == "rampup-keep-expdecay-keep":
        return _rampup_keep_expdecay_keep(cfg, base_lr)
    raise ValueError(f"unknown annealing type {kind!r}")


def _rampup_keep_expdecay_keep(cfg, base_lr: float) -> Callable[[int], float]:
    """The SpecAugment schedule (reference ``utils/utils.py:189-224``): a
    linear ramp to ``peak_lr`` over ``rampup_steps``, ``peak_lr`` for
    ``hold_steps``, an exponential decay to ``floor_lr`` over
    ``decay_steps``, then ``floor_lr``."""
    peak = float(cfg.get("peak_lr", base_lr))
    floor = float(cfg.get("floor_lr", base_lr * 0.01))
    r = int(cfg.get("rampup_steps", 0))
    h = int(cfg.get("hold_steps", 0))
    d = max(int(cfg.get("decay_steps", 1)), 1)

    def sched(step: int) -> float:
        if r and step < r:
            return peak * (step + 1) / r
        step2 = step - r
        if step2 < h:
            return peak
        step3 = step2 - h
        if step3 < d:
            return peak * math.exp(math.log(max(floor / peak, 1e-12))
                                   * (step3 / d))
        return floor
    return sched


class PlateauTracker:
    """Multiply the LR by ``factor`` after ``patience`` rounds without a
    val-loss improvement (reference ``val_loss`` mode)."""

    def __init__(self, cfg, base_lr: float):
        self.lr = float(base_lr)
        self.factor = float(cfg.get("factor", 0.1))
        self.patience = int(cfg.get("patience", 10))
        self.best: Optional[float] = None
        self.bad_rounds = 0

    def step(self, val_loss: float) -> float:
        if self.best is None or val_loss < self.best:
            self.best = val_loss
            self.bad_rounds = 0
        else:
            self.bad_rounds += 1
            if self.bad_rounds > self.patience:
                self.lr *= self.factor
                self.bad_rounds = 0
        return self.lr
