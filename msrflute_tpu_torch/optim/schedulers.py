"""Server LR schedules — ``make_lr_schedule`` and ``PlateauTracker``, which
the JAX package keeps in ``msrflute_tpu/optim/factory.py``.

Host-side: round index -> LR scalar (reference ``utils/utils.py:151-224``).
``val_loss`` (ReduceLROnPlateau) depends on validation results and lives in
:class:`PlateauTracker`.  ``rampup-keep-expdecay-keep`` is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..config import NOT_PORTED


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
    raise NotImplementedError(f"annealing type {kind!r} is {NOT_PORTED}")


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
