"""Convergence detection — paper §III-B.7 (a copy of the reference's
``repro/core/convergence.py``).

Two host-side controllers driven by a validation metric:
  * :class:`ReduceLROnPlateau` — PyTorch-semantics LR reduction.
  * :class:`EarlyStopping` — stop when the metric stops improving.
``ConvergenceDetector`` combines them exactly as the paper describes: LR is
reduced when improvement stalls; training stops on sustained degradation or
at the epoch limit.
"""
from __future__ import annotations

import math
from typing import Optional


class ReduceLROnPlateau:
    def __init__(
        self,
        lr: float,
        *,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 2,
        threshold: float = 1e-4,
        min_lr: float = 1e-6,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.num_reductions = 0

    def _improved(self, metric: float) -> bool:
        if not math.isfinite(metric):
            # NaN compares False against everything, which without this
            # guard would leave bad_epochs frozen; Inf/-Inf would become an
            # unbeatable "best". A diverged metric is always a bad epoch.
            return False
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best - self.threshold
        return metric > self.best + self.threshold

    def step(self, metric: float) -> float:
        """Feed one validation metric; returns the (possibly reduced) lr."""
        if self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                new_lr = max(self.lr * self.factor, self.min_lr)
                if new_lr < self.lr:
                    self.num_reductions += 1
                self.lr = new_lr
                self.bad_epochs = 0
        return self.lr


class EarlyStopping:
    def __init__(self, *, mode: str = "min", patience: int = 5, min_delta: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.stopped = False

    def step(self, metric: float) -> bool:
        """Feed one validation metric; returns True when training should stop."""
        improved = math.isfinite(metric) and (
            self.best is None
            or (self.mode == "min" and metric < self.best - self.min_delta)
            or (self.mode == "max" and metric > self.best + self.min_delta)
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.stopped = True
        return self.stopped


class ConvergenceDetector:
    """ReduceLROnPlateau + EarlyStopping + epoch limit (paper §III-B.7)."""

    def __init__(
        self,
        lr: float,
        *,
        mode: str = "min",
        plateau_patience: int = 2,
        stop_patience: int = 6,
        factor: float = 0.5,
        max_epochs: int = 100,
    ):
        self.plateau = ReduceLROnPlateau(
            lr, mode=mode, factor=factor, patience=plateau_patience
        )
        self.stopper = EarlyStopping(mode=mode, patience=stop_patience)
        self.max_epochs = max_epochs
        self.epoch = 0

    @property
    def lr(self) -> float:
        return self.plateau.lr

    def step(self, metric: float) -> bool:
        """Returns True when converged / should stop."""
        self.epoch += 1
        self.plateau.step(metric)
        stop = self.stopper.step(metric)
        return stop or self.epoch >= self.max_epochs
