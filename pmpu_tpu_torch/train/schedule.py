"""Host-side ReduceLROnPlateau (counterpart of
``pmpu_tpu/train/schedule.py:16``): torch's plateau semantics (mode,
factor, patience, relative threshold 1e-4, min_lr 0), stepped once per
validation round. Its state is a plain dataclass, so it checkpoints as a
dict of builtins that either package reads."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ReduceLROnPlateau:
    lr: float
    mode: str = "min"  # 'min' if n_classes > 1 else 'max'
    factor: float = 0.1
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float | None = None
    num_bad_epochs: int = field(default=0)

    def _is_better(self, current: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return current < self.best * (1.0 - self.threshold)
        return current > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Record one validation metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr,
            "mode": self.mode,
            "factor": self.factor,
            "patience": self.patience,
            "threshold": self.threshold,
            "min_lr": self.min_lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "ReduceLROnPlateau":
        return cls(**d)
