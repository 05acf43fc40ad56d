"""Profiler hooks of the port (counterpart of
``pmpu_tpu/utils/profiling.py:31, 70``): ``trace`` captures a
``torch.profiler`` trace of a block; the engine's ``record_function``
scopes (``slice_slabs``, ``model``, ``reassemble``, ...) label its stages,
as ``jax.named_scope`` does in the JAX package. ``StepTimer`` turns host
step times into slices/s/chip, the training metric.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block: host ops always, CUDA kernels and copies
    when a card is present. Writes ``logdir/trace.json`` (Chrome trace
    format) at the end of the block and yields the profiler, whose
    ``key_averages()`` sum the ops by name."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Host-clock step times → seconds a step (median) and slices/s on the
    one card the step runs on. The first step (kernel builds, cuDNN's
    algorithm search) is not counted."""

    def __init__(self, slices_per_step: int):
        self.slices_per_step = slices_per_step
        self._times: list[float] = []
        self._seen = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > 1:
            self._times.append(dt)
        return dt

    @property
    def sec_per_step(self) -> float:
        return float(np.median(self._times)) if self._times else float("nan")

    @property
    def slices_per_sec(self) -> float:
        return self.slices_per_step / self.sec_per_step if self._times else float("nan")

    def summary(self) -> dict:
        return {
            "sec_per_step_median": self.sec_per_step,
            "slices_per_sec_per_chip": self.slices_per_sec,
            "steps_timed": len(self._times),
        }
