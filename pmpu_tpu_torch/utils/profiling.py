"""Profiler hooks of the port (counterpart of
``pmpu_tpu/utils/profiling.py:31, 41, 64, 70``): ``trace`` captures a
``torch.profiler`` trace of a block; ``scope`` labels a region of it (the
engine's ``record_function`` scopes ``slice_slabs``, ``model``,
``reassemble``, ... label its stages, as ``jax.named_scope`` does in the
JAX package). ``enable_nan_checks`` is the port's ``jax_debug_nans``
(``--nan-checks``). ``StepTimer`` turns host step times into
slices/s/chip, the training metric; ``rss_mb`` reads a process's host
RSS (the ``--rss-limit-mb`` re-execs and the soak harness).

``profiler_server`` and ``enable_compile_cache`` have no counterpart:
PyTorch runs eagerly and keeps no compilation cache (the kernels' build
directory is the port's only cache).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function


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


def rss_mb(pid="self") -> float:
    """Resident set size of process ``pid`` (default this one) in MB, from
    /proc; -1 where it cannot be read."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return -1.0


def scope(name: str):
    """A named region of a ``torch.profiler`` trace (no-op outside one)."""
    return record_function(name)


def _first_nan(out):
    """True when a tensor in ``out`` (a tensor, or tuples, lists, dicts and
    named tuples of them) holds a NaN."""
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and bool(torch.isnan(out).any())
    if isinstance(out, dict):
        return any(_first_nan(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_first_nan(v) for v in out)
    return False


def _nan_hook(module, args, output):
    if _first_nan(output):
        raise FloatingPointError(
            f"NaN in the output of {type(module).__name__} (--nan-checks)")


_nan_handle = None  # the global forward hook while the checks are on


def enable_nan_checks(enabled: bool = True):
    """NaN checks on every module's forward and on the backward pass, the
    port's ``jax_debug_nans`` (``--nan-checks``): a forward hook on every
    ``nn.Module`` of the process raises ``FloatingPointError`` naming the
    first module whose output holds a NaN (inner modules finish first), and
    ``torch.autograd.set_detect_anomaly`` raises at the backward function
    that returns one. NaN only, not Inf, as JAX checks. Each hook reads a
    flag back from the device, a synchronization a module: a debug mode,
    not for timed runs. ``enabled=False`` removes both."""
    global _nan_handle
    if enabled and _nan_handle is None:
        _nan_handle = torch.nn.modules.module.register_module_forward_hook(_nan_hook)
    elif not enabled and _nan_handle is not None:
        _nan_handle.remove()
        _nan_handle = None
    torch.autograd.set_detect_anomaly(enabled)


class StepTimer:
    """Host-clock step times → seconds a step (median) and slices/s a card
    (``n_chips``: the cards one step spans). The first step (kernel builds,
    cuDNN's algorithm search) is not counted."""

    def __init__(self, slices_per_step: int, n_chips: int = 1):
        self.slices_per_step = slices_per_step
        self.n_chips = n_chips
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
        return (self.slices_per_step / self.sec_per_step / self.n_chips if self._times
                else float("nan"))

    def summary(self) -> dict:
        return {
            "sec_per_step_median": self.sec_per_step,
            "slices_per_sec_per_chip": self.slices_per_sec,
            "steps_timed": len(self._times),
        }
