"""Profiler hooks of the port (counterpart of
``pmpu_tpu/utils/profiling.py:31``): ``trace`` captures a ``torch.profiler``
trace of a block; the engine's ``record_function`` scopes (``slice_slabs``,
``model``, ``reassemble``, ...) label its stages, as ``jax.named_scope``
does in the JAX package.
"""

from __future__ import annotations

import contextlib
import os

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
