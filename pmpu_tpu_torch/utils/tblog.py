"""TensorBoard metric writer with the reference's scalar and image tags
(counterpart of ``pmpu_tpu/utils/tblog.py:18``): Loss/train,
Loss/validation, learning_rate, dice/class_{k}, metrics/dice,
perf/slices_per_sec_per_chip; image triplets images, masks/true,
masks/pred. It writes through ``torch.utils.tensorboard`` where that
imports; otherwise (no ``tensorboard`` package) it keeps the scalars in
memory only and says so once in the log."""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

log = logging.getLogger(__name__)


class MetricWriter:
    def __init__(self, logdir=None, comment: str = "", enable_tb: bool = True):
        self.history = defaultdict(list)
        self._tb = None
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=logdir, comment=comment)
            except (ImportError, OSError) as e:
                log.warning("tensorboard unavailable (%s); metrics kept in memory only", e)

    def scalar(self, tag: str, value, step: int):
        v = float(value)
        self.history[tag].append((step, v))
        if self._tb:
            self._tb.add_scalar(tag, v, step)

    def images(self, tag: str, imgs, step: int):
        """imgs: (N,H,W,C) float in [0,1] — stored NHWC, forwarded as NCHW."""
        if self._tb:
            arr = np.asarray(imgs)
            if arr.ndim == 3:
                arr = arr[..., None]
            self._tb.add_images(tag, arr.transpose(0, 3, 1, 2), step)

    def close(self):
        if self._tb:
            self._tb.close()
