"""Loss pieces the inference path needs (counterpart of
``pmpu_tpu/ops/losses.py:26-43``); the training losses come later."""

from __future__ import annotations

import torch

DICE_SMOOTH = 1e-6


def dice_coeff(pred: torch.Tensor, target: torch.Tensor, smooth: float = DICE_SMOOTH):
    """Global soft Dice coefficient over everything, in f32."""
    p = pred.reshape(-1).float()
    t = target.reshape(-1).float()
    inter = torch.sum(p * t)
    return (2.0 * inter + smooth) / (torch.sum(p) + torch.sum(t) + smooth)
