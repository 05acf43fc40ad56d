"""Per-class Dice via argmax → one-hot (counterpart of
``pmpu_tpu/ops/metrics.py:16, 88``)."""

from __future__ import annotations

import torch

from pmpu_tpu_torch.ops.losses import DICE_SMOOTH, dice_coeff


def per_class_dice(preds: torch.Tensor, masks: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Dice for classes 1..n_classes-1 of NHWC logits or probs against
    integer masks (N,H,W) or (N,H,W,1); with ``n_classes == 1`` the
    (N,H,W,1) sigmoid probs are thresholded at 0.5. Shape (max(C-1, 1),)."""
    if masks.dim() == 4:
        masks = masks[..., 0]
    if n_classes == 1:
        hard = (preds[..., 0] > 0.5).float()
        return torch.stack([dice_coeff(hard, masks.float())])
    pred_cls = torch.argmax(preds, dim=-1)
    return torch.stack([
        dice_coeff((pred_cls == k).float(), (masks == k).float())
        for k in range(1, n_classes)
    ])


def volume_per_class_dice(pred_probs: torch.Tensor, truth: torch.Tensor, class_index: int):
    """Dice of the argmax one-hot of a class-last (X,Y,Z,C) volume against
    integer truth, for one class."""
    pred_cls = torch.argmax(pred_probs, dim=-1)
    return dice_coeff(
        (pred_cls == class_index).float(), (truth == class_index).float(), DICE_SMOOTH
    )
