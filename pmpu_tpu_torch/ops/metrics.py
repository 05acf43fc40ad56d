"""Per-class Dice via argmax → one-hot, and the generalized energy distance
(counterpart of ``pmpu_tpu/ops/metrics.py``)."""

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


def _pairwise_iou_distance(a: torch.Tensor, b: torch.Tensor, n_classes: int) -> torch.Tensor:
    """d(a,b) = 1 − mean over the foreground classes of the IoU of two
    integer segmentations (1 for a class absent from both), f32."""
    ious = []
    for c in range(1, n_classes):
        pa, pb = a == c, b == c
        inter = (pa & pb).sum().float()
        union = (pa | pb).sum().float()
        ious.append(torch.where(union == 0, torch.ones_like(union), inter / union))
    return 1.0 - torch.stack(ious).mean()


def generalized_energy_distance(samples: torch.Tensor, truths: torch.Tensor,
                                n_classes: int) -> torch.Tensor:
    """GED² = 2·E[d(s,y)] − E[d(s,s')] − E[d(y,y')] with d = 1 − IoU, over
    (N, ...) sampled and (M, ...) ground-truth integer maps; f32."""
    def mean_d(xs, ys):
        return torch.stack([_pairwise_iou_distance(x, y, n_classes) for x in xs for y in ys]).mean()

    return 2.0 * mean_d(samples, truths) - mean_d(samples, samples) - mean_d(truths, truths)


def volume_per_class_dice(pred_probs: torch.Tensor, truth: torch.Tensor, class_index: int):
    """Dice of the argmax one-hot of a class-last (X,Y,Z,C) volume against
    integer truth, for one class."""
    pred_cls = torch.argmax(pred_probs, dim=-1)
    return dice_coeff(
        (pred_cls == class_index).float(), (truth == class_index).float(), DICE_SMOOTH
    )
