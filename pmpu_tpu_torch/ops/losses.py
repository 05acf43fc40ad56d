"""Losses: soft Dice, CE/BCE, the U-Net loss and the ELBO (counterpart of
``pmpu_tpu/ops/losses.py``), with the JAX package's semantics:

* ``cross_entropy`` clamps labels to [0, C−1] and selects the label's
  log-probability by a one-hot contraction, as JAX does; torch's
  ``F.cross_entropy`` would raise on such labels instead.
* ``elbo_loss``: CE **summed** over batch and pixels plus β times the
  **mean** KL over the batch.
* ``unet_loss``: mean CE on logits for n_classes > 1 (weight-normalized
  with ``class_weights``), mean BCE on sigmoid probs for n_classes == 1.

Image tensors are NHWC; integer masks are (N,H,W) or (N,H,W,1).

``share`` (None: the batch is all here), a ``parallel.sharding.BatchShare``:
the batch is split over the ranks of a data-parallel step, and each loss
returns this rank's additive share of the global batch's loss (a mean over
the batch is the local mean times the rank's fraction of the rows; ``Σw``
and Dice's sums are all-reduced, with gradients).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pmpu_tpu_torch.models.distributions import DiagGaussian, kl_divergence

DICE_SMOOTH = 1e-6


def dice_coeff(pred: torch.Tensor, target: torch.Tensor, smooth: float = DICE_SMOOTH,
               share=None):
    """Global soft Dice coefficient over everything, in f32 (with ``share``
    over every rank's rows: the same value on each)."""
    p = pred.reshape(-1).float()
    t = target.reshape(-1).float()
    inter = torch.sum(p * t)
    if share is None:
        return (2.0 * inter + smooth) / (torch.sum(p) + torch.sum(t) + smooth)
    inter, sp, st = share.total(torch.stack([inter, torch.sum(p), torch.sum(t)])).unbind()
    return (2.0 * inter + smooth) / (sp + st + smooth)


def soft_dice_loss(pred, target, smooth: float = DICE_SMOOTH, share=None):
    loss = 1.0 - dice_coeff(pred, target, smooth, share)
    return loss if share is None else share.whole(loss)


def _mean(x: torch.Tensor, share) -> torch.Tensor:
    return torch.mean(x) if share is None else share.mean(x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, class_weights=None) -> torch.Tensor:
    """Per-pixel CE of NHWC logits against integer labels (N,H,W); a label
    outside [0, C−1] counts as the nearest class. With ``class_weights``
    each pixel's CE is scaled by its (clamped) label's weight."""
    logp = F.log_softmax(logits, dim=-1)
    c = logits.shape[-1]
    oh = F.one_hot(labels.long().clamp(0, c - 1), c).to(logp.dtype)
    ce = -torch.sum(logp * oh, dim=-1)
    if class_weights is not None:
        w_tab = torch.as_tensor(class_weights, dtype=ce.dtype, device=ce.device)
        ce = ce * torch.sum(oh * w_tab, dim=-1)
    return ce


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element binary CE on logits (the stable form)."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def bce(probs: torch.Tensor, targets: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-element binary CE on probabilities clipped to [eps, 1 − eps]."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p))


def _squeeze_mask(masks):
    return masks[..., 0] if masks.dim() == 4 else masks


def unet_loss(preds: torch.Tensor, masks: torch.Tensor, n_classes: int,
              class_weights=None, share=None) -> torch.Tensor:
    """The deterministic trainer's loss: ``preds`` are logits for
    n_classes > 1, sigmoid probs for n_classes == 1."""
    masks = _squeeze_mask(masks)
    if n_classes > 1:
        ce = cross_entropy(preds, masks, class_weights)
        if class_weights is not None:
            # the raw label's weight, indexed as JAX indexes: a negative
            # label counts from the end, then the index is clamped
            w_tab = torch.as_tensor(class_weights, dtype=ce.dtype, device=ce.device)
            k = len(w_tab)
            idx = masks.long()
            w = w_tab[torch.where(idx < 0, idx + k, idx).clamp(0, k - 1)]
            w_sum = torch.sum(w) if share is None else share.total(torch.sum(w))
            return torch.sum(ce) / w_sum
        return _mean(ce, share)
    return _mean(bce(preds[..., 0], masks.to(preds.dtype)), share)


def elbo_loss(logits: torch.Tensor, masks: torch.Tensor, posterior: DiagGaussian,
              prior: DiagGaussian, beta: float, n_classes: int, class_weights=None,
              share=None):
    """−ELBO = Σ CE(reconstruction, mask) + β · mean KL(q‖p) →
    (loss, {"reconstruction_loss", "kl"})."""
    masks = _squeeze_mask(masks)
    if n_classes == 1:
        rec = torch.sum(bce_with_logits(logits[..., 0], masks.to(logits.dtype)))
    else:
        rec = torch.sum(cross_entropy(logits, masks, class_weights))
    kl = _mean(kl_divergence(posterior, prior), share)
    loss = rec + beta * kl
    return loss, {"reconstruction_loss": rec, "kl": kl}
