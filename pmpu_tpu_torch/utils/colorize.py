"""Mask → RGB colorizer for TensorBoard image logging (the port's copy of
``pmpu_tpu/utils/colorize.py:19``): one table lookup; background black,
class 1 blue, class 2 green, class 3 red, as in the reference."""

from __future__ import annotations

import numpy as np

COLORS = np.array(
    [[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]],
    dtype=np.float32,
)


def mask_to_image(masks: np.ndarray, n_classes: int, prediction: bool = False) -> np.ndarray:
    """(N,H,W[,C]) masks or logits → (N,H,W,3) RGB float images.

    prediction=True: argmax over the class axis first (multi-class) or
    threshold 0.5 (binary)."""
    masks = np.asarray(masks)
    if n_classes == 1:
        img = (masks >= 0.5).astype(np.float32) if prediction else masks.astype(np.float32)
        if img.ndim == 3:
            img = img[..., None]
        return np.repeat(img, 3, axis=-1)
    if prediction:
        idx = np.argmax(masks, axis=-1)
    else:
        idx = masks[..., 0] if masks.ndim == 4 else masks
        idx = idx.astype(np.int64)
    idx = np.clip(idx, 0, len(COLORS) - 1)
    return COLORS[idx]
