"""Whole-volume 3-view inference (counterpart of
``pmpu_tpu/inference/engine.py:47-115, 117-301, 388-592``).

One volume's path:

  volume (host) → upload (f32 / bf16 / uint8 wire, pinned) → 3 view
  transposes → (3S,S,S) slab → per-slice max normalization (gather-
  normalize kernel) → chunked batched model (U-Net backbone and prior run
  once per chunk; probunet averages n prior draws through the fcomb
  mean-decode kernel) → softmax → inverse-transpose reassembly → mean
  fusion → argmax (2-bit packed to the host) and per-class Dice

The slice axis is a batch axis. PyTorch runs eagerly, so the chunk loop is
a Python loop; chunk ``i`` draws its prior samples from a generator seeded
from ``(seed, i)``, the counterpart of ``fold_in(key, i)``. The draws differ
from JAX's: parity with the JAX package is held with ``mean_z=True``.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.inference.fusion import (
    fuse_mean,
    normalize_slabs,
    reassemble_views,
    view_slabs,
)
from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode
from pmpu_tpu_torch.ops.metrics import volume_per_class_dice


def auto_eval_batch(total: int, h: int, w: int) -> int:
    """Auto chunk size: ~128 slices' worth of 128² activations, scaled by
    slice area, preferring divisors of the slab (no padded slices)."""
    s2 = h * w
    target = min(total, max(32, (128 * 128 * 128) // max(s2, 1)))
    b = max((d for d in range(1, target + 1) if total % d == 0), default=target)
    if b < target // 2:  # awkward totals: padding beats tiny chunks
        return target
    return b


def eval_chunk_plan(total: int, h: int, w: int, eval_batch: int):
    """(chunk_size, n_chunks) for a ``total``-slice slab; ``eval_batch`` 0 =
    auto, < 0 = the whole slab."""
    if eval_batch == 0:
        b = auto_eval_batch(total, h, w)
    elif eval_batch < 0:
        b = total
    else:
        b = eval_batch
    return b, -(-total // b)


def _pack2bit(a: torch.Tensor) -> torch.Tensor:
    """(..., S) uint8 class ids < 4 → (..., S//4), 4 voxels per byte (voxel
    j of each group at bits 2j..2j+1)."""
    a4 = a.reshape(a.shape[:-1] + (a.shape[-1] // 4, 4))
    return a4[..., 0] | (a4[..., 1] << 2) | (a4[..., 2] << 4) | (a4[..., 3] << 6)


def _unpack2bit(p: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`_pack2bit`."""
    bits = (p[..., None] >> np.asarray([0, 2, 4, 6], np.uint8)) & np.uint8(3)
    return bits.reshape(p.shape[:-1] + (p.shape[-1] * 4,))


def chunk_generator(device: torch.device, seed: int, i: int) -> torch.Generator:
    """The generator of chunk ``i``'s prior draws, seeded from (seed, i)."""
    state = np.random.SeedSequence([seed, i]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


class VolumeEvaluator:
    """Batched whole-volume evaluator for one task (3 standard views).

    Args:
      task: ``UNetTask`` | ``ProbUNetTask`` (``pmpu_tpu_torch.train.tasks``),
            its network already on ``device``
      n_samples: prior draws per slice for the probabilistic model
      eval_batch: slices per model call; 0 = auto, < 0 = the whole 3S slab
      mean_z: decode the prior mean instead of sampling (deterministic; the
              parity mode; all draws collapse to one decode)
      input_dtype: host → device wire: None (bf16 when the model computes
              in bf16, else f32), "float32", "bfloat16" or "uint8". "uint8"
              ships 8-bit fixed point scaled by the per-volume max; the
              per-slice max normalization cancels the scale. A volume with
              signed or non-finite voxels ships bf16 instead.
      device: None means "cuda"; raises without a CUDA device unless "cpu"
    """

    def __init__(
        self,
        task,
        n_samples: int = 5,
        eval_batch: int = 0,
        mean_z: bool = False,
        input_dtype: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        net_device = next(task.net.parameters()).device
        if net_device.type != self.device.type:
            raise ValueError(f"task network is on {net_device}, evaluator on {self.device}")
        self.task = task
        self.n_samples = 1 if mean_z else n_samples
        self.mean_z = mean_z
        self.eval_batch = eval_batch
        if input_dtype is None:
            input_dtype = "bfloat16" if task.net.dtype == torch.bfloat16 else "float32"
        if input_dtype not in ("float32", "bfloat16", "uint8"):
            raise ValueError("input_dtype must be 'float32', 'bfloat16' or 'uint8', "
                             f"got {input_dtype!r}")
        self.input_dtype = input_dtype
        self._pack_classes = max(task.n_classes, 2) <= 4

    # ------------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _upload(self, vol) -> torch.Tensor:
        """Host → device image upload in the wire dtype. A tensor already on
        the device passes through. uint8 quantizes against the per-volume
        max (last three axes)."""
        if isinstance(vol, torch.Tensor):
            if vol.device.type == self.device.type:
                return vol
            vol = vol.numpy()
        arr = np.asarray(vol)
        if self.input_dtype == "uint8":
            if arr.dtype == np.uint8:
                return self._to_device(arr)
            a = arr.astype(np.float32, copy=False)
            # signs cannot ride the scale-cancelling wire, and NaN/inf would
            # zero the scaled volume: the whole upload ships bf16 instead
            if a.min() < 0 or not np.isfinite(a).all():
                logging.warning("uint8 wire: signed or non-finite voxels; shipping bf16")
                return self._to_device(torch.from_numpy(a).to(torch.bfloat16))
            m = a.max(axis=tuple(range(a.ndim - 3, a.ndim)), keepdims=True)
            q = a * np.divide(255.0, m, out=np.zeros_like(m), where=m > 0)
            return self._to_device(np.rint(q).astype(np.uint8))
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.input_dtype == "bfloat16":
            return self._to_device(t.to(torch.bfloat16))
        return self._to_device(t.to(torch.float32))

    def _upload_truth(self, truth) -> torch.Tensor:
        """Truth labels ship as uint8 when the class ids fit."""
        if isinstance(truth, torch.Tensor) and truth.device.type == self.device.type:
            return truth
        arr = np.asarray(truth)
        if arr.dtype != np.uint8 and self.task.n_classes < 256:
            arr = arr.astype(np.uint8)
        return self._to_device(np.ascontiguousarray(arr))

    # ------------------------------------------------------------------
    def _model_logits(self, x, generator=None, per_sample: bool = False):
        """(N,H,W,1) slices → (N,H,W,C) f32 logits, or (n_samples,N,H,W,C)
        with ``per_sample``. The backbone and the prior run once; only the
        fcomb decode is per sample. The mean path is the fcomb mean-decode
        kernel (its plain version on the CPU)."""
        net = self.task.net
        if not self.task.is_probabilistic:
            out = net(x)
            return out[None] if per_sample else out
        out = net(x)
        loc = out.prior.loc
        if self.mean_z:
            zs = loc[None]
        else:
            eps = torch.randn((self.n_samples,) + tuple(loc.shape), generator=generator,
                              device=loc.device, dtype=loc.dtype)
            zs = loc[None] + out.prior.scale[None] * eps  # (n_samples, N, latent)
        if per_sample:
            return net.decode_samples(out.unet_features, zs)
        return fcomb_mean_decode(out.unet_features, zs, net.fcomb_params(),
                                 net.no_convs_fcomb, net.dtype)

    def _chunked_logits(self, slabs: torch.Tensor, seed: int) -> torch.Tensor:
        total, h, w = slabs.shape
        b, nchunk = eval_chunk_plan(total, h, w, self.eval_batch)
        pad = nchunk * b - total
        if pad:
            slabs = torch.cat([slabs, slabs.new_zeros((pad, h, w))])
        x = slabs[..., None]
        sampled = self.task.is_probabilistic and not self.mean_z
        logits = None
        for i in range(nchunk):
            gen = chunk_generator(self.device, seed, i) if sampled else None
            li = self._model_logits(x[i * b : (i + 1) * b], gen)
            if logits is None:
                logits = li.new_empty((nchunk * b,) + tuple(li.shape[1:]))
            logits[i * b : (i + 1) * b] = li
        return logits[:total]

    def _to_probs(self, outputs: torch.Tensor) -> torch.Tensor:
        """Multi-class: softmax. Binary: the UNet already emits sigmoid
        probs; the probunet's linear head emits logits, squashed here.
        Either way expanded to [bg, fg]."""
        if self.task.n_classes == 1:
            p = torch.sigmoid(outputs) if self.task.is_probabilistic else outputs
            return torch.cat([1.0 - p, p], dim=-1)
        return torch.softmax(outputs, dim=-1)

    def _predict_volume(self, vol: torch.Tensor, seed: int = 0):
        """(S,S,S) image volume on the device → three per-view class volumes
        and their mean fusion, each (S,S,S,C) f32."""
        slabs = normalize_slabs(view_slabs(vol.float()))
        probs = self._to_probs(self._chunked_logits(slabs, seed))
        views = reassemble_views(probs)
        return tuple(views) + (fuse_mean(views),)

    def _dice_report(self, volumes, truth) -> torch.Tensor:
        """Per-class (1..C-1) Dice of each view volume and the fusion:
        (4, C-1)."""
        n_classes = volumes[0].shape[-1]
        return torch.stack([
            torch.stack([volume_per_class_dice(v, truth, c) for c in range(1, n_classes)])
            for v in volumes
        ])

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def evaluate_volume(self, img_vol, truth_vol=None, seed: int = 0,
                        return_views: bool = True) -> dict:
        """Run one volume. Returns 'fused' probs (device tensor), 'argmax'
        (host f32, fetched 2-bit packed when the classes fit), 'views' (the
        three per-view volumes) when ``return_views``, and 'dice' (host
        (4, C-1)) when a truth volume is given."""
        outs = self._predict_volume(self._upload(img_vol), seed)
        fused = outs[-1]
        seg = torch.argmax(fused, dim=-1).to(torch.uint8)
        if self._pack_classes and fused.shape[2] % 4 == 0:
            argmax = _unpack2bit(_pack2bit(seg).cpu().numpy())
        else:
            argmax = seg.cpu().numpy()
        result = {"fused": fused, "argmax": argmax.astype(np.float32)}
        if return_views:
            result["views"] = outs[:-1]
        if truth_vol is not None:
            result["dice"] = self._dice_report(outs, self._upload_truth(truth_vol)).cpu().numpy()
        return result
