"""Whole-volume multi-view inference (counterpart of
``pmpu_tpu/inference/engine.py:47-115, 117-301, 388-592, 844-879``).

One volume's path:

  volume (host) → upload (f32 / bf16 / uint8 wire, pinned) → view slab:
  3 view transposes → (3S,S,S), or with ``num_views != 3`` all planes of
  the isotropic oblique views in one oblique-plane kernel launch →
  (V·S,S,S) → per-slice max normalization (gather-normalize kernel) →
  chunked batched model (U-Net backbone and prior run once per chunk;
  probunet averages n prior draws through the fcomb mean-decode kernel) →
  softmax → back to the voxel grid (inverse transposes, or a trilinear
  resample per oblique view) → mean fusion → argmax (2-bit packed to the
  host) and per-class Dice

The slice axis is a batch axis. PyTorch runs eagerly, so the chunk loop is
a Python loop; chunk ``i`` draws its prior samples from a generator seeded
from ``(seed, i)``, the counterpart of ``fold_in(key, i)``. The draws differ
from JAX's: parity with the JAX package is held with ``mean_z=True``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np
import torch

from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.models import quantized as qz
from pmpu_tpu_torch.inference.fusion import (
    fuse_mean,
    make_view_bases,
    normalize_slabs,
    oblique_slabs,
    reassemble_views,
    resample_view_to_grid,
    view_slabs,
)
from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode
from pmpu_tpu_torch.ops.metrics import generalized_energy_distance, volume_per_class_dice


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
    """Batched whole-volume evaluator for one task.

    Args:
      task: ``UNetTask`` | ``ProbUNetTask`` (``pmpu_tpu_torch.train.tasks``),
            its network already on ``device``
      n_samples: prior draws per slice for the probabilistic model
      eval_batch: slices per model call; 0 = auto, < 0 = the whole slab
      num_views: 3 = the standard views (the reference's path); else that
              many isotropic oblique views (golden-spiral axes), sampled by
              the oblique-plane kernel and resampled back trilinearly
      mean_z: decode the prior mean instead of sampling (deterministic; the
              parity mode; all draws collapse to one decode)
      input_dtype: host → device wire: None (bf16 when the model computes
              in bf16, else f32), "float32", "bfloat16" or "uint8". "uint8"
              ships 8-bit fixed point scaled by the per-volume max; the
              per-slice max normalization cancels the scale. A volume with
              signed or non-finite voxels ships bf16 instead.
      quantize: None | "int8" — post-training int8 inference
              (``pmpu_tpu_torch.models.quantized``): BN-folded int8 convs of
              the U-Net and the prior tower on the conv-chain kernel; the
              transposed convs, heads and the fcomb stay in the compute dtype
      calibration: JSON file of the int8 static scales (the JAX package's
              format): loaded if it exists, else written (atomically) after
              self-calibration on the first volume; an unreadable file is
              recalibrated and replaced. Only meaningful with "int8".
      device: None means "cuda"; raises without a CUDA device unless "cpu"
    """

    def __init__(
        self,
        task,
        n_samples: int = 5,
        eval_batch: int = 0,
        num_views: int = 3,
        mean_z: bool = False,
        input_dtype: Optional[str] = None,
        quantize: Optional[str] = None,
        calibration: Optional[str] = None,
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
        if num_views < 1:
            raise ValueError(f"num_views must be at least 1, got {num_views}")
        self.num_views = num_views
        self._bases = None if num_views == 3 else torch.from_numpy(
            make_view_bases(num_views)).to(self.device)
        if input_dtype is None:
            input_dtype = "bfloat16" if task.net.dtype == torch.bfloat16 else "float32"
        if input_dtype not in ("float32", "bfloat16", "uint8"):
            raise ValueError("input_dtype must be 'float32', 'bfloat16' or 'uint8', "
                             f"got {input_dtype!r}")
        self.input_dtype = input_dtype
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        self.quantize = quantize
        self.calibration = calibration
        self._cal_rewrite = False  # an unreadable file needs replacing
        self._qvars = None         # the int8 tree, cached by the weights' identity
        self._qvars_src = None
        self._qvars_calibrated = False
        self._pack_classes = max(task.n_classes, 2) <= 4
        self._ged_evaluators = {}  # n_ged_samples → per-sample evaluator

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
    def _weights_identity(self):
        """Identity of the network's weights: storage and version counter of
        every tensor (a reload copies in place and bumps the version)."""
        return tuple((t.data_ptr(), t._version) for t in self.task.net.state_dict().values())

    def _maybe_quantize(self, sample_vol=None):
        """The int8 eval tree (counterpart of JAX ``engine.py:305-386``):
        quantized once per set of weights; its static scales loaded from
        ``calibration`` when that file exists and is readable, else baked
        from ``sample_vol``'s normalized slices (48 spread across the views)
        and written to ``calibration`` atomically (tmp + rename)."""
        net = self.task.net
        ident = self._weights_identity()
        if self._qvars_src != ident:
            if self.task.is_probabilistic:
                self._qvars = qz.quantize_probunet(net)
            else:
                self._qvars = qz.quantize_unet(net)
            self._qvars_src = ident
            self._qvars_calibrated = False
            if self.calibration and os.path.exists(self.calibration):
                try:
                    with open(self.calibration) as f:
                        d = json.load(f)
                except (json.JSONDecodeError, OSError) as e:
                    logging.warning("calibration file %s unreadable (%s); recalibrating",
                                    self.calibration, e)
                    self._cal_rewrite = True
                else:  # an architecture mismatch raises: the file is another model's
                    qz.import_scales(self._qvars, d, net.num_filters,
                                     self.task.is_probabilistic)
                    self._qvars_calibrated = True
        if sample_vol is not None and not self._qvars_calibrated:
            self._self_calibrate(sample_vol)
        return self._qvars

    def _self_calibrate(self, sample_vol):
        """Bake the static scales from the 3 standard views' slices, whatever
        ``num_views`` is (as the JAX package does)."""
        net = self.task.net
        cd = net.dtype or torch.float32
        v = sample_vol if isinstance(sample_vol, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(sample_vol, np.float32)))
        slabs = normalize_slabs(view_slabs(v.to(self.device, torch.float32)))
        n = min(48, slabs.shape[0])  # spread across views and positions
        idx = torch.linspace(0, slabs.shape[0] - 1, n).long().to(self.device)
        x = slabs[idx][..., None]
        if self.task.is_probabilistic:
            qz.calibrate_probunet(self._qvars, x, net, dtype=cd)
        else:
            qz.calibrate_unet(self._qvars, x, net.num_filters, self.task.n_classes, dtype=cd)
        self._qvars_calibrated = True
        if self.calibration and (self._cal_rewrite or not os.path.exists(self.calibration)):
            # a kill mid-write or a concurrent reader never sees a torn file
            tmp = self.calibration + ".tmp"
            with open(tmp, "w") as f:
                json.dump(qz.export_scales(self._qvars, net.num_filters,
                                           self.task.is_probabilistic), f)
            os.replace(tmp, self.calibration)
            self._cal_rewrite = False
            logging.info("saved int8 calibration scales to %s", self.calibration)

    def _model_logits(self, x, generator=None, per_sample: bool = False):
        """(N,H,W,1) slices → (N,H,W,C) f32 logits, or (n_samples,N,H,W,C)
        with ``per_sample``. The backbone and the prior run once; only the
        fcomb decode is per sample. The mean path is the fcomb mean-decode
        kernel (its plain version on the CPU). With ``quantize="int8"`` the
        backbone and the prior run int8-resident on the conv-chain kernel."""
        net = self.task.net
        cd = net.dtype or torch.float32
        if not self.task.is_probabilistic:
            if self.quantize:
                out = qz.unet_int8(self._qvars, x, net.num_filters, self.task.n_classes,
                                   dtype=cd)
            else:
                out = net(x)
            return out[None] if per_sample else out
        if self.quantize:
            feats, loc, scale = qz.probunet_features_prior_int8(self._qvars, x, net, dtype=cd)
        else:
            out = net(x)
            feats, loc, scale = out.unet_features, out.prior.loc, out.prior.scale
        if self.mean_z:
            zs = loc[None]
        else:
            eps = torch.randn((self.n_samples,) + tuple(loc.shape), generator=generator,
                              device=loc.device, dtype=loc.dtype)
            zs = loc[None] + scale[None] * eps  # (n_samples, N, latent)
        if per_sample:
            return net.decode_samples(feats, zs)
        return fcomb_mean_decode(feats, zs, net.fcomb_params(), net.no_convs_fcomb, net.dtype)

    def _chunked_logits(self, slabs: torch.Tensor, seed: int,
                        per_sample: bool = False) -> torch.Tensor:
        """(total,H,W) slab → (total,H,W,C) logits, or (n_samples,total,H,W,C)
        with ``per_sample``."""
        total, h, w = slabs.shape
        b, nchunk = eval_chunk_plan(total, h, w, self.eval_batch)
        pad = nchunk * b - total
        if pad:
            slabs = torch.cat([slabs, slabs.new_zeros((pad, h, w))])
        x = slabs[..., None]
        sampled = self.task.is_probabilistic and not self.mean_z
        ax = 1 if per_sample else 0  # the slice axis of the logits
        logits = None
        for i in range(nchunk):
            gen = chunk_generator(self.device, seed, i) if sampled else None
            li = self._model_logits(x[i * b : (i + 1) * b], gen, per_sample)
            if logits is None:
                shape = list(li.shape)
                shape[ax] = nchunk * b
                logits = li.new_empty(shape)
            logits.narrow(ax, i * b, b).copy_(li)
        return logits.narrow(ax, 0, total)

    def _to_probs(self, outputs: torch.Tensor) -> torch.Tensor:
        """Multi-class: softmax. Binary: the UNet already emits sigmoid
        probs; the probunet's linear head emits logits, squashed here.
        Either way expanded to [bg, fg]."""
        if self.task.n_classes == 1:
            p = torch.sigmoid(outputs) if self.task.is_probabilistic else outputs
            return torch.cat([1.0 - p, p], dim=-1)
        return torch.softmax(outputs, dim=-1)

    def _predict_volume(self, vol: torch.Tensor, seed: int = 0, per_sample: bool = False):
        """(S,S,S) image volume on the device → the per-view class volumes
        and their mean fusion, each (S,S,S,C) f32. With ``per_sample`` each
        carries a leading n_samples axis: one fused volume per prior draw
        from one model pass (the GED path)."""
        vol = vol.float()
        slabs = view_slabs(vol) if self._bases is None else oblique_slabs(vol, self._bases)
        probs = self._to_probs(self._chunked_logits(normalize_slabs(slabs), seed, per_sample))
        if self._bases is None:
            views = reassemble_views(probs)
        else:
            s = vol.shape[0]
            views = []
            for i, basis in enumerate(self._bases):
                pv = probs[..., i * s : (i + 1) * s, :, :, :]
                if per_sample:
                    views.append(torch.stack([resample_view_to_grid(p, basis) for p in pv]))
                else:
                    views.append(resample_view_to_grid(pv, basis))
        return tuple(views) + (fuse_mean(views),)

    def _dice_report(self, volumes, truth) -> torch.Tensor:
        """Per-class (1..C-1) Dice of each view volume and the fusion:
        (num_views+1, C-1)."""
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
        num_views per-view volumes) when ``return_views``, and 'dice' (host
        (num_views+1, C-1)) when a truth volume is given."""
        if self.quantize:
            self._maybe_quantize(sample_vol=img_vol)
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

    @torch.inference_mode()
    def ged_volume(self, img_vol, truth_vol, n_ged_samples: int = 4, seed: int = 0) -> float:
        """Generalized energy distance between ``n_ged_samples`` whole-volume
        segmentations and the one truth volume. Each sample is the argmax of
        the fused views decoded from its own prior draw; all draws share one
        model pass (the backbone and the prior run once per chunk, only the
        fcomb decode fans out). The draws come from an evaluator kept per
        ``n_ged_samples`` with this one's ``num_views``, ``eval_batch`` and
        ``quantize``; ``n_samples`` of this evaluator is left as it was."""
        ev = self._ged_evaluators.get(n_ged_samples)
        if ev is None:
            ev = self if n_ged_samples == self.n_samples else VolumeEvaluator(
                self.task, n_samples=n_ged_samples, eval_batch=self.eval_batch,
                num_views=self.num_views, quantize=self.quantize, device=self.device)
            self._ged_evaluators[n_ged_samples] = ev
        if self.quantize:
            ev._qvars = self._maybe_quantize()
        if isinstance(img_vol, torch.Tensor):
            vol = img_vol.to(self.device, torch.float32)
        else:
            vol = self._to_device(np.ascontiguousarray(img_vol, dtype=np.float32))
        samples = torch.argmax(ev._predict_volume(vol, seed, per_sample=True)[-1], dim=-1)
        truths = torch.as_tensor(truth_vol, device=self.device)[None]
        n_classes = max(self.task.n_classes, 2)
        return float(generalized_energy_distance(samples, truths, n_classes))
