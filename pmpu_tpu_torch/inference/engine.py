"""Whole-volume multi-view inference (counterpart of
``pmpu_tpu/inference/engine.py``, all but the XLA-specific parts:
``_compile_batched`` and ``batched_hbm_xla``).

One volume's path:

  volume (host) → upload (f32 / bf16 / uint8 wire, pinned) → view slab:
  3 view transposes → (3S,S,S), or with ``num_views != 3`` all planes of
  the isotropic oblique views in one oblique-plane kernel launch →
  (V·S,S,S) → per-slice max normalization (gather-normalize kernel) →
  chunked batched model (U-Net backbone and prior run once per chunk;
  probunet averages n prior draws through the fcomb mean-decode kernel;
  the hpunet runs its encoder once per chunk and decodes the n draws'
  multi-scale latents and stitching decoder in one batched pass) →
  softmax → back to the voxel grid (inverse transposes, or a trilinear
  resample per oblique view) → mean fusion → argmax (2-bit packed to the
  host) and per-class Dice

The slice axis is a batch axis. PyTorch runs eagerly, so the chunk loop is
a Python loop; chunk ``i`` draws its prior samples from a generator seeded
from ``(seed, i)``, the counterpart of ``fold_in(key, i)``. The draws differ
from JAX's: parity with the JAX package is held with ``mean_z=True``.

A volume is dispatched (``_dispatch_volume``: every launch enqueued, the
host never waits) and then fetched (``_fetch_seg``, ``_fetch_entropy``).
The outputs the host reads (the packed argmax, Dice, the uint16 entropy)
are copied on a side CUDA stream, behind an event of the compute stream,
into pinned host buffers that a pool reuses; the fetch waits on the copy's
event. ``predict_volumes_pipelined`` and ``evaluate_store`` dispatch
volume i+1 before they fetch volume i, so the host work of one volume (the
upload's quantization, the fetches, the exports) runs while the card
computes another.

The host side carries ``torch.profiler`` spans (``record_function``, a few
microseconds each when no profiler runs) on the trace's clock, so that a
trace names what the host did while the card idled: ``dispatch`` (all of a dispatch) holds
``upload`` (``encode``: the host's conversion to the wire dtype; ``stage``:
the pinned copy and the asynchronous host-to-device copy), the model's
spans and ``outputs`` (the argmax, Dice and the starts of the copies to the
host); a fetch is ``fetch_wait`` (the wait on the copies' event) then
``unpack`` (the conversion to host f32); ``pool_alloc`` marks each new
buffer of the host pool.

``evaluate_volumes_batched`` runs V volumes together: chunk i of every
volume goes through the model in one call (V·b slices), so it holds V× the
activations of one volume for the same number of launches.
``evaluate_store_batched`` groups a store that way, behind a memory guard
(``batched_hbm_estimate`` against ``device_hbm_limit``) and an
out-of-memory backstop on the first group; either falls back to
``evaluate_store``.

Slice-parallel evaluation (``mesh``, JAX :184 and :458-466): with a
``parallel.Mesh`` of the default process group's ranks (one process each)
of ``data > 1``, every rank builds the whole view slab, normalizes only
the planes of its data index's contiguous block of the chunk plan's chunks
(split as ``parallel.data_sharding`` splits rows: a block may be empty),
runs the model on those chunks, chunk i drawing from
``chunk_generator(seed, i)`` as in one process, and the logits are
all-gathered in f32 (``parallel.gather_blocks``) before the softmax and
the fusion, which every rank then computes alike: the results are one
process's bit for bit. On a ``data × model`` mesh every model index of a
data row runs its row's chunks with the whole weights (as XLA runs a
``pallas_call``, whose operands it cannot partition, on the slab sharded
over ``data`` and replicated over ``model``), and the gather runs over the
rank's data column, which holds one copy of each block. Rank 0 alone
writes files (exports, the int8 scale file). Every rank must call the same
entry points in the same order.
"""

from __future__ import annotations

import json
import logging
import os
import warnings
from collections import deque
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.data.volumes import restore_geometry
from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.models import quantized as qz
from pmpu_tpu_torch.inference.fusion import (
    fuse_mean,
    make_view_bases,
    normalize_slab_planes,
    normalize_slabs,
    oblique_slabs,
    reassemble_views,
    resample_view_to_grid,
    view_slabs,
)
from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode
from pmpu_tpu_torch.ops.metrics import generalized_energy_distance, volume_per_class_dice
from pmpu_tpu_torch.parallel.gather import gather_blocks, is_lead
from pmpu_tpu_torch.parallel.mesh import data_sharding, world


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


# full-resolution activations of a chunk that ``batched_hbm_estimate``
# counts at its peak; fitted on the card (see its docstring)
BATCHED_ACTIVATION_COEF = 7.15


def device_hbm_limit(device=None) -> Optional[int]:
    """Device memory budget in bytes for the batched path's guard:
    ``PMPU_HBM_BYTES`` overrides (a malformed value warns and is ignored);
    else the CUDA device's total memory; None on the CPU (no guard)."""
    env = os.environ.get("PMPU_HBM_BYTES")
    if env:
        try:
            return int(float(env))  # accepts "15e9" too
        except ValueError:
            warnings.warn(f"ignoring malformed PMPU_HBM_BYTES={env!r}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(dev)[1])


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A contiguous host tensor of ``a``; a read-only array (a memmap store)
    is copied, since torch tensors are writable."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _pack2bit(a: torch.Tensor) -> torch.Tensor:
    """(..., S) uint8 class ids < 4 → (..., S//4), 4 voxels per byte (voxel
    j of each group at bits 2j..2j+1)."""
    a4 = a.reshape(a.shape[:-1] + (a.shape[-1] // 4, 4))
    return a4[..., 0] | (a4[..., 1] << 2) | (a4[..., 2] << 4) | (a4[..., 3] << 6)


def _unpack2bit(p: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`_pack2bit`."""
    bits = (p[..., None] >> np.asarray([0, 2, 4, 6], np.uint8)) & np.uint8(3)
    return bits.reshape(p.shape[:-1] + (p.shape[-1] * 4,))


def derive_seed(seed: int, i: int) -> int:
    """A 63-bit seed derived from (seed, i), the counterpart of
    ``fold_in(key, i)``: chunk ``i`` of a volume and volume ``i`` of a
    stream take theirs from it."""
    state = np.random.SeedSequence([seed, i]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def chunk_generator(device: torch.device, seed: int, i: int) -> torch.Generator:
    """The generator of chunk ``i``'s prior draws, seeded from (seed, i)."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, i))
    return g


class HostPool:
    """Host buffers of the transfers, reused, keyed by (shape, dtype):
    pinned for a CUDA evaluator, so that each copy is asynchronous and no
    buffer is freed on the path (freeing pinned memory synchronizes the
    device). A buffer taken is the caller's until it is given back, with
    the event after which it may be written again; ``take`` returns the
    first free buffer whose event has completed, else allocates one. A
    stream of depth d settles at d + 1 buffers of each key."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.allocated = {}  # (shape, dtype) → buffers made
        self._free = {}      # (shape, dtype) → [(buffer, event or None)]

    def take(self, shape, dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        free = self._free.setdefault(key, [])
        for j, (buf, ready) in enumerate(free):
            if ready is None or ready.query():
                del free[j]
                return buf
        self.allocated[key] = self.allocated.get(key, 0) + 1
        # a normal tensor: writable in and out of the mode
        with record_function("pool_alloc"), torch.inference_mode(False):
            return torch.empty(key[0], dtype=dtype, pin_memory=self.pinned)

    def give(self, buf: torch.Tensor, ready=None) -> None:
        self._free.setdefault((tuple(buf.shape), buf.dtype), []).append((buf, ready))


def _refuse(task, path: str, what: str) -> None:
    """Raise where ``task.lacks`` names the evaluator path ``path``."""
    why = getattr(task, "lacks", {}).get(path)
    if why:
        raise ValueError(f"{what} has no {task.name} path: {why}")


class VolumeEvaluator:
    """Batched whole-volume evaluator for one task.

    Args:
      task: ``UNetTask`` | ``ProbUNetTask`` | ``HPUNetTask``
            (``pmpu_tpu_torch.train.tasks``), its network already on
            ``device``; a task with ``model_logits`` decodes its own draws,
            and the evaluator paths named in a task's ``lacks`` raise
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
      source_geometry: NIfTI exports of a store cropped to the source shape
              with the source affine (``store.geoms``); False exports the
              padded cube with the identity affine (the reference's exports)
      device: None means "cuda"; raises without a CUDA device unless "cpu"
      mesh: a ``parallel.Mesh`` of the default process group's ranks; with
              ``data > 1`` each data index runs its block of every slab's
              chunks (each model index of it alike, with the whole
              weights) and the logits are all-gathered (slice-parallel
              evaluation); None or ``data == 1``: this process runs every
              chunk
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
        source_geometry: bool = True,
        device=None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        if quantize:
            _refuse(task, "int8", f"quantize={quantize!r}")
        if mesh is not None and mesh.size > 1:
            _refuse(task, "mesh", f"a mesh of {mesh.size} ranks")
        if mesh is not None and mesh.size > 1 and mesh.size != world()[1]:
            raise ValueError(f"the mesh spans {mesh.size} ranks, the world has {world()[1]}")
        self.mesh = mesh
        self._split_shapes = set()  # the slab shapes whose chunk block was logged
        net_device = next(task.net.parameters()).device
        if net_device.type != self.device.type:
            raise ValueError(f"task network is on {net_device}, evaluator on {self.device}")
        self.task = task
        self.n_samples = 1 if mean_z else n_samples
        self.mean_z = mean_z
        self.source_geometry = source_geometry
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
        n_classes = max(task.n_classes, 2)
        self._pack_classes = n_classes <= 4
        # entropy ∈ [0, ln C] fetched as uint16 fixed point (1.7e-5 at C=3)
        self._entropy_scale = float(np.log(n_classes))
        self._ged_evaluators = {}  # n_ged_samples → per-sample evaluator
        cuda = self.device.type == "cuda"
        self._pool = HostPool(pinned=cuda)
        self._side = torch.cuda.Stream(self.device) if cuda else None  # D2H copies

    # ------------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        """Host → device through a pooled pinned buffer, asynchronous; the
        buffer is free again once the copy has run. CPU: passes through."""
        t = _from_numpy(x) if isinstance(x, np.ndarray) else x
        if self.device.type != "cuda":
            return t
        buf = self._pool.take(t.shape, t.dtype).copy_(t)
        out = buf.to(self.device, non_blocking=True)
        self._pool.give(buf, torch.cuda.current_stream(self.device).record_event())
        return out

    def _upload(self, vol) -> torch.Tensor:
        """Host → device image upload in the wire dtype: ``_encode`` (span
        ``encode``), then ``_to_device`` (span ``stage``). A tensor already
        on the device passes through."""
        if isinstance(vol, torch.Tensor):
            if vol.device.type == self.device.type:
                return vol
            vol = vol.numpy()
        with record_function("encode"):
            wire = self._encode(np.asarray(vol))
        with record_function("stage"):
            return self._to_device(wire)

    def _encode(self, arr: np.ndarray):
        """``arr`` in the wire dtype, on the host. uint8 quantizes against
        the per-volume max (last three axes)."""
        if self.input_dtype == "uint8":
            if arr.dtype == np.uint8:
                return arr
            a = arr.astype(np.float32, copy=False)
            # signs cannot ride the scale-cancelling wire, and NaN/inf would
            # zero the scaled volume: the whole upload ships bf16 instead
            if a.min() < 0 or not np.isfinite(a).all():
                logging.warning("uint8 wire: signed or non-finite voxels; shipping bf16")
                return torch.from_numpy(a).to(torch.bfloat16)
            m = a.max(axis=tuple(range(a.ndim - 3, a.ndim)), keepdims=True)
            q = a * np.divide(255.0, m, out=np.zeros_like(m), where=m > 0)
            return np.rint(q).astype(np.uint8)
        t = _from_numpy(arr)
        return t.to(torch.bfloat16 if self.input_dtype == "bfloat16" else torch.float32)

    def _upload_truth(self, truth) -> torch.Tensor:
        """Truth labels ship as uint8 when the class ids fit."""
        if isinstance(truth, torch.Tensor) and truth.device.type == self.device.type:
            return truth
        arr = np.asarray(truth)
        if arr.dtype != np.uint8 and self.task.n_classes < 256:
            arr = arr.astype(np.uint8)
        return self._to_device(arr)

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
            found = bool(self.calibration) and os.path.exists(self.calibration)
            if self._split():
                # every rank has looked before rank 0 may write the file
                dist.barrier()
            if found:
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
        if self.calibration and is_lead() and (self._cal_rewrite
                                               or not os.path.exists(self.calibration)):
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
        backbone and the prior run int8-resident on the conv-chain kernel.
        ``generator`` draws the prior noise; a list of V generators draws
        it for V equal runs of slices, one generator each. A task with
        ``model_logits`` (the hpunet's) decodes its draws itself."""
        net = self.task.net
        cd = net.dtype or torch.float32
        if not self.task.is_probabilistic:
            if self.quantize:
                out = qz.unet_int8(self._qvars, x, net.num_filters, self.task.n_classes,
                                   dtype=cd)
            else:
                out = net(x)
            return out[None] if per_sample else out
        decode = getattr(self.task, "model_logits", None)
        if decode is not None:
            return decode(x, generator, self.n_samples, per_sample, self.mean_z)
        if self.quantize:
            feats, loc, scale = qz.probunet_features_prior_int8(self._qvars, x, net, dtype=cd)
        else:
            out = net(x)
            feats, loc, scale = out.unet_features, out.prior.loc, out.prior.scale
        if self.mean_z:
            zs = loc[None]
        else:
            gens = generator if isinstance(generator, list) else [generator]
            n = loc.shape[0] // len(gens)
            draws = [torch.randn((self.n_samples, n, loc.shape[1]), generator=g,
                                 device=loc.device, dtype=loc.dtype) for g in gens]
            eps = draws[0] if len(draws) == 1 else torch.cat(draws, dim=1)
            zs = loc[None] + scale[None] * eps  # (n_samples, N, latent)
        if per_sample:
            return net.decode_samples(feats, zs)
        return fcomb_mean_decode(feats, zs, net.fcomb_params(), net.no_convs_fcomb, net.dtype)

    def _split(self) -> bool:
        """Whether this evaluator splits each slab's chunks over ranks."""
        return self.mesh is not None and self.mesh.data > 1

    def _chunked_logits(self, slabs: torch.Tensor, seed: int,
                        per_sample: bool = False) -> torch.Tensor:
        """(total,H,W) slab, not yet normalized → (total,H,W,C) logits, or
        (n_samples,total,H,W,C) with ``per_sample``."""
        logits = self._group_logits(slabs[None], [seed], per_sample)
        return logits[:, 0] if per_sample else logits[0]

    def _group_logits(self, slabs: torch.Tensor, seeds, per_sample: bool = False):
        """(V,total,H,W) slabs of V volumes, not yet normalized →
        (V,total,H,W,C) logits, or (n_samples,V,total,H,W,C) with
        ``per_sample``. Chunk i of every volume goes through the model in one
        call (V·b slices); volume j draws chunk i's prior noise from
        ``chunk_generator(seeds[j], i)``, as a one-volume evaluation with seed
        ``seeds[j]`` does. Split over ranks, this rank normalizes and runs its
        block of the chunks, and the blocks' logits are all-gathered."""
        v, total, h, w = slabs.shape
        b, nchunk = eval_chunk_plan(total, h, w, self.eval_batch)
        if self._split():
            sizes = [len(range(nchunk)[data_sharding(self.mesh, nchunk, d)])
                     for d in range(self.mesh.data)]
            mine = range(nchunk)[data_sharding(self.mesh, nchunk)]
            if (v, total, h, w) not in self._split_shapes:
                self._split_shapes.add((v, total, h, w))
                logging.info("rank %d of %d: chunks [%d, %d) of %d (%d slices each) of a "
                             "%dx%dx%dx%d slab", self.mesh.data_index, self.mesh.data,
                             mine.start, mine.stop, nchunk, b, v, total, h, w)
        else:
            mine = range(nchunk)
        lo, hi = mine.start * b, min(mine.stop * b, total)
        with record_function("slice_slabs"):
            x = normalize_slab_planes(slabs, lo, hi)
        pad = len(mine) * b - x.shape[1]
        if pad:
            x = torch.cat([x, x.new_zeros((v, pad, h, w))], dim=1)
        sampled = self.task.is_probabilistic and not self.mean_z
        ax = 1 if per_sample else 0  # the volume axis of the logits
        draws = (self.n_samples,) if per_sample else ()
        logits = torch.empty(draws + (v, len(mine) * b, h, w, self.task.n_classes),
                             device=slabs.device)
        for k, i in enumerate(mine):
            gens = [chunk_generator(self.device, s, i) for s in seeds] if sampled else None
            xi = x[:, k * b : (k + 1) * b].reshape(v * b, h, w, 1)
            li = self._model_logits(xi, gens, per_sample).unflatten(ax, (v, b))
            logits.narrow(ax + 1, k * b, b).copy_(li)
        if self._split():  # each block once: over this rank's data column
            logits = gather_blocks(logits, [n * b for n in sizes], dim=ax + 1,
                                   group=self.mesh.data_group)
        return logits.narrow(ax + 1, 0, total)

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
        return self._predict_group(vol[None], [seed], per_sample)[0]

    def _predict_group(self, vols: torch.Tensor, seeds, per_sample: bool = False) -> list:
        """(V,S,S,S) image volumes on the device, through the model together
        (``_group_logits``) → for each volume, what ``_predict_volume`` with
        its seed returns."""
        vols = vols.float()
        v, s = vols.shape[0], vols.shape[-1]
        if self._bases is None:
            with record_function("slice_slabs"):
                slabs = view_slabs(vols)
        else:
            with record_function("oblique_slabs"):
                planes = [oblique_slabs(x, self._bases) for x in vols]
                slabs = planes[0][None] if v == 1 else torch.stack(planes)
        with record_function("model"):
            probs = self._to_probs(self._group_logits(slabs, seeds, per_sample))
        outs = []
        for j in range(v):
            pj = probs[:, j] if per_sample else probs[j]
            if self._bases is None:
                with record_function("reassemble"):
                    views = reassemble_views(pj)
            else:
                views = []
                with record_function("splat_back"):
                    for i, basis in enumerate(self._bases):
                        pv = pj[..., i * s : (i + 1) * s, :, :, :]
                        if per_sample:
                            views.append(torch.stack([resample_view_to_grid(p, basis)
                                                      for p in pv]))
                        else:
                            views.append(resample_view_to_grid(pv, basis))
            with record_function("fuse"):
                fused = fuse_mean(views)
            outs.append(tuple(views) + (fused,))
        return outs

    def _dice_report(self, volumes, truth) -> torch.Tensor:
        """Per-class (1..C-1) Dice of each view volume and the fusion:
        (num_views+1, C-1)."""
        n_classes = volumes[0].shape[-1]
        return torch.stack([
            torch.stack([volume_per_class_dice(v, truth, c) for c in range(1, n_classes)])
            for v in volumes
        ])

    def _entropy(self, p: torch.Tensor) -> torch.Tensor:
        """Predictive entropy of (..., C) probabilities as uint16 fixed
        point: round(clip(-Σ p·log(p + 1e-12), 0, ln C) · 65535 / ln C) in
        f32. The clip comes before the cast: oblique-path boundary voxels
        can sum to < 1, where the entropy may pass ln C and would wrap."""
        ent = -(p * torch.log(p + 1e-12)).sum(-1)
        scale = self._entropy_scale
        return torch.round(ent.clamp(0.0, scale) * (65535.0 / scale)).to(torch.uint16)

    def _copy_to_host(self, outputs: dict) -> dict:
        """Start the copies of ``outputs`` (device tensors) into pooled host
        buffers: on CUDA on the side stream, after an event of the compute
        stream, each source kept from reuse until its copy has run
        (``record_stream``). Returns the buffers and the event of the
        copies' end under ``"copied"`` (None on the CPU)."""
        host = {}
        if self._side is None:
            for name, t in outputs.items():
                host[name] = self._pool.take(t.shape, t.dtype).copy_(t)
            host["copied"] = None
            return host
        self._side.wait_event(torch.cuda.current_stream(self.device).record_event())
        with torch.cuda.stream(self._side):
            for name, t in outputs.items():
                host[name] = self._pool.take(t.shape, t.dtype).copy_(t, non_blocking=True)
                t.record_stream(self._side)
        host["copied"] = self._side.record_event()
        return host

    def _fetch(self, h: dict, name: str, convert) -> np.ndarray:
        """``convert`` (which must return a new array) of the host copy of
        ``h[name]``, once the copies are done; its buffer goes back to the
        pool, so each output is fetched once."""
        buf = h.pop(name)
        with record_function("fetch_wait"):
            if h["copied"] is not None:
                h["copied"].synchronize()
        with record_function("unpack"):
            out = convert(buf.numpy())
        self._pool.give(buf)
        return out

    def _fetch_seg(self, h: dict) -> np.ndarray:
        """The fused argmax as host f32 (the reference's NIfTI export
        dtype), sent 2-bit packed when the classes fit."""
        if "seg_packed" in h:
            return self._fetch(h, "seg_packed", lambda p: _unpack2bit(p).astype(np.float32))
        return self._fetch(h, "argmax_u8", lambda a: a.astype(np.float32))

    def _fetch_entropy(self, h: dict) -> np.ndarray:
        """The uint16 entropy, dequantized to host f32."""
        return self._fetch(h, "entropy",
                           lambda q: q.astype(np.float32) * (self._entropy_scale / 65535.0))

    def _release(self, h: dict) -> None:
        """Give the host buffers of ``h`` that were not fetched back to the
        pool, free once their copy has run."""
        for name in [k for k in h if k != "copied"]:
            self._pool.give(h.pop(name), h["copied"])

    def _device_outputs(self, fused, dice, want_entropy: bool) -> dict:
        """The outputs the host reads of fused volumes (..., S,S,S,C): the
        argmax (2-bit packed when the classes fit), the Dice table when
        given, the uint16 entropy when asked."""
        seg = torch.argmax(fused, dim=-1).to(torch.uint8)
        dev = {}
        if self._pack_classes and fused.shape[-2] % 4 == 0:
            dev["seg_packed"] = _pack2bit(seg)
        else:
            dev["argmax_u8"] = seg
        if dice is not None:
            dev["dice"] = dice
        if want_entropy:
            dev["entropy"] = self._entropy(fused)
        return dev

    @torch.inference_mode()
    def _dispatch_volume(self, img_vol, truth_vol=None, seed: int = 0,
                         want_entropy: bool = False) -> dict:
        """Enqueue one volume: upload, the model, the argmax (2-bit packed
        when the classes fit), Dice with a truth volume, the uint16 entropy
        when asked, and the copies of those to the host. The host does not
        wait for the card (only the first int8 volume does, to calibrate).
        Returns a handle: 'fused' and 'views' (device tensors) and the host
        outputs that ``_fetch_seg``, ``_fetch_entropy`` and ``_fetch`` read."""
        with record_function("dispatch"):
            if self.quantize:
                self._maybe_quantize(sample_vol=img_vol)
            with record_function("upload"):
                vol = self._upload(img_vol)
            outs = self._predict_volume(vol, seed)
            with record_function("outputs"):
                dice = None
                if truth_vol is not None:
                    dice = self._dice_report(outs, self._upload_truth(truth_vol))
                host = self._copy_to_host(self._device_outputs(outs[-1], dice, want_entropy))
        return {"fused": outs[-1], "views": outs[:-1], **host}

    @torch.inference_mode()
    def evaluate_volume(self, img_vol, truth_vol=None, seed: int = 0,
                        return_views: bool = True) -> dict:
        """Run one volume: a dispatch, then its fetches. Returns 'fused'
        probs (device tensor), 'argmax' (host f32), 'views' (the num_views
        per-view volumes) when ``return_views``, and 'dice' (host
        (num_views+1, C-1)) when a truth volume is given."""
        h = self._dispatch_volume(img_vol, truth_vol, seed)
        result = {"fused": h["fused"], "argmax": self._fetch_seg(h)}
        if return_views:
            result["views"] = h["views"]
        if truth_vol is not None:
            result["dice"] = self._fetch(h, "dice", np.copy)
        return result

    @torch.inference_mode()
    def predict_volumes_pipelined(self, volumes, seed: int = 0, pipeline_depth: int = 2,
                                  want_entropy: bool = False) -> list:
        """The serving path: the fused argmax of each volume of a stream (an
        iterable; a generator is read lazily, about ``pipeline_depth``
        volumes held at once) as host f32, or (argmax, entropy) pairs with
        ``want_entropy``. Volume i+1..i+depth are dispatched before volume
        i is fetched; volume i takes the seed ``derive_seed(seed, i)``, so
        every depth gives the bits of depth 0."""
        depth = max(0, pipeline_depth)
        pending = deque()
        results = []

        def drain():
            h = pending.popleft()
            seg = self._fetch_seg(h)
            results.append((seg, self._fetch_entropy(h)) if want_entropy else seg)

        for i, vol in enumerate(volumes):
            h = self._dispatch_volume(vol, seed=derive_seed(seed, i), want_entropy=want_entropy)
            # an in-flight volume keeps only its host copies: its views and
            # fused volume go back to the allocator now
            h.pop("views")
            h.pop("fused")
            pending.append(h)
            while len(pending) > depth:
                drain()
        while pending:
            drain()
        return results

    def _export(self, writer, path: str, arr: np.ndarray, store, i: int) -> None:
        """Queue a NIfTI export of volume ``i`` of ``store``: cropped to the
        source shape with the source affine (``store.geoms``), or the padded
        cube with the identity affine when ``source_geometry`` is off or the
        store has no geometry."""
        geoms = store.geoms
        writer.save(path, *restore_geometry(arr, geoms[i] if geoms else None,
                                            not self.source_geometry))

    def _record(self, report: dict, writer, store, i: int, dice: np.ndarray,
                exports) -> None:
        """Append volume ``i``'s Dice table (num_views+1, C-1) to ``report``
        and queue its exports, ``(directory, host array)`` pairs."""
        for v in range(self.num_views):
            report["per_view"][v].append(dice[v])
        report["fused"].append(dice[-1])
        logging.info("volume %d/%d %s fused dice=%s", i + 1, len(store), store.ids[i],
                     np.round(dice[-1], 4))
        for directory, arr in exports:
            self._export(writer, f"{directory}/{store.ids[i]}", arr, store, i)

    def _new_report(self) -> dict:
        return {"per_view": [[] for _ in range(self.num_views)], "fused": []}

    @staticmethod
    def _stack_report(report: dict) -> dict:
        return {"per_view": [np.stack(v) for v in report["per_view"]],
                "fused": np.stack(report["fused"])}

    def _writes(self, save_dir, uncertainty_dir) -> tuple:
        """The export directories this rank writes to: all of them on rank 0
        (or without ranks), none on the others; '' counts as None."""
        if not is_lead():
            return None, None
        return save_dir or None, uncertainty_dir or None

    @torch.inference_mode()
    def evaluate_store(self, store, seed: int = 0, save_dir: Optional[str] = None,
                       uncertainty_dir: Optional[str] = None, pipeline_depth: int = 2) -> dict:
        """Evaluate every volume of a ``VolumeStore``: the reference's report,
        ``{"per_view": [(N, C-1)] × num_views, "fused": (N, C-1)}`` of
        per-class Dice. ``save_dir`` receives the fused argmax of each volume
        as NIfTI, ``uncertainty_dir`` its predictive entropy (from the same
        fused volume; no second model pass), both written by a background
        thread. Volume i takes the seed ``derive_seed(seed, i)`` and
        volumes i+1..i+``pipeline_depth`` are dispatched before volume i is
        fetched; every depth gives the bits of depth 0. Split over ranks,
        every rank returns the report and rank 0 alone writes the exports."""
        save_dir, uncertainty_dir = self._writes(save_dir, uncertainty_dir)
        report = self._new_report()
        depth = max(0, pipeline_depth)
        pending = deque()
        writer_cm = nifti.AsyncWriter() if (save_dir or uncertainty_dir) else nullcontext()
        with writer_cm as writer:

            def drain():
                i, h = pending.popleft()
                dice = self._fetch(h, "dice", np.copy)
                exports = []
                if save_dir:
                    exports.append((save_dir, self._fetch_seg(h)))
                if uncertainty_dir:
                    exports.append((uncertainty_dir, self._fetch_entropy(h)))
                self._release(h)
                self._record(report, writer, store, i, dice, exports)

            for i in range(len(store)):
                h = self._dispatch_volume(store.images[i], store.labels[i],
                                          derive_seed(seed, i),
                                          want_entropy=uncertainty_dir is not None)
                h.pop("views")  # the fetch reads only the host copies
                h.pop("fused")
                pending.append((i, h))
                while len(pending) > depth:
                    drain()
            while pending:
                drain()
        return self._stack_report(report)

    @torch.inference_mode()
    def _dispatch_group(self, img_vols, truth_vols, seeds, want_entropy: bool = False) -> dict:
        """Enqueue V volumes (V,S,S,S) through the model together, volume j
        with the seed ``seeds[j]``. Returns 'fused' (V,S,S,S,C) on the
        device and the host copies of the argmax, the Dice tables
        (V, num_views+1, C-1) and the entropy, as ``_dispatch_volume``."""
        with record_function("dispatch"):
            if self.quantize:
                self._maybe_quantize(sample_vol=img_vols[0])
            with record_function("upload"):
                vols = self._upload(img_vols)
            outs = self._predict_group(vols, seeds)
            with record_function("outputs"):
                fused = torch.stack([o[-1] for o in outs])
                dice = None
                if truth_vols is not None:
                    truths = self._upload_truth(truth_vols)
                    dice = torch.stack([self._dice_report(o, t) for o, t in zip(outs, truths)])
                host = self._copy_to_host(self._device_outputs(fused, dice, want_entropy))
        return {"fused": fused, **host}

    @torch.inference_mode()
    def evaluate_volumes_batched(self, img_vols, truth_vols=None, seed: int = 0) -> dict:
        """V volumes (V,S,S,S) through the model together (chunk i of all V
        in one model call): V× the activation memory of one volume, the same
        number of launches. Returns 'fused' (V,S,S,S,C) on the device and,
        with truths, 'dice' (V, num_views+1, C-1) on the host. Volume j
        draws the prior noise of ``evaluate_volume`` with the seed
        ``derive_seed(seed, j)``, so the two agree in sampling mode too."""
        seeds = [derive_seed(seed, j) for j in range(len(img_vols))]
        h = self._dispatch_group(img_vols, truth_vols, seeds)
        result = {"fused": h.pop("fused")}
        if truth_vols is not None:
            result["dice"] = self._fetch(h, "dice", np.copy)
        self._release(h)
        return result

    def batched_hbm_estimate(self, s: int, volumes_per_batch: int) -> int:
        """Device bytes that ``evaluate_volumes_batched`` of
        ``volumes_per_batch`` volumes at cube ``s`` allocates at its peak,
        beyond what is resident before it: the guard of
        ``evaluate_store_batched``. The JAX estimate's form: the model's
        activations of one chunk, ``BATCHED_ACTIVATION_COEF`` ×
        chunk·s²·f0·dtype, plus the f32 slab and class volumes. JAX adds 4
        per prior sample for its per-sample decode; the fcomb kernel holds
        no per-sample activation, so here the term does not grow with the
        samples. The coefficient, 7.15, is fitted to
        ``torch.cuda.max_memory_allocated`` above the resident weights at
        V = 1 and V = 2 (1.993 and 4.000 GiB: 7.13 and 7.16; probunet
        64..1024, 128³, 128-slice chunks, 5 samples, bf16) on an NVIDIA H100
        80GB HBM3 at 700 W (``chip_smoke.py`` phase 9). A planning number
        (±30 %), used with headroom; the out-of-memory catch of the first
        group is the backstop."""
        b, _ = eval_chunk_plan(self.num_views * s, s, s, self.eval_batch)
        d = 2 if self.task.net.dtype == torch.bfloat16 else 4
        f0 = self.task.net.num_filters[0]
        c = max(self.task.n_classes, 2)
        per_vol = b * s * s * f0 * d * BATCHED_ACTIVATION_COEF
        per_vol += s**3 * 4 * (3 + 2 * (self.num_views + 1) * c)
        return int(volumes_per_batch * per_vol)

    @torch.inference_mode()
    def evaluate_store_batched(self, store, seed: int = 0, save_dir: Optional[str] = None,
                               uncertainty_dir: Optional[str] = None,
                               volumes_per_batch: int = 2) -> dict:
        """The throughput variant of :meth:`evaluate_store`: groups of
        ``volumes_per_batch`` volumes through the model together, as in
        :meth:`evaluate_volumes_batched`; the same report and exports. Volume
        i takes the seed ``derive_seed(seed, i)`` of :meth:`evaluate_store`,
        so the two agree in sampling mode too (the JAX package folds a key a
        group instead). The last group is padded by repeating its last
        volume.

        It falls back to :meth:`evaluate_store` with a warning when
        :meth:`batched_hbm_estimate` exceeds 0.90 × ``device_hbm_limit``, or
        when the first group runs out of device memory; split over ranks an
        out-of-memory error raises instead (a rank that fell back alone
        would leave the others in a collective). A task whose ``lacks``
        names ``batched_store`` (the hpunet: the estimate is not fitted to
        it) raises."""
        _refuse(self.task, "batched_store", "evaluate_store_batched")
        save_dir, uncertainty_dir = self._writes(save_dir, uncertainty_dir)
        vb = max(1, volumes_per_batch)
        n = len(store)

        def fallback(reason):
            logging.warning("--eval-mode batched: %s; falling back to the sequential "
                            "pipelined evaluator (same report/exports; use a smaller "
                            "--eval-volumes-batch or cube to keep the batched path)", reason)
            return self.evaluate_store(store, seed=seed, save_dir=save_dir,
                                       uncertainty_dir=uncertainty_dir)

        if n:
            s = store.cube
            limit = device_hbm_limit(self.device)
            est = self.batched_hbm_estimate(s, vb)
            if limit is not None and est > 0.90 * limit:
                return fallback(f"estimated activation footprint {est / 2**30:.1f} GiB for "
                                f"{vb} volumes at {s}^3 exceeds the {limit / 2**30:.1f} GiB "
                                "device budget")
        report = self._new_report()
        writer_cm = nifti.AsyncWriter() if (save_dir or uncertainty_dir) else nullcontext()
        with writer_cm as writer:
            for g0 in range(0, n, vb):
                idxs = list(range(g0, min(g0 + vb, n)))
                sel = idxs + [idxs[-1]] * (vb - len(idxs))  # repeat-pad the last group
                imgs = np.stack([store.images[i] for i in sel])
                truths = np.stack([store.labels[i] for i in sel])
                oom = None
                try:
                    h = self._dispatch_group(imgs, truths, [derive_seed(seed, i) for i in sel],
                                             want_entropy=uncertainty_dir is not None)
                    h.pop("fused")
                    dice = self._fetch(h, "dice", np.copy)
                except torch.cuda.OutOfMemoryError as e:
                    # later groups have the first one's shapes: if it fits, they do
                    if g0 or self._split():
                        raise
                    oom = f"out of device memory ({type(e).__name__})"
                if oom:  # outside the handler, so that its frames' tensors are freed
                    torch.cuda.empty_cache()
                    return fallback(oom)
                seg = self._fetch_seg(h) if save_dir else None  # one fetch for the group
                ent = self._fetch_entropy(h) if uncertainty_dir else None
                self._release(h)
                for j, i in enumerate(idxs):
                    exports = []
                    if save_dir:
                        exports.append((save_dir, seg[j]))
                    if uncertainty_dir:
                        exports.append((uncertainty_dir, ent[j]))
                    self._record(report, writer, store, i, dice[j], exports)
        return self._stack_report(report)

    @torch.inference_mode()
    def ged_volume(self, img_vol, truth_vol, n_ged_samples: int = 4, seed: int = 0) -> float:
        """Generalized energy distance between ``n_ged_samples`` whole-volume
        segmentations and the one truth volume. Each sample is the argmax of
        the fused views decoded from its own prior draw; all draws share one
        model pass (the backbone and the prior run once per chunk, only the
        fcomb decode fans out). The draws come from an evaluator kept per
        ``n_ged_samples`` with this one's ``num_views``, ``eval_batch``,
        ``quantize`` and ``mesh``; ``n_samples`` of this evaluator is left as
        it was."""
        ev = self._ged_evaluators.get(n_ged_samples)
        if ev is None:
            ev = self if n_ged_samples == self.n_samples else VolumeEvaluator(
                self.task, n_samples=n_ged_samples, eval_batch=self.eval_batch,
                num_views=self.num_views, quantize=self.quantize, device=self.device,
                mesh=self.mesh)
            self._ged_evaluators[n_ged_samples] = ev
        if self.quantize:
            ev._qvars = self._maybe_quantize()
        if isinstance(img_vol, torch.Tensor):
            vol = img_vol.to(self.device, torch.float32)
        else:
            vol = self._to_device(np.ascontiguousarray(img_vol, dtype=np.float32))
        samples = torch.argmax(ev._predict_volume(vol, seed, per_sample=True)[-1], dim=-1)
        truth = truth_vol if isinstance(truth_vol, torch.Tensor) else _from_numpy(
            np.asarray(truth_vol))
        truths = truth.to(self.device)[None]
        n_classes = max(self.task.n_classes, 2)
        return float(generalized_energy_distance(samples, truths, n_classes))
