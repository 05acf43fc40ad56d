"""Training loop (counterpart of ``pmpu_tpu/train/loop.py``: ``split_indices``
:75, ``train_net`` :83, ``_model_config`` :403, the epoch loop :466) on one
device or on the ranks of a ``torch.distributed`` world (one process a
card, ``parallel.init_distributed``).

Per epoch: a train phase over the shuffled (scan, view, slice) rows and a
validation phase with the validation loss and per-class Dice, TensorBoard
scalars and one image triplet, the plateau scheduler stepped on the
validation loss (probunet) or Dice (1 class), and a checkpoint every
``checkpoint_every`` epochs; ``{net}_model.pt`` at the end. SIGTERM and
Ctrl-C write ``INTERRUPTED.pth`` (in the working directory) and re-raise
``KeyboardInterrupt``.

Data (:92-181), one of:
* the 3 standard views on the device as (3,N,S,S,S) view stacks (every
  batch one launch of the gather-normalize kernel; so is
  ``--pallas-sampler``), or as the plain (N,S,S,S) stack
  (``--no-view-stacks``);
* k oblique views (``--num-views k`` ≠ 3) as (k,N,S,S,S) view stacks
  precomputed by the oblique-plane kernel (one launch a scan) and gathered
  by the gather kernel, or sampled trilinearly every step from the plain
  stack (``--no-view-stacks``);
* ``--stream`` (3 views): batches gathered on the host and copied to the
  device by ``data/pipeline.py::PrefetchPipeline``, on a bf16 image wire
  under ``--bf16`` without ``--augment`` and a uint8 mask wire when every
  label is in [0, 256).
In a world of several ranks (JAX :129-149, :215-235), every rank reads the
whole store, draws the same split and epoch order, and uploads what it needs:
* ``--sharded-volumes`` (3 views, no ``--stream``, no accumulation, the
  batch divisible by the ranks): its contiguous block of the volumes as the
  plain stack; ``parallel.hostdata.ShardedTripleBatcher`` gives each rank
  its rows (scan ids local to its block) and ``make_hostlocal_dp_train_step``
  averages the gradients, BatchNorm statistics and losses; validation
  weighs each rank by its real rows (``make_hostlocal_eval_step``). Each
  rank's generator is seeded by ``(seed, rank)`` (``rank_seed``);
* ``--data-parallel`` (not with ``--stream``, as in JAX): the whole
  stacks; every step takes the global rows and each rank runs its share of
  each microbatch (``make_dp_train_step``: the one-device step's result);
  the validation round's steps are split over the ranks in blocks, each
  step the one-device eval step on its global rows, and the ranks' sums are
  all-reduced, so every rank makes the same plateau decision.
Rank 0 alone writes checkpoints, TensorBoard and the progress bars; the
others wait at a barrier after each checkpoint. SIGINT and SIGTERM set a
flag that the step's all-reduce carries to every rank (the validation
round reads it once, at its end), so all ranks stop after the same step.
On one rank ``--data-parallel`` runs the one-device step, as in JAX.

The host sends only (scan, view, slice) rows. The numpy parts are the JAX
package's: ``np.random.default_rng(cfg.seed)`` gives the same train/val
split and the same epoch order. The posterior and augmentation draws come
from one ``torch.Generator`` on the device seeded by ``cfg.seed`` (JAX
draws from its key: the draws differ, by design).

Each step's loss is fetched after the next step is dispatched, so the
host does not wait on the card between steps; the validation round
dispatches all its steps before fetching any. ``--nan-checks`` turns on
``utils/profiling.py::enable_nan_checks`` for the epoch loop (JAX :85-86
turns on ``jax_debug_nans``): a NaN raises ``FloatingPointError`` at the
first module that outputs one. With ``--rss-limit-mb`` an
epoch that ends above that host RSS writes ``{net}_rss_resume.pt`` and
raises :class:`RssLimitExceeded`, on which the train CLI re-executes itself
for the remaining epochs. In a world the ranks decide together (each
rank's flag summed over the ranks: any rank over the limit stops them all
at the same epoch), rank 0 writes the checkpoint, and after a barrier every
rank raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from pmpu_tpu_torch.config import Config
from pmpu_tpu_torch.data.augment import AugmentConfig
from pmpu_tpu_torch.data.index_map import build_index_map, build_index_map_from_table
from pmpu_tpu_torch.data.pipeline import PrefetchPipeline
from pmpu_tpu_torch.data.sampler import (
    fibonacci_views,
    make_oblique_sampler,
    make_oblique_view_stacks,
    oblique_nonempty_table,
    sample_batch,
    sample_batch_vt,
    sample_rows,
    view_basis,
)
from pmpu_tpu_torch.data.volumes import VolumeStore, make_view_stacks
from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.parallel.hostdata import ShardedTripleBatcher
from pmpu_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated, world
from pmpu_tpu_torch.parallel.sharding import (
    make_dp_train_step,
    make_hostlocal_dp_train_step,
    make_hostlocal_eval_step,
    rank_seed,
    sum_values,
)
from pmpu_tpu_torch.train import checkpoint as ckpt
from pmpu_tpu_torch.train.schedule import ReduceLROnPlateau
from pmpu_tpu_torch.train.steps import create_train_state, make_eval_step, make_train_step
from pmpu_tpu_torch.train.tasks import make_task
from pmpu_tpu_torch.utils.colorize import mask_to_image
from pmpu_tpu_torch.utils.profiling import StepTimer, enable_nan_checks, rss_mb, trace
from pmpu_tpu_torch.utils.tblog import MetricWriter

log = logging.getLogger(__name__)

def check_ported(cfg: Config):
    """Raise, naming every flag of ``cfg`` that asks for a training path the
    port does not have: ``--async-checkpoints`` (Orbax directories, which
    only orbax, a jax package, reads and writes)."""
    if cfg.async_checkpoints:
        raise NotImplementedError(
            "not in pmpu_tpu_torch's training (Orbax checkpoints are not ported): "
            "--async-checkpoints")


class RssLimitExceeded(Exception):
    """Raised at an epoch boundary when the host RSS is above
    ``--rss-limit-mb``, after a resume checkpoint was written (JAX :45). It
    carries what the train CLI needs to re-execute itself with ``-f
    checkpoint_path`` and the remaining epochs."""

    def __init__(self, checkpoint_path: str, epochs_done: int, rss_mb: float):
        self.checkpoint_path = checkpoint_path
        self.epochs_done = epochs_done
        self.rss_mb = rss_mb
        super().__init__(
            f"host RSS {rss_mb:.0f} MB over limit after epoch {epochs_done}; "
            f"resume checkpoint at {checkpoint_path}"
        )


def split_indices(n: int, val_percent: float, rng: np.random.Generator):
    """A uniformly shuffled split: (train rows, the n·val_percent val rows)."""
    n_val = int(n * val_percent)
    perm = rng.permutation(n)
    return perm[n_val:], perm[:n_val]


def acc_steps_for(batchsize: int) -> int:
    """Gradient accumulation of the reference: 4 microbatches iff batch > 4."""
    return 4 if batchsize > 4 else 1


def train_net(cfg: Config, store: VolumeStore, interrupt_flag=None, device=None):
    """Run training; returns (state, task, history dict). In a world of
    several ranks (``parallel.init_distributed``) every rank calls it with
    the whole store."""
    device = resolve_device(device)
    rank, n_ranks = world()
    check_ported(cfg)
    task = make_task(cfg.net, **cfg.task_kwargs(), device=device, seed=cfg.seed, train=True)
    n_classes = task.n_classes
    if cfg.sharded_volumes and cfg.num_views != 3:
        raise ValueError("--sharded-volumes requires the 3 standard views")
    data_parallel = cfg.data_parallel and not cfg.sharded_volumes and n_ranks > 1

    rng = np.random.default_rng(cfg.seed)
    stream_pipe = mesh = None
    if cfg.num_views != 3:
        bases = np.stack([view_basis(a) for a in fibonacci_views(cfg.num_views)])
        if cfg.view_stacks:
            images_d, labels_d, table = make_oblique_view_stacks(store.images, store.labels,
                                                                 bases, device=device)
            sampler = sample_batch_vt
            log.info("oblique view stacks: %d views x %d scans precomputed (%.2f GB)",
                     cfg.num_views, len(store), 8 * images_d.numel() / 1e9)
        else:
            images_d, labels_d = _upload(store.images, device), _upload(store.labels, device)
            table = oblique_nonempty_table(labels_d, bases)
            sampler = make_oblique_sampler(bases)
        index = build_index_map_from_table(table, filter=cfg.slice_filter)
        if cfg.stream:
            log.warning("--stream requires the 3 standard views; using the device-resident "
                        "oblique path")
    elif cfg.sharded_volumes:
        # each rank holds its contiguous block of the volumes and gathers
        # from it alone (plain stack, sample_batch, as the JAX shard_map body)
        if cfg.stream:
            raise ValueError("--sharded-volumes and --stream are mutually exclusive")
        mesh = make_mesh()
        n_shards = mesh.data
        if len(store) % n_shards:
            raise ValueError(f"{len(store)} volumes not divisible by {n_shards} ranks "
                             "(--sharded-volumes needs equal shards)")
        index = build_index_map(store.labels, filter=cfg.slice_filter)
        vols = len(store) // n_shards
        block = slice(rank * vols, (rank + 1) * vols)
        images_d = _upload(store.images[block], device)
        labels_d = _upload(store.labels[block], device)
    elif cfg.stream:
        if cfg.data_parallel:
            raise ValueError("--stream is not supported with --data-parallel yet")
        index = build_index_map(store.labels, filter=cfg.slice_filter)
        images_d = labels_d = None
        sampler = sample_rows
        # bf16 images only under bf16 compute without augmentation (the
        # first conv casts to bf16 either way; augmentation runs in f32
        # before it); uint8 masks only for labels in [0, 256) (a negative
        # label would wrap)
        compact_img = cfg.bf16 and not cfg.augment
        compact_mask = store.labels.min() >= 0 and store.labels.max() < 256
        stream_pipe = PrefetchPipeline(
            store, image_dtype=torch.bfloat16 if compact_img else torch.float32,
            mask_dtype=torch.uint8 if compact_mask else torch.int32, device=device)
        log.info("streaming data path: host gather + prefetched uploads")
    elif cfg.view_stacks:
        index = build_index_map(store.labels, filter=cfg.slice_filter)
        images_d = _upload(make_view_stacks(store.images), device)
        labels_d = _upload(make_view_stacks(store.labels), device)
        sampler = sample_batch_vt  # --pallas-sampler too: the same kernel
    else:
        index = build_index_map(store.labels, filter=cfg.slice_filter)
        images_d, labels_d = _upload(store.images, device), _upload(store.labels, device)
        sampler = sample_batch
    if cfg.train_views is not None:
        keep = np.isin(index[:, 1], np.asarray(cfg.train_views))
        index = index[keep]
        log.info("restricted to views %s: %d slices", cfg.train_views, len(index))
    train_idx, val_idx = split_indices(len(index), cfg.val / 100.0, rng)

    # a sharded volume pool spreads the batch over the ranks, not over
    # microbatches
    acc_steps = 1 if cfg.sharded_volumes else acc_steps_for(cfg.batchsize)
    micro = max(cfg.batchsize // acc_steps, 1)
    per_step = micro * acc_steps

    # --sharded-volumes: each rank draws from its own generator
    seed = rank_seed(cfg.seed, rank) if cfg.sharded_volumes else cfg.seed
    state = create_train_state(task, seed=seed, momentum=cfg.om, lr=cfg.lr)
    plateau = ReduceLROnPlateau(
        lr=cfg.lr, mode="min" if n_classes > 1 else "max", factor=cfg.lrf, patience=cfg.lrp,
    )
    if cfg.load:
        payload = ckpt.restore_train_state(cfg.load, state)
        log.info("restored checkpoint %s (step %d)", cfg.load, state.step)
        if payload.get("plateau"):
            plateau = ReduceLROnPlateau.from_state_dict(payload["plateau"])
            log.info("restored plateau scheduler (lr=%g)", plateau.lr)
        if cfg.sharded_volumes and rank:
            # the file holds rank 0's generator: the others go on from
            # their own seed and the restored step
            state.generator.manual_seed(rank_seed(cfg.seed, rank, state.step))
    if n_ranks > 1:
        replicated(task.net)
    aug = AugmentConfig(elastic_alpha=cfg.elastic_alpha) if cfg.augment else None
    sv = None
    if cfg.sharded_volumes:
        train_step = make_hostlocal_dp_train_step(task, mesh, acc_steps=acc_steps, augment=aug,
                                                  remat=cfg.remat)
        eval_step = make_hostlocal_eval_step(task, mesh)
        if per_step % n_shards:
            raise ValueError(f"--sharded-volumes: batch {per_step} not divisible by {n_shards} "
                             "shards; pick a multiple of the shard count.")
        per_shard = per_step // n_shards
        train_bat = ShardedTripleBatcher(index[train_idx], len(store), n_shards)
        if train_bat.steps_per_epoch(per_shard) == 0:
            raise ValueError(
                f"--sharded-volumes: smallest shard has "
                f"{min(len(r) for r in train_bat.shard_rows)} training rows < per-shard batch "
                f"{per_shard}; use a smaller batch, fewer shards, or --include-empty-slices.")
        val_bat = (ShardedTripleBatcher(index[val_idx], len(store), n_shards, pad=True)
                   if len(val_idx) else None)
        sv = (train_bat, val_bat, per_shard)
        log.info("sharded volume pool: %d volumes over %d ranks", len(store), n_shards)
    elif data_parallel:
        mesh = make_mesh()
        train_step = make_dp_train_step(task, mesh, acc_steps=acc_steps, sampler=sampler,
                                        augment=aug, remat=cfg.remat)
        eval_step = make_eval_step(task, sampler=sampler)
        log.info("data parallel over %d ranks", mesh.data)
    else:
        train_step = make_train_step(task, acc_steps=acc_steps, sampler=sampler, augment=aug,
                                     remat=cfg.remat)
        eval_step = make_eval_step(task, sampler=sampler)
    lead = rank == 0  # writes the checkpoints, TensorBoard and the progress bars
    writer = MetricWriter(
        logdir=cfg.logdir,
        comment=f"LRF_{cfg.lrf}_LRP_{cfg.lrp}_EP_{cfg.epochs}_LR_{cfg.lr}_BS_{cfg.batchsize}",
        enable_tb=lead and (cfg.logdir is not None or cfg.save_cp),
    )
    history = {"train_loss": [], "val_loss": [], "val_dice": [], "step_time": []}
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    model_extra = {"model_config": _model_config(cfg, task)}

    def save(path, wait=True):
        """Rank 0 writes; with ``wait`` the other ranks wait for it."""
        if lead:
            ckpt.save_checkpoint(path, state, plateau, extra=model_extra)
        if wait and n_ranks > 1:
            dist.barrier()

    # SIGTERM (preemption) sets a flag that the step loops poll, so the
    # INTERRUPTED.pth save sees a state between two steps; in a world SIGINT
    # does too, and the flag goes to every rank in the step's all-reduce, so
    # that all stop after the same step. A handler can be installed on the
    # main thread only.
    sig_hit = {"v": False}
    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT) if n_ranks > 1 else (signal.SIGTERM,):
        try:
            prev[sig] = signal.signal(sig, lambda num, _: sig_hit.__setitem__("v", num))
        except ValueError:
            pass
    user_flag = interrupt_flag
    # logged once the handler holds SIGTERM: from here a SIGTERM saves
    # INTERRUPTED.pth (a soak waits for this line before it sends one)
    log.info(
        "Starting training: epochs=%d batch=%d (%d x %d) lr=%g train=%d val=%d device=%s "
        "rank %d of %d",
        cfg.epochs, cfg.batchsize, acc_steps, micro, cfg.lr, len(train_idx), len(val_idx),
        device, rank, n_ranks,
    )

    def interrupted():
        return bool(sig_hit["v"]) or bool(user_flag and user_flag())

    if sv is not None:
        n_chips = n_shards
    elif data_parallel:
        n_chips = n_ranks
    else:
        n_chips = 1
    ctx = trace(cfg.profile_dir) if cfg.profile_dir else contextlib.nullcontext()
    if cfg.nan_checks:
        enable_nan_checks()
    reexec = False
    try:
        with ctx:
            _epoch_loop(cfg, task, state, train_step, eval_step, plateau, writer, images_d,
                        labels_d, index, train_idx, val_idx, rng, per_step, history,
                        interrupted, save, device, stream_pipe, sv, n_chips)
    except KeyboardInterrupt:
        save("INTERRUPTED.pth")
        log.info("Saved interrupt%s", " (signal)" if sig_hit["v"] else "")
        raise
    except RssLimitExceeded:
        reexec = True
        writer.close()  # flush before the CLI re-executes the process
        raise
    finally:
        if cfg.nan_checks:
            enable_nan_checks(False)
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        if reexec and sig_hit["v"]:
            # caught after the loop's last check, with the resume checkpoint
            # on disk: the signal ends the process, as it does outside the loop
            signal.raise_signal(sig_hit["v"])

    if cfg.save_cp:
        path = os.path.join(cfg.checkpoint_dir, f"{task.name}_model.pt")
        save(path)
        log.info("Saved model %s", path)
    writer.close()
    return state, task, history


def _model_config(cfg: Config, task) -> dict:
    """Model hyperparameters saved with every checkpoint, so that the
    inference CLIs of either package rebuild the architecture."""
    d = {
        "net": cfg.net,
        "n_channels": cfg.n_channels,
        "n_classes": task.n_classes,
        "num_filters": list(cfg.num_filters),
    }
    if cfg.net == "probunet":
        d.update(latent_dim=cfg.latent_dim, no_convs_fcomb=cfg.no_convs_fcomb, beta=cfg.beta)
    return d


class _LineBar:
    """Progress without tqdm: one stdout line when the bar closes."""

    def __init__(self, total, desc):
        self.total, self.desc, self.n, self.postfix = total, desc, 0, ""

    def update(self, n):
        self.n += n

    def set_postfix(self, **kw):
        self.postfix = " ".join(f"{k}={v}" for k, v in kw.items())

    def close(self):
        print(f"{self.desc}: {self.n}/{self.total} img {self.postfix}".rstrip(), flush=True)


class _NullBar:
    def update(self, n):
        pass

    def set_postfix(self, **kw):
        pass

    def close(self):
        pass


def _pbar(total, desc, show=True):
    """A tqdm bar (off when stderr is not a terminal), or :class:`_LineBar`
    where tqdm is not installed; nothing unless ``show``."""
    if not show:
        return _NullBar()
    try:
        from tqdm import tqdm
    except ImportError:
        return _LineBar(total, desc)
    return tqdm(total=total, desc=desc, unit="img", disable=not sys.stderr.isatty(), leave=False)


def _upload(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _rows(index, sel, device):
    return _upload(index[sel], device)


def _stream_rows(n, device) -> torch.Tensor:
    """(n, 3) rows 0..n-1 for ``sample_rows``: row i of a streamed batch."""
    return torch.arange(n, device=device)[:, None].expand(n, 3)


def _epoch_loop(cfg, task, state, train_step, eval_step, plateau, writer, images_d, labels_d,
                index, train_idx, val_idx, rng, per_step, history, interrupted, save, device,
                stream_pipe=None, sv=None, n_chips=1):
    n_classes = task.n_classes
    rank, n_ranks = world()
    lead = rank == 0
    timer = StepTimer(slices_per_step=per_step, n_chips=n_chips)
    autosave_t = time.monotonic()
    global_step = 0
    for epoch in range(cfg.epochs):
        # ---------------- train phase ----------------
        order = rng.permutation(len(train_idx))
        n_steps = len(order) // per_step
        epoch_losses = []
        pbar = _pbar(len(train_idx), f"Epoch {epoch + 1}/{cfg.epochs}", lead)
        pending = []  # (global step, metrics) dispatched, not fetched
        stop = [False]  # a rank was interrupted (a world: from the step's all-reduce)

        def drain():
            gs, m = pending.pop(0)
            loss = float(m["loss"])  # waits for that step only
            stop[0] = stop[0] or float(m.get("stop", 0.0)) > 0
            epoch_losses.append(loss)
            writer.scalar("Loss/train", loss, gs)
            pbar.update(per_step)
            pbar.set_postfix(loss=f"{loss:.4f}")

        if sv is not None:
            train_bat, _, per_shard = sv
            mine = slice(rank * per_shard, (rank + 1) * per_shard)
            batches = ((images_d, labels_d, _upload(t[mine], device))
                       for t in train_bat.epoch_batches(per_shard, rng))
        elif stream_pipe is None:
            sels = [train_idx[order[i * per_step:(i + 1) * per_step]] for i in range(n_steps)]
            batches = ((images_d, labels_d, _rows(index, sel, device)) for sel in sels)
        else:
            sels = [train_idx[order[i * per_step:(i + 1) * per_step]] for i in range(n_steps)]
            rows = _stream_rows(per_step, device)
            batches = ((imgs, lbls, rows) for imgs, lbls in
                       stream_pipe.iterate([index[sel] for sel in sels]))
        for images, labels, triples in batches:
            if n_ranks == 1 and interrupted():
                stop[0] = True
            if stop[0]:
                batches.close()  # stops a stream's producer
                raise KeyboardInterrupt
            timer.start()
            state, metrics = train_step(state, images, labels, triples, plateau.lr,
                                        stop=n_ranks > 1 and interrupted())
            pending.append((global_step, metrics))
            while len(pending) > 1:
                drain()
            timer.stop()
            if cfg.autosave_minutes and time.monotonic() - autosave_t >= cfg.autosave_minutes * 60:
                path = os.path.join(cfg.checkpoint_dir, f"{task.name}_autosave.pt")
                save(path, wait=False)  # each rank's own clock: no barrier
                autosave_t = time.monotonic()
                log.info("autosave %s (step %d)", path, global_step)
            global_step += 1
        while pending:
            drain()
        if stop[0]:
            raise KeyboardInterrupt
        pbar.close()
        history["train_loss"].append(float(np.mean(epoch_losses)) if epoch_losses
                                     else float("nan"))
        history["perf"] = timer.summary()
        history["step_time"].append(timer.sec_per_step)
        if timer.summary()["steps_timed"]:
            writer.scalar("perf/slices_per_sec_per_chip", timer.slices_per_sec, global_step)

        # ---------------- validation phase ----------------
        # in a world the interrupt flag is read once, after the round (every
        # rank at the same point)
        def check_interrupt():
            if n_ranks == 1 and interrupted():
                raise KeyboardInterrupt

        if sv is not None:
            _, val_bat, per_shard = sv
            val_rows = ([t[mine] for t in val_bat.epoch_batches(per_shard,
                                                                 np.random.default_rng(0))]
                        if val_bat is not None else [])
            weight = val_bat.shard_real_rows[rank] if val_bat is not None else 0.0
            val_batches = ((images_d, labels_d, _upload(t, device), weight) for t in val_rows)
            n_val = len(val_rows)
        else:
            val_steps = max(len(val_idx) // per_step, 1) if len(val_idx) else 0
            val_sels = [s for s in (val_idx[i * per_step:(i + 1) * per_step]
                                    for i in range(val_steps)) if len(s)]
            n_val = len(val_sels)
            if n_ranks > 1:
                # --data-parallel: each rank runs its block of the whole steps
                # (each step the one-device eval step on its global rows)
                val_sels = val_sels[data_sharding(make_mesh(), n_val, rank)]
            if stream_pipe is None:
                val_batches = ((images_d, labels_d, _rows(index, sel, device))
                               for sel in val_sels)
            else:
                val_batches = ((imgs, lbls, _stream_rows(len(imgs), device)) for imgs, lbls in
                               stream_pipe.iterate([index[sel] for sel in val_sels]))
        vbar = _pbar(n_val * per_step, "Validation round", lead)
        val_pending, first_images = [], None
        for args in val_batches:
            if n_ranks == 1 and interrupted():
                val_batches.close()
                raise KeyboardInterrupt
            vloss, dice, preds, img, msk = eval_step(state, *args)
            val_pending.append((vloss, dice))
            if first_images is None:  # one image triplet a validation round
                first_images = (preds, img, msk, global_step)
            vbar.update(per_step)
        global_step += n_val
        if first_images is not None and lead:
            preds, img, msk, img_step = (t.cpu().numpy() if torch.is_tensor(t) else t
                                         for t in first_images)
            writer.images("images", img, img_step)
            writer.images("masks/true", mask_to_image(msk, n_classes), img_step)
            writer.images("masks/pred", mask_to_image(preds, n_classes, prediction=True),
                          img_step)
        loss_sum, dice_sum = 0.0, np.zeros(max(n_classes - 1, 1))
        for vloss, dice in val_pending:
            loss_sum += float(vloss)
            dice_sum += dice.cpu().numpy()
        vbar.close()
        if n_ranks > 1 and sv is None:
            # the ranks' sums of their steps, equal on every rank, so are the
            # plateau decisions
            loss_sum, *rest = sum_values([loss_sum, *dice_sum])
            dice_sum = np.asarray(rest)

        if n_val:
            avg_loss = loss_sum / n_val
            avg_dice = dice_sum / n_val
            writer.scalar("Loss/validation", avg_loss, global_step)
            writer.scalar("learning_rate", plateau.lr, global_step)
            for c in range(n_classes - 1):
                writer.scalar(f"dice/class_{c + 1}", avg_dice[c], global_step)
            if n_classes == 1:
                val_score = float(avg_dice[0])
                writer.scalar("metrics/dice", val_score, global_step)
                log.info("Validation Dice Coeff: %s", val_score)
            else:
                val_score = avg_loss
            plateau.step(val_score)
            history["val_loss"].append(avg_loss)
            history["val_dice"].append(avg_dice.tolist())

        gepoch = epoch + cfg.epoch_offset
        if cfg.save_cp and (epoch + 1) % max(cfg.checkpoint_every, 1) == 0:
            path = os.path.join(cfg.checkpoint_dir, f"{task.name}_checkpoint{gepoch}.pt")
            save(path)
            log.info("Saved model %s", path)
        log.info(
            "epoch %d/%d done (%.4fs/step median, %.1f slices/s/chip; train loss %r, val loss "
            "%r; rank %d of %d)", gepoch + 1, cfg.epochs + cfg.epoch_offset, timer.sec_per_step,
            timer.slices_per_sec, float(history["train_loss"][-1]),
            float(history["val_loss"][-1]) if n_val else None, rank, n_ranks,
        )
        if sum_values([interrupted()])[0]:  # any rank's flag stops every rank
            raise KeyboardInterrupt

        if cfg.rss_limit_mb and epoch + 1 < cfg.epochs:
            # each rank's RSS differs: the ranks decide together, so that
            # none re-executes alone and leaves the others in a collective
            rss = rss_mb()
            if sum_values([rss > cfg.rss_limit_mb])[0]:
                # the epoch boundary is the resume point: the re-executed
                # process restores state, momentum, generator and plateau
                # from this checkpoint and runs the remaining epochs
                path = os.path.join(cfg.checkpoint_dir, f"{task.name}_rss_resume.pt")
                save(path)  # rank 0 writes, then a barrier
                if sum_values([interrupted()])[0]:  # a signal during the save
                    raise KeyboardInterrupt
                log.warning("rss %.0f MB (rank %d) against --rss-limit-mb %.0f after epoch %d; "
                            "resume checkpoint %s", rss, rank, cfg.rss_limit_mb, epoch + 1, path)
                raise RssLimitExceeded(path, epoch + 1, rss)
