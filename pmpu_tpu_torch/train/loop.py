"""Training loop (counterpart of ``pmpu_tpu/train/loop.py``: ``split_indices``
:75, ``train_net`` :83, ``_model_config`` :403, the epoch loop :466) for
the 3 standard views.

Per epoch: a train phase over the shuffled (scan, view, slice) rows and a
validation phase with the validation loss and per-class Dice, TensorBoard
scalars and one image triplet, the plateau scheduler stepped on the
validation loss (probunet) or Dice (1 class), and a checkpoint every
``checkpoint_every`` epochs; ``{net}_model.pt`` at the end. SIGTERM and
Ctrl-C write ``INTERRUPTED.pth`` (in the working directory) and re-raise
``KeyboardInterrupt``.

Data: the volumes live on the device, as the default (3,N,S,S,S) view
stacks (every batch one launch of the gather-normalize kernel; so is
``--pallas-sampler``) or as the plain (N,S,S,S) stack
(``--no-view-stacks``); the host sends only (scan, view, slice) rows.
The numpy parts are the JAX package's: ``np.random.default_rng(cfg.seed)``
gives the same train/val split and the same epoch order. The posterior
draws come from one ``torch.Generator`` on the device seeded by
``cfg.seed`` (JAX draws from its key: the draws differ, by design).

Each step's loss is fetched after the next step is dispatched, so the
host does not wait on the card between steps; the validation round
dispatches all its steps before fetching any.
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

from pmpu_tpu_torch.config import Config
from pmpu_tpu_torch.data.index_map import build_index_map
from pmpu_tpu_torch.data.sampler import sample_batch, sample_batch_vt
from pmpu_tpu_torch.data.volumes import VolumeStore, make_view_stacks
from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.train import checkpoint as ckpt
from pmpu_tpu_torch.train.schedule import ReduceLROnPlateau
from pmpu_tpu_torch.train.steps import create_train_state, make_eval_step, make_train_step
from pmpu_tpu_torch.train.tasks import make_task
from pmpu_tpu_torch.utils.colorize import mask_to_image
from pmpu_tpu_torch.utils.profiling import StepTimer, trace
from pmpu_tpu_torch.utils.tblog import MetricWriter

log = logging.getLogger(__name__)

# Config fields of training paths not ported yet, with their flags
_UNPORTED = (
    ("augment", "--augment"),
    ("stream", "--stream"),
    ("sharded_volumes", "--sharded-volumes"),
    ("remat", "--remat"),
    ("async_checkpoints", "--async-checkpoints"),
    ("rss_limit_mb", "--rss-limit-mb"),
    ("nan_checks", "--nan-checks"),
)


def check_ported(cfg: Config, device: torch.device):
    """Raise, naming every flag of ``cfg`` that asks for a training path the
    port does not have yet (ROADMAP.md, queue 1)."""
    bad = [flag for field, flag in _UNPORTED if getattr(cfg, field)]
    if cfg.num_views != 3:
        bad.append(f"--num-views {cfg.num_views} (oblique training)")
    if cfg.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        bad.append("--data-parallel over more than one device")
    if bad:
        raise NotImplementedError("not ported to pmpu_tpu_torch's training yet: "
                                  + ", ".join(bad))


def split_indices(n: int, val_percent: float, rng: np.random.Generator):
    """A uniformly shuffled split: (train rows, the n·val_percent val rows)."""
    n_val = int(n * val_percent)
    perm = rng.permutation(n)
    return perm[n_val:], perm[:n_val]


def acc_steps_for(batchsize: int) -> int:
    """Gradient accumulation of the reference: 4 microbatches iff batch > 4."""
    return 4 if batchsize > 4 else 1


def train_net(cfg: Config, store: VolumeStore, interrupt_flag=None, device=None):
    """Run training; returns (state, task, history dict)."""
    device = resolve_device(device)
    check_ported(cfg, device)
    task = make_task(cfg.net, **cfg.task_kwargs(), device=device, seed=cfg.seed, train=True)
    n_classes = task.n_classes

    rng = np.random.default_rng(cfg.seed)
    index = build_index_map(store.labels, filter=cfg.slice_filter)
    if cfg.view_stacks:
        images_d = torch.from_numpy(make_view_stacks(store.images)).to(device)
        labels_d = torch.from_numpy(make_view_stacks(store.labels)).to(device)
        sampler = sample_batch_vt  # --pallas-sampler too: the same kernel
    else:
        images_d = torch.from_numpy(np.ascontiguousarray(store.images)).to(device)
        labels_d = torch.from_numpy(np.ascontiguousarray(store.labels)).to(device)
        sampler = sample_batch
    if cfg.train_views is not None:
        keep = np.isin(index[:, 1], np.asarray(cfg.train_views))
        index = index[keep]
        log.info("restricted to views %s: %d slices", cfg.train_views, len(index))
    train_idx, val_idx = split_indices(len(index), cfg.val / 100.0, rng)

    acc_steps = acc_steps_for(cfg.batchsize)
    micro = max(cfg.batchsize // acc_steps, 1)
    per_step = micro * acc_steps

    state = create_train_state(task, seed=cfg.seed, momentum=cfg.om, lr=cfg.lr)
    plateau = ReduceLROnPlateau(
        lr=cfg.lr, mode="min" if n_classes > 1 else "max", factor=cfg.lrf, patience=cfg.lrp,
    )
    if cfg.load:
        payload = ckpt.restore_train_state(cfg.load, state)
        log.info("restored checkpoint %s (step %d)", cfg.load, state.step)
        if payload.get("plateau"):
            plateau = ReduceLROnPlateau.from_state_dict(payload["plateau"])
            log.info("restored plateau scheduler (lr=%g)", plateau.lr)
    train_step = make_train_step(task, acc_steps=acc_steps, sampler=sampler)
    eval_step = make_eval_step(task, sampler=sampler)
    writer = MetricWriter(
        logdir=cfg.logdir,
        comment=f"LRF_{cfg.lrf}_LRP_{cfg.lrp}_EP_{cfg.epochs}_LR_{cfg.lr}_BS_{cfg.batchsize}",
        enable_tb=cfg.logdir is not None or cfg.save_cp,
    )
    log.info(
        "Starting training: epochs=%d batch=%d (%d x %d) lr=%g train=%d val=%d device=%s",
        cfg.epochs, cfg.batchsize, acc_steps, micro, cfg.lr, len(train_idx), len(val_idx),
        device,
    )
    history = {"train_loss": [], "val_loss": [], "val_dice": [], "step_time": []}
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    model_extra = {"model_config": _model_config(cfg, task)}

    # SIGTERM (preemption) sets a flag that the step loops poll, so the
    # INTERRUPTED.pth save sees a state between two steps; a handler can be
    # installed on the main thread only
    sigterm_hit = {"v": False}
    try:
        prev_term = signal.signal(signal.SIGTERM, lambda *_: sigterm_hit.__setitem__("v", True))
    except ValueError:
        prev_term = None
    user_flag = interrupt_flag

    def interrupted():
        return sigterm_hit["v"] or bool(user_flag and user_flag())

    ctx = trace(cfg.profile_dir) if cfg.profile_dir else contextlib.nullcontext()
    try:
        with ctx:
            _epoch_loop(cfg, task, state, train_step, eval_step, plateau, writer, images_d,
                        labels_d, index, train_idx, val_idx, rng, per_step, history,
                        interrupted, model_extra, device)
    except KeyboardInterrupt:
        ckpt.save_checkpoint("INTERRUPTED.pth", state, plateau, extra=model_extra)
        log.info("Saved interrupt%s", " (SIGTERM preemption)" if sigterm_hit["v"] else "")
        raise
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)

    if cfg.save_cp:
        path = os.path.join(cfg.checkpoint_dir, f"{task.name}_model.pt")
        ckpt.save_checkpoint(path, state, plateau, extra=model_extra)
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


def _pbar(total, desc):
    """A tqdm bar (off when stderr is not a terminal), or :class:`_LineBar`
    where tqdm is not installed."""
    try:
        from tqdm import tqdm
    except ImportError:
        return _LineBar(total, desc)
    return tqdm(total=total, desc=desc, unit="img", disable=not sys.stderr.isatty(), leave=False)


def _rows(index, sel, device):
    return torch.from_numpy(np.ascontiguousarray(index[sel])).to(device)


def _epoch_loop(cfg, task, state, train_step, eval_step, plateau, writer, images_d, labels_d,
                index, train_idx, val_idx, rng, per_step, history, interrupted, model_extra,
                device):
    n_classes = task.n_classes
    timer = StepTimer(slices_per_step=per_step)
    autosave_t = time.monotonic()
    global_step = 0
    for epoch in range(cfg.epochs):
        # ---------------- train phase ----------------
        order = rng.permutation(len(train_idx))
        n_steps = len(order) // per_step
        epoch_losses = []
        pbar = _pbar(len(train_idx), f"Epoch {epoch + 1}/{cfg.epochs}")
        pending = []  # (global step, metrics) dispatched, not fetched

        def drain():
            gs, m = pending.pop(0)
            loss = float(m["loss"])  # waits for that step only
            epoch_losses.append(loss)
            writer.scalar("Loss/train", loss, gs)
            pbar.update(per_step)
            pbar.set_postfix(loss=f"{loss:.4f}")

        for i in range(n_steps):
            if interrupted():
                raise KeyboardInterrupt
            triples = _rows(index, train_idx[order[i * per_step:(i + 1) * per_step]], device)
            timer.start()
            state, metrics = train_step(state, images_d, labels_d, triples, plateau.lr)
            pending.append((global_step, metrics))
            while len(pending) > 1:
                drain()
            timer.stop()
            if cfg.autosave_minutes and time.monotonic() - autosave_t >= cfg.autosave_minutes * 60:
                path = os.path.join(cfg.checkpoint_dir, f"{task.name}_autosave.pt")
                ckpt.save_checkpoint(path, state, plateau, extra=model_extra)
                autosave_t = time.monotonic()
                log.info("autosave %s (step %d)", path, global_step)
            global_step += 1
        while pending:
            drain()
        pbar.close()
        history["train_loss"].append(float(np.mean(epoch_losses)) if epoch_losses
                                     else float("nan"))
        history["perf"] = timer.summary()
        history["step_time"].append(timer.sec_per_step)
        if timer.summary()["steps_timed"]:
            writer.scalar("perf/slices_per_sec_per_chip", timer.slices_per_sec, global_step)

        # ---------------- validation phase ----------------
        val_steps = max(len(val_idx) // per_step, 1) if len(val_idx) else 0
        val_sels = [s for s in (val_idx[i * per_step:(i + 1) * per_step]
                                for i in range(val_steps)) if len(s)]
        vbar = _pbar(len(val_sels) * per_step, "Validation round")
        val_pending, first_images = [], None
        for sel in val_sels:
            if interrupted():
                raise KeyboardInterrupt
            vloss, dice, preds, img, msk = eval_step(state, images_d, labels_d,
                                                     _rows(index, sel, device))
            val_pending.append((vloss, dice))
            if first_images is None:  # one image triplet a validation round
                first_images = (preds, img, msk, global_step)
            global_step += 1
            vbar.update(per_step)
        if first_images is not None:
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

        if val_sels:
            avg_loss = loss_sum / len(val_sels)
            avg_dice = dice_sum / len(val_sels)
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
            ckpt.save_checkpoint(path, state, plateau, extra=model_extra)
            log.info("Saved model %s", path)
        log.info(
            "epoch %d/%d done (%.4fs/step median, %.1f slices/s/chip)",
            gepoch + 1, cfg.epochs + cfg.epoch_offset, timer.sec_per_step, timer.slices_per_sec,
        )
        if interrupted():
            raise KeyboardInterrupt
