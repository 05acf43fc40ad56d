"""Eval CLI of the port (counterpart of the JAX package's root ``eval.py``,
flag for flag, plus ``--device``).

    python -m pmpu_tpu_torch.eval -m probunet -f ckpt.pt -d DATA_DIR

Loads a checkpoint (a JAX pickle checkpoint or a reference torch
``state_dict``; none: untrained weights from ``--seed``), runs whole-volume
multi-view fused inference on every volume of ``DATA_DIR/{images,labels}``,
saves the fused argmax segmentations as NIfTI into ``predictions/`` in the
working directory, and prints the per-view and fused per-class Dice
mean and std in the reference's report format. Runs on the card;
``--device cpu`` runs the kernels' plain versions on the CPU.

``--data-parallel`` (JAX ``eval.py:67-72``) evaluates slice-parallel over
ranks, one process a card on ``torch.distributed`` (NCCL; gloo with
``--device cpu``):

    torchrun --nproc-per-node 4 -m pmpu_tpu_torch.eval --data-parallel ...

joins the world torchrun describes (the device is ``cuda:{LOCAL_RANK}``);
without torchrun's environment, more than one visible card starts one
worker per card itself (``parallel.spawn_world``). Each rank runs its block
of every slab's chunks and the logits are all-gathered
(``VolumeEvaluator(mesh=...)``): the report is one process's, bit for bit.
Rank 0 alone prints and writes ``predictions/``, the uncertainty maps and
the int8 scale file. In a world of 1, as on one device in JAX, it runs the
one-process path.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from pmpu_tpu_torch.config import add_eval_args, config_from_args
from pmpu_tpu_torch.data.volumes import VolumeStore
from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.inference.engine import VolumeEvaluator, derive_seed
from pmpu_tpu_torch.parallel.mesh import init_distributed, local_device, make_mesh, spawn_world
from pmpu_tpu_torch.train.checkpoint import load_for_inference
from pmpu_tpu_torch.train.tasks import make_task

BANNER = "UNET EVALUATION (pmpu_tpu)"


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(
        description="Predict using a trained UNet",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    argv = sys.argv[1:] if argv is None else list(argv)
    args = add_eval_args(parser).parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    if (cfg.data_parallel and "WORLD_SIZE" not in os.environ and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        logging.info("one worker per card: %d processes", torch.cuda.device_count())
        spawn_world(main, torch.cuda.device_count(), (argv,))
        return 0
    if cfg.dir is None:
        parser.error("-d/--dir DATA_DIR is required")
    owned = not dist.is_initialized()  # a caller's process group stays the caller's
    rank, n_ranks = init_distributed(device)  # no-op without torchrun's environment
    try:
        return _evaluate(cfg, local_device(args.device), rank, n_ranks)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _evaluate(cfg, device, rank: int, n_ranks: int) -> int:
    lead = rank == 0  # prints the report and writes the files
    if lead:
        print(BANNER)
    if cfg.compile_cache:
        logging.info("--compile-cache %s ignored: PyTorch runs eagerly, there is no "
                     "compilation cache", cfg.compile_cache)
    mesh = None
    if cfg.data_parallel and n_ranks > 1:
        mesh = make_mesh()
        logging.info("rank %d of %d on %s: slice slabs over %s", rank, n_ranks, device,
                     mesh.shape)
    # eval builds both models with n_classes=3 (reference eval.py:85-88)
    if cfg.n_classes is None:
        cfg.n_classes = 3

    store = VolumeStore.from_dirs(os.path.join(cfg.dir, "images"),
                                  os.path.join(cfg.dir, "labels"), mmap_dir=cfg.mmap_store)
    logging.info("%d volumes, cube %d", len(store), store.cube)

    if cfg.load:
        task, cfg = load_for_inference(cfg.load, cfg, device=device)
    else:
        task = make_task(cfg.net, **cfg.task_kwargs(), device=device, seed=cfg.seed)
        logging.warning("no -f/--load given: evaluating an untrained model")

    evaluator = VolumeEvaluator(
        task,
        n_samples=cfg.eval_samples if task.is_probabilistic else 1,
        eval_batch=cfg.eval_batch,
        num_views=cfg.num_views,
        quantize=cfg.quantize,
        calibration=cfg.calibration,
        input_dtype=cfg.input_dtype,
        source_geometry=not cfg.identity_affine,
        device=device,
        mesh=mesh,
    )
    if lead:
        os.makedirs("predictions", exist_ok=True)
        if cfg.save_uncertainty:
            os.makedirs(cfg.save_uncertainty, exist_ok=True)
    # one model pass per volume: the Dice report, the argmax NIfTI and the
    # entropy maps all come from the same fused volume
    if cfg.eval_mode == "batched":
        report = evaluator.evaluate_store_batched(
            store, seed=cfg.seed, save_dir="predictions", uncertainty_dir=cfg.save_uncertainty,
            volumes_per_batch=cfg.eval_volumes_batch)
    else:
        report = evaluator.evaluate_store(
            store, seed=cfg.seed, save_dir="predictions", uncertainty_dir=cfg.save_uncertainty,
            pipeline_depth=cfg.pipeline_depth)
    if cfg.save_uncertainty and lead:
        logging.info("wrote uncertainty maps to %s", cfg.save_uncertainty)

    if task.is_probabilistic and cfg.ged > 0:
        # one more pass a volume, N prior draws sharing the backbone and prior
        geds = [evaluator.ged_volume(store.images[i], store.labels[i], cfg.ged,
                                     seed=derive_seed(cfg.seed, 1000 + i))
                for i in range(len(store))]
        if lead:
            print(f"GED^2 ({cfg.ged} samples): mean={np.mean(geds):.4f}, std={np.std(geds):.4f}")

    if not lead:
        return 0
    for v, arr in enumerate(report["per_view"]):
        print(f"view {v + 1} dice: mean={arr.mean(axis=0)}, std={arr.std(axis=0)}")
    fused = report["fused"]
    print(f"avg volume: mean={fused.mean(axis=0)}, std={fused.std(axis=0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
