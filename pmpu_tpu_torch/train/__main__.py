"""Train CLI of the port (counterpart of the JAX package's root ``train.py``,
flag for flag, plus ``--device``).

    python -m pmpu_tpu_torch.train -m probunet -d DATA_DIR -e 5 -b 2 -l 0.001

DATA_DIR holds ``images/`` and ``labels/`` NIfTI pairs. Checkpoints go to
``--checkpoint-dir`` (every ``--checkpoint-every`` epochs, and
``{net}_model.pt`` at the end); Ctrl-C or SIGTERM writes ``INTERRUPTED.pth``
in the working directory and exits 0. Runs on the card; ``--device cpu``
runs the kernels' plain versions on the CPU.

``--rss-limit-mb M``: an epoch that ends with the host RSS above M MB
writes ``{net}_rss_resume.pt``, and the process re-executes itself (``python
-m pmpu_tpu_torch.train``, the same flags) with ``-f`` on that checkpoint,
the remaining epochs and ``--epoch-offset`` advanced, so the run ends in a
fresh process with the epoch numbering of one run. SIGTERM writes
``INTERRUPTED.pth`` only while ``train_net`` holds training state (from its
"Starting training" line to the end of the loop); before that (the world's
rendezvous, the store's load, a re-exec's start-up, the resume checkpoint
already on disk) it ends the process at once, as it ends the JAX
``train.py``. In a world the ranks
decide together at the epoch's end, rank 0 writes the checkpoint, and
every rank destroys the process group and re-executes itself under
``parallel.next_world_env`` (the next world generation: a fresh prefix of
the store, and a new port where rank 0 hosts the store), so the new
processes meet in a fresh rendezvous, under torchrun (whose agent keeps
the PIDs it watches: ``execv`` keeps them) or ``spawn_world`` alike.

Several cards (``--data-parallel``, ``--sharded-volumes``; JAX ``train.py``
:46-52), one process a card on ``torch.distributed`` with NCCL:

    torchrun --nproc-per-node 4 -m pmpu_tpu_torch.train --data-parallel ...

joins the world torchrun describes (``parallel.init_distributed`` before
the store is read; the device is ``cuda:{LOCAL_RANK}``). Without torchrun's
environment, either flag with more than one visible card starts one worker
per card itself (``parallel.spawn_world``: a free port on localhost), so
that the flag means every visible device, as in JAX. On the CPU
(``--device cpu``) the world uses gloo.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys

import torch
import torch.distributed as dist

from pmpu_tpu_torch.config import add_train_args, config_from_args
from pmpu_tpu_torch.data.volumes import VolumeStore
from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.parallel.mesh import init_distributed, local_device, next_world_env, spawn_world
from pmpu_tpu_torch.train.loop import RssLimitExceeded, check_ported, train_net
from pmpu_tpu_torch.train.tasks import NOT_TRAINABLE


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGINT})  # blocked by a re-exec
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(
        description="Train the UNet on images and target masks",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    args = add_train_args(parser).parse_args(argv)
    cfg = config_from_args(args)
    if cfg.net == "hpunet":
        parser.error(f"-m hpunet: {NOT_TRAINABLE}")
    device = resolve_device(args.device)
    spawn = ((cfg.data_parallel or cfg.sharded_volumes) and "WORLD_SIZE" not in os.environ
             and device.type == "cuda" and torch.cuda.device_count() > 1)
    check_ported(cfg)
    if spawn:
        logging.info("one worker per card: %d processes", torch.cuda.device_count())
        spawn_world(main, torch.cuda.device_count(), (argv,))
        return 0
    if cfg.compile_cache:
        logging.info("--compile-cache %s ignored: PyTorch runs eagerly, there is no "
                     "compilation cache", cfg.compile_cache)
    if cfg.dir is None:
        parser.error("-d/--dir DATA_DIR is required")
    rank, n_ranks = init_distributed(device)  # no-op without torchrun's environment
    device = local_device(args.device)
    if n_ranks > 1:
        logging.info("rank %d of %d on %s", rank, n_ranks, device)
    try:
        store = VolumeStore.from_dirs(os.path.join(cfg.dir, "images"),
                                      os.path.join(cfg.dir, "labels"), mmap_dir=cfg.mmap_store)
        logging.info("Creating dataset of %d scans (cube %d, %d slices/volume)",
                     len(store), store.cube, store.slices_per_volume)
        train_net(cfg, store, device=device)  # writes INTERRUPTED.pth itself
    except KeyboardInterrupt:
        return 0
    except RssLimitExceeded as e:
        resume = _resume_argv(argv, e.checkpoint_path, cfg.epochs - e.epochs_done,
                              epoch_offset=cfg.epoch_offset + e.epochs_done)
        cmd = [sys.executable, "-m", "pmpu_tpu_torch.train", *resume]
        if dist.is_initialized():
            os.environ.update(next_world_env())
            dist.destroy_process_group()
        logging.warning("re-exec for bounded RSS: %s", " ".join(cmd))
        sys.stdout.flush()
        sys.stderr.flush()
        signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGINT})
        os.execv(sys.executable, cmd)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _resume_argv(argv: list, ckpt_path: str, remaining: int,
                 epoch_offset: int | None = None) -> list:
    """argv for the bounded-RSS re-exec (root ``train.py::_resume_argv``):
    ``-f/--load`` pointed at the resume checkpoint, ``-e/--epochs`` set to
    the remaining count and ``--epoch-offset`` advanced, each replaced in
    place when present (``--flag value`` or ``--flag=value``), appended
    otherwise."""
    out = list(argv)

    def _set(flags, value):
        for i, a in enumerate(out):
            if a in flags and i + 1 < len(out):
                out[i + 1] = value
                return
            for fl in flags:
                if a.startswith(fl + "="):
                    out[i] = fl + "=" + value
                    return
        out.extend([flags[0], value])

    _set(("-f", "--load"), ckpt_path)
    _set(("-e", "--epochs"), str(remaining))
    if epoch_offset is not None:
        _set(("--epoch-offset",), str(epoch_offset))
    return out


if __name__ == "__main__":
    sys.exit(main())
