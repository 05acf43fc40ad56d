"""Train CLI of the port (counterpart of the JAX package's root ``train.py``,
flag for flag, plus ``--device``).

    python -m pmpu_tpu_torch.train -m probunet -d DATA_DIR -e 5 -b 2 -l 0.001

DATA_DIR holds ``images/`` and ``labels/`` NIfTI pairs. Checkpoints go to
``--checkpoint-dir`` (every ``--checkpoint-every`` epochs, and
``{net}_model.pt`` at the end); Ctrl-C or SIGTERM writes ``INTERRUPTED.pth``
in the working directory and exits 0. Runs on the card; ``--device cpu``
runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from pmpu_tpu_torch.config import add_train_args, config_from_args
from pmpu_tpu_torch.data.volumes import VolumeStore
from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.train.loop import check_ported, train_net


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(
        description="Train the UNet on images and target masks",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    args = add_train_args(parser).parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    check_ported(cfg, device)
    if cfg.compile_cache:
        logging.info("--compile-cache %s ignored: PyTorch runs eagerly, there is no "
                     "compilation cache", cfg.compile_cache)
    if cfg.dir is None:
        parser.error("-d/--dir DATA_DIR is required")
    store = VolumeStore.from_dirs(os.path.join(cfg.dir, "images"),
                                  os.path.join(cfg.dir, "labels"), mmap_dir=cfg.mmap_store)
    logging.info("Creating dataset of %d scans (cube %d, %d slices/volume)",
                 len(store), store.cube, store.slices_per_volume)
    try:
        train_net(cfg, store, device=device)  # writes INTERRUPTED.pth itself
    except KeyboardInterrupt:
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
