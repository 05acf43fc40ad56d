"""Latent-space sampling visualizer of the port (counterpart of the JAX
package's root ``visualize_sampling.py``).

    python -m pmpu_tpu_torch.visualize_sampling -f ckpt.pt -d DATA_DIR [-n 3]

Loads a probunet checkpoint (a pickle checkpoint of either package or a
reference ``state_dict``; none: random weights from seed 0), picks one
label-bearing slice of ``DATA_DIR/{images,labels}`` with
``np.random.default_rng(--seed)`` (the JAX visualizer's choice), sweeps
latent dims 0 and 1 over μ ± k·σ and writes viz_scan.png, viz_label.png,
viz_grid.png and viz_uncertainty.png (the entropy over 16 prior draws) in
the working directory, each as ``.png.npy`` where matplotlib is missing.
Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np


def save_png(path, arr, cmap_gray=False):
    """PNG through matplotlib if it imports, else a raw ``.npy`` beside the
    name. Returns the path actually written."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(path, arr, cmap="Greys_r" if cmap_gray else None)
        return path
    except Exception:
        np.save(path + ".npy", arr)
        return path + ".npy"


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    p = argparse.ArgumentParser(description="Visualize probunet latent sampling")
    p.add_argument("-f", "--load", dest="load", type=str, default=None)
    p.add_argument("-d", "--dir", dest="dir", type=str, required=True)
    p.add_argument("-n", "--n-preds", dest="n_preds", type=int, default=3)
    p.add_argument("--sigma-scale", type=float, default=40.0)  # reference :78
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda, or cpu for the plain PyTorch path")
    args = p.parse_args(argv)

    import torch

    from pmpu_tpu_torch.config import Config
    from pmpu_tpu_torch.data.index_map import build_index_map
    from pmpu_tpu_torch.data.sampler import normalize_slice, take_plane
    from pmpu_tpu_torch.data.volumes import VolumeStore
    from pmpu_tpu_torch.device import resolve_device
    from pmpu_tpu_torch.inference.uncertainty import sample_grid, uncertainty_maps
    from pmpu_tpu_torch.train.tasks import make_task
    from pmpu_tpu_torch.utils.colorize import mask_to_image

    device = resolve_device(args.device)
    cfg = Config(net="probunet", n_classes=3, load=args.load)
    store = VolumeStore.from_dirs(os.path.join(args.dir, "images"),
                                  os.path.join(args.dir, "labels"))
    index = build_index_map(store.labels, filter=True)
    if not len(index):
        logging.error("no label-bearing slices in %s (all masks are background); "
                      "nothing to visualize", args.dir)
        return 1

    rng = np.random.default_rng(args.seed)
    scan, view, sl = index[rng.integers(len(index))]
    img = normalize_slice(take_plane(torch.from_numpy(np.asarray(store.images[scan])),
                                     view, sl)).numpy()
    msk = take_plane(torch.from_numpy(np.asarray(store.labels[scan])), view, sl).numpy()
    logging.info("slice: scan %d view %d index %d", scan, view, sl)

    if args.load:
        from pmpu_tpu_torch.train.checkpoint import load_for_inference

        task, cfg = load_for_inference(args.load, cfg, device=device)
    else:
        logging.warning("no checkpoint: visualizing an untrained model")
        task = make_task(cfg.net, **cfg.task_kwargs(), device=device, seed=0)

    grid, mu, sigma = sample_grid(task, img, args.n_preds, args.sigma_scale)
    print("mu: ", mu)
    print("sigma: ", sigma)

    written = [save_png("viz_scan.png", img, cmap_gray=True)]
    written.append(save_png("viz_label.png", mask_to_image(msk[None], 3)[0]))

    n = args.n_preds
    tile = mask_to_image(grid, 3, prediction=True)  # (n², H, W, 3)
    rows = [np.concatenate(list(tile[i * n:(i + 1) * n]), axis=1) for i in range(n)]
    written.append(save_png("viz_grid.png", np.concatenate(rows, axis=0)))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    _, entropy, _ = uncertainty_maps(task, img, n_samples=16, generator=gen)
    written.append(
        save_png("viz_uncertainty.png", entropy / max(entropy.max(), 1e-9), cmap_gray=True))
    logging.info("wrote %s", " ".join(written))
    return 0


if __name__ == "__main__":
    sys.exit(main())
