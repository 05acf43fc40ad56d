"""Predict CLI of the port — single-volume or batch segmentation
(counterpart of the JAX package's ``predict.py``).

    python -m pmpu_tpu_torch.predict -m probunet -f ckpt.pt -i scan.nii -o seg.nii
    python -m pmpu_tpu_torch.predict -m probunet -f ckpt.pt -i scans/ -o segs/

Loads a checkpoint (a JAX pickle checkpoint or a reference torch
``state_dict``; none: random weights from seed 0), segments NIfTI volumes
with multi-view fusion (probunet: N prior samples a slice) and saves the
fused argmax (and with ``--uncertainty`` the predictive entropy) as NIfTI,
cropped back to the source shape with the source affine unless
``--identity-affine``.

With a directory input the headers are read first, every volume is padded
to their common cube, and the volumes are read lazily into the pipelined
serving path (``predict_volumes_pipelined``: volume i+1 is dispatched
before volume i is fetched). Runs on the card; ``--device cpu`` runs the
kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from pmpu_tpu_torch.config import Config, parse_num_filters
from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.data.volumes import geom_from_header, pad_to_cube, restore_geometry


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="Predict masks from input images",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", "--load", dest="load", type=str, default=None, help="checkpoint")
    p.add_argument("-m", "--model", dest="net", type=str, default="unet")
    p.add_argument("-i", "--input", dest="input", type=str, required=True,
                   help="input .nii[.gz], or a directory of them (batch mode)")
    p.add_argument("-o", "--output", dest="output", type=str, default="prediction.nii",
                   help="output .nii (or directory in batch mode)")
    p.add_argument("--uncertainty", type=str, default=None,
                   help="also save entropy map .nii (or directory in batch mode)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="batch mode: volumes dispatched ahead of the fetch")
    p.add_argument("--eval-samples", dest="eval_samples", type=int, default=5)
    p.add_argument("--eval-batch", dest="eval_batch", type=int, default=0)
    p.add_argument("--num-views", dest="num_views", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute + compact bf16 volume uploads")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="post-training int8 inference")
    p.add_argument("--n-classes", dest="n_classes", type=int, default=3,
                   help="output classes (needed for raw torch state_dict "
                   "checkpoints, which carry no architecture record)")
    p.add_argument("--num-filters", dest="num_filters", type=parse_num_filters,
                   default=None,
                   help="comma-separated encoder widths (torch checkpoints; default: the "
                   "model's own)")
    p.add_argument("--identity-affine", dest="identity_affine", action="store_true",
                   help="strict reference-parity exports: padded cube + "
                   "identity affine (default: un-pad to the source shape and "
                   "carry the input scan's affine through)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    args = get_args(argv)
    from pmpu_tpu_torch.device import resolve_device
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator
    from pmpu_tpu_torch.train.tasks import make_task

    device = resolve_device(args.device)
    cfg = Config(net=args.net, n_classes=args.n_classes, load=args.load,
                 num_filters=args.num_filters,
                 eval_samples=args.eval_samples, eval_batch=args.eval_batch,
                 num_views=args.num_views, seed=args.seed, bf16=args.bf16,
                 quantize=args.quantize)

    if os.path.isdir(args.input):
        # NIfTI entries only: stray files and subdirectories are skipped
        names = sorted(filter(nifti.is_nifti_name, os.listdir(args.input)))
        if not names:
            logging.error("no .nii/.nii.gz volumes in %s", args.input)
            return 1
        # the common cube from the headers alone; the volumes are read
        # lazily by the stream below (about pipeline_depth at once)
        geoms = {n: geom_from_header(nifti.read_header(os.path.join(args.input, n)), n)
                 for n in names}
        cube = int(max(max(g.shape) for g in geoms.values()))
        vol = None
        logging.info("batch input %s: %d volumes → cube %d", args.input, len(names), cube)
    else:
        names = None
        geom = geom_from_header(nifti.read_header(args.input), args.input)
        vol = pad_to_cube(nifti.load(args.input))
        logging.info("input %s → cube %s", args.input, vol.shape)

    if args.load:
        from pmpu_tpu_torch.train.checkpoint import load_for_inference

        task, cfg = load_for_inference(args.load, cfg, device=device)
    else:
        logging.warning("no checkpoint: predicting with an untrained model")
        task = make_task(cfg.net, **cfg.task_kwargs(), device=device, seed=0)

    ev = VolumeEvaluator(
        task,
        n_samples=cfg.eval_samples if task.is_probabilistic else 1,
        eval_batch=cfg.eval_batch,
        num_views=cfg.num_views,
        quantize=cfg.quantize,
        calibration=cfg.calibration,
        input_dtype=cfg.input_dtype,
        device=device,
    )
    if names is not None:  # batch mode: the pipelined serving stream
        os.makedirs(args.output, exist_ok=True)
        if args.uncertainty:
            os.makedirs(args.uncertainty, exist_ok=True)
        lazy_vols = (pad_to_cube(nifti.load(os.path.join(args.input, n)), cube) for n in names)
        outs = ev.predict_volumes_pipelined(lazy_vols, seed=args.seed,
                                            pipeline_depth=args.pipeline_depth,
                                            want_entropy=bool(args.uncertainty))
        for n, out in zip(names, outs):
            seg, ent = out if args.uncertainty else (out, None)
            nifti.save(os.path.join(args.output, n),
                       *restore_geometry(seg, geoms[n], args.identity_affine))
            if ent is not None:
                nifti.save(os.path.join(args.uncertainty, n),
                           *restore_geometry(ent, geoms[n], args.identity_affine))
        logging.info("saved %d segmentations to %s", len(names), args.output)
        return 0
    # one volume: evaluate_volume's dispatch and fetch, the entropy of the
    # same fused volume when asked
    h = ev._dispatch_volume(vol, seed=args.seed, want_entropy=bool(args.uncertainty))
    nifti.save(args.output, *restore_geometry(ev._fetch_seg(h), geom, args.identity_affine))
    logging.info("saved %s", args.output)
    if args.uncertainty:
        nifti.save(args.uncertainty,
                   *restore_geometry(ev._fetch_entropy(h), geom, args.identity_affine))
        logging.info("saved %s", args.uncertainty)
    return 0


if __name__ == "__main__":
    sys.exit(main())
