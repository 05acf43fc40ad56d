"""What the serving cells share: the program's evaluator built from a
configuration, the seeded backlog of scans, and the check of the labels that
reached the host against the reference's fused probabilities."""

from __future__ import annotations

import copy
import gc
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import inputs
from benchmark.core import Check
from benchmark.reference import infer as ref_infer

EPS = 1e-8  # mean gaps this small read as none (a ratio of two nones is 1)
# ratio → the power of the gaps it averages: Σ gap^p of the served labels
# over Σ gap^p of the reference's own bf16 labels
RATIOS = {"label_gap_over_bf16": 1, "label_gap_sq_over_bf16": 2, "label_gap_cube_over_bf16": 3}


@dataclass
class Serving:
    weights: dict
    volumes: list        # host (S,S,S) f32 scans
    evaluator: object
    stream_seed: int     # volume i of the window is served with derive_seed(this, i)


def make_evaluator(ctx, weights: dict):
    """The program's ``VolumeEvaluator`` for the configuration, holding a
    copy of ``weights``; the control runs its int8 path."""
    from pmpu_tpu_torch import VolumeEvaluator, make_task

    cfg = ctx.config
    task = make_task("probunet", n_channels=cfg["input_channels"],
                     n_classes=cfg["num_classes"], num_filters=tuple(cfg["num_filters"]),
                     latent_dim=cfg["latent_dim"], no_convs_fcomb=cfg["no_convs_fcomb"],
                     dtype=inputs.DTYPES[cfg["dtype"]], device=ctx.device, seed=0)
    task.net.load_state_dict(weights)
    return VolumeEvaluator(task, n_samples=cfg["prior_samples"], num_views=cfg["views"],
                           input_dtype=cfg["wire"],
                           quantize="int8" if ctx.variant == "control" else None,
                           device=ctx.device)


def setup(ctx) -> Serving:
    """Weights on the device, ``volumes`` distinct scans in host memory, the
    evaluator."""
    cfg, wl = ctx.config, ctx.workload
    weights = inputs.make_weights(cfg, ctx.seed, ctx.device)
    imgs, _ = inputs.make_scans(wl["volumes"], ctx.seed, cfg["scan_shape"], cfg["cube"],
                                ctx.device)
    inputs.balance_classes(weights, cfg, imgs[0], ctx.seed)
    volumes = list(imgs.cpu().numpy())
    del imgs
    return Serving(weights, volumes, make_evaluator(ctx, weights),
                   inputs.sub_seed(ctx.seed, inputs.DRAWS))


def sample(ctx, served: int) -> list:
    """The indices of the served volumes that the check compares, drawn
    from the seed."""
    k = min(ctx.workload["check_volumes"], served)
    rng = np.random.default_rng(inputs.sub_seed(ctx.seed, inputs.SAMPLE))
    return sorted(int(i) for i in rng.choice(served, size=k, replace=False))


def check(ctx, st: Serving, labels: dict) -> list:
    """``labels`` {window index: host labels}: each compared with the
    reference's fused probabilities of the same scan and draws, after the
    program's state is freed. Per voxel, the gap is by how much the
    reference's probability of the served label lies below its best. How
    many voxels lie near a tie, and so flip on rounding, varies several-fold
    with a seed's random weights, so each number compared is a ratio to the
    same gaps of the reference's own labels computed in bf16 (its rounding
    in the configured precision), which reads about 1 for honest bf16
    arithmetic: the mean of the gaps (``label_gap_over_bf16``), or of their
    squares or cubes, which weigh a flip by how far it lies from a tie.
    With ``ctx.diagnose``: every ratio, the widest gap, both mean gaps."""
    lim = ctx.workload["limits"]
    powers = {k: p for k, p in RATIOS.items() if ctx.diagnose or k in lim}
    st.evaluator = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    net = inputs.reference_model(ctx.config, ctx.device)
    net.load_state_dict(st.weights, strict=False)
    net.eval()
    net16 = copy.deepcopy(net).to(torch.bfloat16)
    sums = {k: [0.0, 0.0] for k in powers}  # Σ gap^p of the served labels, of the bf16 ones
    widest, voxels = 0.0, 0
    for i, lab in sorted(labels.items()):
        seed = ref_infer.derive_seed(st.stream_seed, i)
        vol = st.volumes[i % len(st.volumes)]
        probs = ref_infer.fused_probs(net, vol, ctx.config, seed)
        gap = ref_infer.label_gaps(probs, lab).double()
        own = ref_infer.fused_probs(net16, vol, ctx.config, seed).argmax(-1)
        gap16 = ref_infer.label_gaps(probs, own.cpu().numpy()).double()
        del probs, own
        for k, p in powers.items():
            sums[k][0] += float(gap.pow(p).sum())
            sums[k][1] += float(gap16.pow(p).sum())
        widest, voxels = max(widest, float(gap.max())), voxels + gap.numel()
        del gap, gap16
    numbers = {k: (a / voxels + EPS ** powers[k]) / (b / voxels + EPS ** powers[k])
               for k, (a, b) in sums.items()}
    if ctx.diagnose:
        a, b = sums["label_gap_over_bf16"]
        numbers.update(label_gap_max=widest, label_gap_mean=a / voxels,
                       label_gap_bf16_reference=b / voxels)
    return [Check(k, v, lim.get(k)) for k, v in numbers.items()]
