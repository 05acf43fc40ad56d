"""The serving cell of the Hierarchical Probabilistic U-Net: the program's
evaluator built from the configuration, the seeded weights at the published
initializers, the control, and the check of the labels that reached the host
against the f32 reference's fused probabilities (``reference/hpunet.py``).

The scans, the stream's seeds, the checked sample and the ratios compared
are the probunet cells' (``inputs.py``, ``serving.py``).
"""

from __future__ import annotations

import copy
import functools
import gc
import math

import torch
from torch import nn

from benchmark import hpunet_faults, inputs, serving
from benchmark.core import Check
from benchmark.reference import hpunet as ref_hpunet
from benchmark.reference.infer import derive_seed, label_gaps, normalize
from benchmark.reference.model import exact_f32, round_fp8


def _arch(cfg: dict) -> tuple:
    """The network's arguments after (input channels, classes), in order."""
    return (tuple(cfg["channels_per_block"]), tuple(cfg["down_channels_per_block"]),
            cfg["convs_per_block"], cfg["blocks_per_level"], tuple(cfg["latent_dims"]))


def reference_model(cfg: dict, device) -> nn.Module:
    """The reference network of a configuration, its storage uninitialised
    (load the weights of :func:`make_weights` into it)."""
    with torch.device("meta"):
        net = ref_hpunet.THierarchicalProbUNet(cfg["input_channels"], cfg["num_classes"],
                                               *_arch(cfg))
    return net.to_empty(device=device)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{name: f32 tensor} of the network's parameters, the published
    initializers: every conv's weight orthogonal at gain 1 (the rows or the
    columns of its (out, in·k·k) matrix orthonormal, ``nn.init.orthogonal_``'s
    algorithm) and its bias N(0, 0.001), from one normal draw on the device."""
    net = reference_model(cfg, "meta")
    leaves = [(name, tuple(p.shape)) for name, p in net.named_parameters()]
    total = sum(math.prod(s) for _, s in leaves)
    g = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, inputs.WEIGHTS))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape in leaves:
        t = flat[off:off + math.prod(shape)]
        off += t.numel()
        if name.endswith("bias"):
            out[name] = t.mul(0.001)
            continue
        a = t.view(shape[0], -1)
        wide = a.shape[0] < a.shape[1]
        q, r = torch.linalg.qr(a.t() if wide else a)
        q = q * torch.diagonal(r).sign()
        out[name] = (q.t() if wide else q).reshape(shape).contiguous()
    return out


@torch.no_grad()
def balance_classes(weights: dict, cfg: dict, volume: torch.Tensor, seed: int) -> dict:
    """Set the class head so that, over 24 planes of ``volume`` (8 of each
    axis view through its middle half) and their prior draws, every class
    has the median logit 0 and the logits spread by ``inputs.LOGIT_STD``, as
    ``inputs.balance_classes`` sets the probunet's (random weights otherwise
    give some classes nearly nowhere, and a spread that differs from seed to
    seed would make the rounding's effect on the labels differ with it)."""
    net = reference_model(cfg, volume.device)
    net.load_state_dict(weights)
    s = volume.shape[0]
    idx = torch.linspace(s // 4, 3 * s // 4, 8, device=volume.device).long()
    planes = torch.cat([volume[idx], volume[:, idx].transpose(0, 1),
                        volume[:, :, idx].permute(2, 0, 1)])
    g = torch.Generator(device=volume.device).manual_seed(inputs.sub_seed(seed, inputs.BALANCE))
    with exact_f32():
        x = normalize(planes.float())[:, None]
        eps = ref_hpunet.draw_eps(net, g, cfg["prior_samples"], x.shape[0], s)
        logits = ref_hpunet.chunk_logits(net, x, eps)
    per_class = logits.movedim(-1, 0).flatten(1)
    m = per_class.median(dim=1).values
    k = inputs.LOGIT_STD / (per_class - m[:, None]).std(dim=1).mean()
    weights["logits.weight"] *= k
    weights["logits.bias"] -= m
    weights["logits.bias"] *= k
    return weights


def _fp8_conv_forward(conv, x, w, b):
    return nn.Conv2d._conv_forward(conv, round_fp8(x), round_fp8(w), b)


def fp8_program(net: nn.Module) -> nn.Module:
    """The control: every conv of the program's network computes on its input
    and weight rounded to float8 e4m3 (``reference/model.py::round_fp8``, each
    tensor under its own absolute max), after the program's own casts; the
    program's code is unchanged."""
    from pmpu_tpu_torch.models.unet import Conv2d

    for m in net.modules():
        if isinstance(m, Conv2d):
            m._conv_forward = functools.partial(_fp8_conv_forward, m)
    return net


def program_task(ctx):
    """The program's hpunet task for the configuration (random weights from
    seed 0, replaced by the run's): built first, so that a program without
    the hpunet fails at once."""
    from pmpu_tpu_torch import make_task

    cfg = ctx.config
    kw = dict(zip(("channels_per_block", "down_channels_per_block", "convs_per_block",
                   "blocks_per_level", "latent_dims"), _arch(cfg)))
    return make_task("hpunet", n_channels=cfg["input_channels"], n_classes=cfg["num_classes"],
                     dtype=inputs.DTYPES[cfg["dtype"]], device=ctx.device, seed=0, **kw)


def setup(ctx) -> serving.Serving:
    """The program's task, the weights on the device (the class head
    balanced), ``volumes`` distinct scans in host memory, and the evaluator;
    the control's float8 convs, or the fault the workload names."""
    from pmpu_tpu_torch import VolumeEvaluator

    cfg, wl = ctx.config, ctx.workload
    task = program_task(ctx)
    weights = make_weights(cfg, ctx.seed, ctx.device)
    imgs, _ = inputs.make_scans(wl["volumes"], ctx.seed, cfg["scan_shape"], cfg["cube"],
                                ctx.device)
    balance_classes(weights, cfg, imgs[0], ctx.seed)
    volumes = list(imgs.cpu().numpy())
    del imgs
    task.net.load_state_dict(weights)
    if ctx.variant == "control":
        fp8_program(task.net)
    ev = VolumeEvaluator(task, n_samples=cfg["prior_samples"], num_views=cfg["views"],
                         input_dtype=cfg["wire"], device=ctx.device)
    if wl.get("fault"):
        hpunet_faults.FAULTS[wl["fault"]](ev)
    return serving.Serving(weights, volumes, ev, inputs.sub_seed(ctx.seed, inputs.DRAWS))


def check(ctx, st: serving.Serving, labels: dict) -> list:
    """``serving.check`` with the hpunet's reference: each volume's labels
    against the f32 reference's fused probabilities of the same scan and
    draws, as ratios to the same gaps of the reference's own labels computed
    in bf16, after the program's state is freed."""
    lim = ctx.workload["limits"]
    powers = {k: p for k, p in serving.RATIOS.items() if ctx.diagnose or k in lim}
    st.evaluator = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    net = reference_model(ctx.config, ctx.device)
    net.load_state_dict(st.weights)
    net.eval()
    net16 = copy.deepcopy(net).to(torch.bfloat16)
    sums = {k: [0.0, 0.0] for k in powers}  # Σ gap^p of the served labels, of the bf16 ones
    widest, voxels = 0.0, 0
    for i, lab in sorted(labels.items()):
        seed = derive_seed(st.stream_seed, i)
        vol = st.volumes[i % len(st.volumes)]
        probs = ref_hpunet.fused_probs(net, vol, ctx.config, seed)
        gap = label_gaps(probs, lab).double()
        own = ref_hpunet.fused_probs(net16, vol, ctx.config, seed).argmax(-1)
        gap16 = label_gaps(probs, own.cpu().numpy()).double()
        del probs, own
        for k, p in powers.items():
            sums[k][0] += float(gap.pow(p).sum())
            sums[k][1] += float(gap16.pow(p).sum())
        widest, voxels = max(widest, float(gap.max())), voxels + gap.numel()
        del gap, gap16
    eps = serving.EPS
    numbers = {k: (a / voxels + eps ** powers[k]) / (b / voxels + eps ** powers[k])
               for k, (a, b) in sums.items()}
    if ctx.diagnose:
        a, b = sums["label_gap_over_bf16"]
        numbers.update(label_gap_max=widest, label_gap_mean=a / voxels,
                       label_gap_bf16_reference=b / voxels)
    return [Check(k, v, lim.get(k)) for k, v in numbers.items()]
