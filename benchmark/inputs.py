"""The inputs of a run, made from its seed: the network's weights, made on
the device in one draw, and the scans, made in bulk on the device.

The same seed gives the same inputs on the same device. The program and the
reference are handed the same tensors (the program copies the weights into
its own network); neither makes any of them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.model import TProbUNet


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    state = np.random.SeedSequence([int(seed), 7919, int(stream)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


WEIGHTS, SCANS, DRAWS, SAMPLE, BALANCE = 1, 2, 3, 4, 5  # sub-seed streams
DTYPES = {"bfloat16": torch.bfloat16, "float32": None}  # a configuration's dtype → make_task's


def reference_model(cfg: dict, device) -> nn.Module:
    """The reference network of a configuration, its storage uninitialised
    (load the weights of :func:`make_weights` into it)."""
    with torch.device("meta"):
        net = TProbUNet(cfg["input_channels"], cfg["num_classes"], tuple(cfg["num_filters"]),
                        cfg["latent_dim"], cfg["no_convs_fcomb"])
    net = net.to_empty(device=device)
    for name, buf in net.named_buffers():
        if name.endswith("num_batches_tracked"):
            buf.zero_()
    return net


def _init_rule(module: nn.Module, leaf: str, shape) -> tuple:
    """(mean, std) of one leaf: He for the convolutions that feed a ReLU,
    1/√fan-in for the transposed convolutions and the class head, a tenth of
    that for the μ/log σ heads (so that the prior's draws stay of order 1),
    BatchNorm's scale near 1 with small shifts and running statistics."""
    if isinstance(module, nn.BatchNorm2d):
        return {"weight": (1.0, 0.1), "bias": (0.0, 0.1), "running_mean": (0.0, 0.1),
                "running_var": (1.0, 0.1)}[leaf]
    if leaf == "bias":
        return 0.0, 0.01
    if isinstance(module, nn.ConvTranspose2d):
        return 0.0, math.sqrt(1.0 / shape[0])
    fan_in = shape[1] * shape[2] * shape[3]
    return 0.0, math.sqrt(2.0 / fan_in)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{name: f32 tensor} of the reference's parameters and BatchNorm
    statistics (without ``num_batches_tracked``): one normal draw on the
    device for all of them, scaled leaf by leaf."""
    with torch.device("meta"):
        net = TProbUNet(cfg["input_channels"], cfg["num_classes"], tuple(cfg["num_filters"]),
                        cfg["latent_dim"], cfg["no_convs_fcomb"])
    leaves = []
    for mname, module in net.named_modules():
        for leaf, t in list(module.named_parameters(recurse=False)) + list(
                module.named_buffers(recurse=False)):
            if leaf == "num_batches_tracked":
                continue
            mean, std = _init_rule(module, leaf, t.shape)
            if mname.endswith("conv_layer"):      # the μ/log σ heads
                std = 0.1 * math.sqrt(1.0 / t.shape[1]) if leaf == "weight" else std
            if mname.endswith("last_layer") and leaf == "weight":
                std = math.sqrt(1.0 / t.shape[1])
            leaves.append((f"{mname}.{leaf}", tuple(t.shape), mean, std))
    total = sum(math.prod(s) for _, s, _, _ in leaves)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape, mean, std in leaves:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape).mul_(std).add_(mean)
        if name.endswith("running_var"):
            t.abs_()
        if name.endswith("conv_layer.bias"):  # log σ about −2: the features, not the
            t[cfg["latent_dim"]:] -= 2.0      # prior's noise, decide the classes
        out[name] = t
        off += n
    return out


LOGIT_STD = 1.0  # the class logits' spread over the pixels after balancing


@torch.no_grad()
def balance_classes(weights: dict, cfg: dict, volume: torch.Tensor, seed: int) -> dict:
    """Set the class head so that, over 24 planes of ``volume`` (8 of each
    axis view through its middle half) and their prior draws, every class
    has the median logit 0 and the logits spread by ``LOGIT_STD``: random
    weights otherwise give one class nearly everywhere (labels that never
    change would test nothing), and a spread that differs from seed to seed
    would make the rounding's effect on the labels differ with it."""
    from benchmark.reference.infer import normalize
    from benchmark.reference.model import exact_f32

    net = reference_model(cfg, volume.device)
    net.load_state_dict(weights, strict=False)
    net.eval()
    s = volume.shape[0]
    idx = torch.linspace(s // 4, 3 * s // 4, 8, device=volume.device).long()
    planes = torch.cat([volume[idx], volume[:, idx].transpose(0, 1),
                        volume[:, :, idx].permute(2, 0, 1)])
    g = torch.Generator(device=volume.device).manual_seed(sub_seed(seed, BALANCE))
    with exact_f32():
        x = normalize(planes.float())[:, None]
        mu, log_sigma = net.prior(x)
        feats = net.unet(x)
        logits = 0
        for _ in range(cfg["prior_samples"]):
            eps = torch.randn(mu.shape, generator=g, device=volume.device)
            logits = logits + net.fcomb(feats, mu + torch.exp(log_sigma) * eps)
    per_class = (logits / cfg["prior_samples"]).transpose(0, 1).flatten(1)
    m = per_class.median(dim=1).values
    k = LOGIT_STD / (per_class - m[:, None]).std(dim=1).mean()
    weights["fcomb.last_layer.weight"] *= k
    weights["fcomb.last_layer.bias"] -= m
    weights["fcomb.last_layer.bias"] *= k
    return weights


def _ellipsoids(n, shape, g, device, scale):
    """(n,) boolean volumes of one random ellipsoid each: centres in the
    middle 30 % of each axis, radii ``scale`` × (0.8 … 1) of each axis."""
    u = torch.rand((n, 6), generator=g, device=device)
    dims = torch.tensor(shape, dtype=torch.float32, device=device)
    centre = (0.35 + 0.3 * u[:, :3]) * dims
    radius = scale * (0.8 + 0.2 * u[:, 3:]) * dims
    axes = [torch.arange(d, dtype=torch.float32, device=device) for d in shape]
    q = 0
    for a, x in enumerate(axes):
        view = [1, 1, 1, 1]
        view[a + 1] = shape[a]
        c, r = centre[:, a].view(n, 1, 1, 1), radius[:, a].view(n, 1, 1, 1)
        q = q + ((x.view(view) - c) / r) ** 2
    return q <= 1.0


def make_scans(n: int, seed: int, shape, cube: int, device, stream: int = SCANS):
    """n scans of ``shape`` (a knee MRI's 104×170×170), zero-padded at the
    high end of each axis to a ``cube``³ (the reference's pad-to-cube), as
    ((n,cube,cube,cube) f32 images ≥ 0, (n,cube,cube,cube) int32 labels).

    An image is a smooth tissue field, two compact structures (class 1, and
    class 2 inside or beside it) brighter than it, and voxel noise; the
    labels are those two structures."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    shape = tuple(shape)
    low = torch.rand((n, 1, 8, 12, 12), generator=g, device=device)
    field = F.interpolate(low, size=shape, mode="trilinear", align_corners=True)[:, 0]
    big = _ellipsoids(n, shape, g, device, 0.3)
    small = _ellipsoids(n, shape, g, device, 0.15)
    labels = torch.where(small, 2, torch.where(big, 1, 0)).to(torch.int32)
    noise = torch.randn((n,) + shape, generator=g, device=device)
    img = 0.3 + 0.4 * field + 0.3 * big + 0.5 * small + 0.05 * noise
    img = img.clamp_(min=0.0)
    pad = [0, cube - shape[2], 0, cube - shape[1], 0, cube - shape[0]]
    return F.pad(img, pad), F.pad(labels, pad)
