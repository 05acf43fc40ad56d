"""The reference's whole-volume multi-view inference, plain PyTorch in
float32 with TF32 off, written from the method and not from the program:

  volume → the configured wire (uint8 fixed point against the volume's max)
  → every plane of each view (the 3 axis views; or k isotropic oblique
  views, sampled trilinearly, zero outside) → each plane divided by its max
  → the reference network: features and prior once a slice, ``samples``
  prior draws z = μ + σ·ε decoded by the fcomb, their logits averaged →
  softmax → back onto the voxel grid (inverse transposes; or a trilinear
  resample of each oblique view) → the mean over the views.

The prior's draws of chunk i of volume j are the numbers that a generator
seeded from ``derive_seed(derive_seed(seed, j), i)`` gives on the device, in
chunks of the size ``chunk_plan`` gives: the serving path's documented seed
arithmetic, copied here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import exact_f32


def derive_seed(seed: int, i: int) -> int:
    """The 63-bit seed of item i of a stream seeded ``seed``."""
    state = np.random.SeedSequence([seed, i]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def chunk_plan(total: int, h: int, w: int) -> tuple:
    """(slices a chunk, chunks): about 128 slices of 128² a chunk, scaled by
    the slice area, a divisor of the slab where one is at least half that."""
    target = min(total, max(32, (128 * 128 * 128) // max(h * w, 1)))
    b = max((d for d in range(1, target + 1) if total % d == 0), default=target)
    if b < target // 2:
        b = target
    return b, -(-total // b)


def view_bases(k: int) -> np.ndarray:
    """(k,3,3) f32 orthonormal (u, v, n) bases of k view axes about uniform
    on the half sphere (a golden spiral)."""
    i = np.arange(k, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - i / k)
    theta = np.pi * (1.0 + 5 ** 0.5) * i
    axes = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=1).astype(np.float32).astype(np.float64)
    out = []
    for a in axes:
        n = a / np.linalg.norm(a)
        helper = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        u = np.cross(helper, n)
        u /= np.linalg.norm(u)
        out.append(np.stack([u, np.cross(n, u), n]))
    return np.stack(out).astype(np.float32)


def wire(volume: np.ndarray, dtype: str) -> torch.Tensor:
    """The volume as the configured wire carries it, widened to f32."""
    a = np.asarray(volume, np.float32)
    if dtype == "uint8":
        m = a.max(keepdims=True)
        q = a * np.divide(np.float32(255.0), m, out=np.zeros_like(m), where=m > 0)
        return torch.from_numpy(np.rint(q).astype(np.uint8)).float()
    if dtype == "bfloat16":
        return torch.from_numpy(a).to(torch.bfloat16).float()
    return torch.from_numpy(a.copy())


def _sample(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of a (S,S,S[,C]) grid at (...,3) voxel coordinates
    (axes 0, 1, 2 of the grid), zero outside → (...[,C])."""
    s = volume.shape[0]
    chans = volume.dim() == 4
    inp = (volume.permute(3, 0, 1, 2) if chans else volume[None])[None]
    g = coords.reshape(1, -1, 1, 1, 3).flip(-1) * (2.0 / (s - 1)) - 1.0
    out = F.grid_sample(inp, g, mode="bilinear", padding_mode="zeros", align_corners=True)
    out = out.reshape(out.shape[1], *coords.shape[:-1])
    return out.movedim(0, -1) if chans else out[0]


def _centred_grid(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.float32, device=device) - (s - 1) / 2.0


def slabs(vol: torch.Tensor, bases) -> torch.Tensor:
    """(V·S,S,S) planes of the views, plane v·S + i at offset i − (S−1)/2
    along view v's normal; ``bases`` None: the 3 axis views (vol[i],
    vol[:, i], vol[:, :, i])."""
    s = vol.shape[0]
    if bases is None:
        return torch.cat([vol, vol.permute(1, 0, 2), vol.permute(2, 0, 1)])
    g = _centred_grid(s, vol.device)
    off, u, v = g.view(s, 1, 1, 1), g.view(1, s, 1, 1), g.view(1, 1, s, 1)
    out = []
    for b in torch.from_numpy(bases).to(vol.device):
        out.append(_sample(vol, (s - 1) / 2.0 + off * b[2] + u * b[0] + v * b[1]))
    return torch.cat(out)


def to_grid(probs: torch.Tensor, bases) -> list:
    """(V·S,S,S,C) plane probabilities → V volumes (S,S,S,C) on the grid;
    ``bases`` None: the 3 axis views."""
    s = probs.shape[1]
    if bases is None:
        return [probs[:s], probs[s:2 * s].permute(1, 0, 2, 3), probs[2 * s:].permute(1, 2, 0, 3)]
    g = _centred_grid(s, probs.device)
    x, y, z = g.view(s, 1, 1, 1), g.view(1, s, 1, 1), g.view(1, 1, s, 1)
    out = []
    for i, b in enumerate(torch.from_numpy(bases).to(probs.device)):
        along = [x * b[k][0] + y * b[k][1] + z * b[k][2] + (s - 1) / 2.0 for k in range(3)]
        coords = torch.cat([along[2], along[0], along[1]], dim=-1)  # (S,S,S,3): off, u, v
        out.append(_sample(probs[i * s:(i + 1) * s], coords))
    return out


def normalize(planes: torch.Tensor) -> torch.Tensor:
    """Each plane divided by its max; a plane whose max is 0 as it is."""
    m = planes.amax(dim=(-2, -1), keepdim=True)
    return torch.where(m == 0, planes, planes / m)


@torch.no_grad()
def chunk_logits(net, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """(b,1,S,S) f32 slices, (samples,b,latent) draws → (b,S,S,C) f32 mean
    logits; a network in another dtype computes in it, its draws in f32."""
    dt = next(net.parameters()).dtype
    x = x.to(dt)
    feats = net.unet(x)
    mu, log_sigma = (t.float() for t in net.prior(x))
    acc = 0
    for e in eps:
        acc = acc + net.fcomb(feats, (mu + torch.exp(log_sigma) * e).to(dt)).float()
    return (acc / eps.shape[0]).permute(0, 2, 3, 1)


@torch.no_grad()
def fused_probs(net, volume: np.ndarray, cfg: dict, seed: int) -> torch.Tensor:
    """(S,S,S,C) f32 fused class probabilities of one host volume, on the
    network's device; ``seed`` is the volume's own (its chunks' draws). The
    network computes in its own dtype, everything around it in f32."""
    device = next(net.parameters()).device
    bases = None if cfg["views"] == 3 else view_bases(cfg["views"])
    with exact_f32():
        vol = wire(volume, cfg["wire"]).to(device)
        planes = slabs(vol, bases)
        total, s = planes.shape[0], planes.shape[-1]
        b, n = chunk_plan(total, s, s)
        probs = torch.empty((total, s, s, cfg["num_classes"]), device=device)
        for i in range(n):
            x = normalize(planes[i * b:(i + 1) * b])
            g = torch.Generator(device=device).manual_seed(derive_seed(seed, i))
            eps = torch.randn((cfg["prior_samples"], b, cfg["latent_dim"]), generator=g,
                              device=device)
            logits = chunk_logits(net, x[:, None], eps[:, :x.shape[0]])
            probs[i * b:(i + 1) * b] = torch.softmax(logits, dim=-1)
        views = to_grid(probs, bases)
        fused = views[0]
        for v in views[1:]:
            fused = fused + v
        return fused / float(len(views))


def label_gaps(ref_probs: torch.Tensor, labels: np.ndarray) -> torch.Tensor:
    """Per voxel, by how much the reference's probability of the served
    label lies below the reference's best (1 for a label that is no class):
    0 where the served label is the reference's argmax."""
    lab = torch.from_numpy(np.ascontiguousarray(labels)).to(ref_probs.device).long()
    if lab.shape != ref_probs.shape[:-1]:
        raise ValueError(f"served labels {tuple(lab.shape)} against {tuple(ref_probs.shape)}")
    bad = (lab < 0) | (lab >= ref_probs.shape[-1])
    served = ref_probs.gather(-1, lab.clamp(0, ref_probs.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(bad, 1.0, ref_probs.amax(-1) - served)


def label_gap(ref_probs: torch.Tensor, labels: np.ndarray) -> float:
    """The widest of :func:`label_gaps`."""
    return float(label_gaps(ref_probs, labels).max())
