"""Slice samplers of training and arbitrary-axis (oblique) plane sampling
(counterpart of ``pmpu_tpu/data/sampler.py``).

Training (``sample_batch`` :55, ``sample_batch_vt`` :74): a batch of
(scan, view, slice) rows becomes (B,S,S,1) f32 image planes, each divided
by its own max (left as it is when the max is 0), and (B,S,S,1) int32
label planes. ``sample_batch_vt`` gathers whole planes of the (3,N,S,S,S)
view stacks: on CUDA tensors that is one launch of the gather-normalize
kernel (``ops/cuda/slice_gather.py``), on CPU ones its plain version; it is
also the counterpart of ``ops/pallas/slice_gather.py::sample_batch_fused``
:104 (``--pallas-sampler``), which the JAX tests hold bit-equal to it.
``sample_batch`` reads the plain (N,S,S,S) stack with plain PyTorch
indexing (the JAX package has no kernel for that layout).

Oblique training (``make_oblique_sampler`` :112,
``make_oblique_view_stacks`` :148, ``oblique_nonempty_table`` :196): the
trilinear image planes and nearest label planes of k golden-spiral views.
``make_oblique_view_stacks`` samples every image plane of a scan in one
launch of the oblique-plane kernel (``ops/cuda/oblique_gather.py``) on
CUDA tensors, its plain version on CPU ones; the steps then gather from the
(V,N,S,S,S) stacks through ``sample_batch_vt`` as the 3 views do. The
label planes, ``make_oblique_sampler`` (``--no-view-stacks``) and
``oblique_nonempty_table`` are ports of the JAX package's XLA code, in
plain PyTorch: no TPU kernel computes them. ``sample_rows`` (:95) reads
the host-gathered batches of ``--stream`` (``data/pipeline.py``).
``take_plane`` (:33) cuts one axis-aligned plane (the sampling
visualizer's slice).

Oblique planes (:226-310): ``view_basis`` and ``fibonacci_views`` are
numpy copies of the JAX package's. ``plane_coords``, ``trilinear``,
``nearest`` (the label planes: JAX's ``oblique_plane(..., nearest=True)``)
and ``oblique_plane`` are plain PyTorch with the JAX operation order, each
step one rounded f32 operation:

  coords = ((center + u·b0) + v·b1) + off·b2,  grid = arange(S) − (S−1)/2
  frac   = c − floor(c)
  w      = (wx·wy)·wz                  (wx = frac or 1 − frac, per corner)
  out    = out + w·val                 over corners (dx,dy,dz) = 000 … 111

A corner outside the volume contributes 0; indices are clamped before the
gather. ``oblique_plane`` is the plain version of the oblique-plane kernel
(``pmpu_tpu_torch/ops/cuda/oblique_gather.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pmpu_tpu_torch.ops.cuda.slice_gather import flat_plane_index, gather_normalize_planes


def take_plane(volume: torch.Tensor, view: int, idx: int) -> torch.Tensor:
    """Plane ``idx`` of a (S,S,S) volume along axis ``view`` (``take_plane``
    :33): view 0 → volume[idx], 1 → volume[:, idx], 2 → volume[:, :, idx]."""
    return volume.select(int(view), int(idx))


def normalize_slice(img: torch.Tensor) -> torch.Tensor:
    """Each (S,S) plane of ``img`` (..., S, S) divided by its max, left as
    it is where that max is 0 (``normalize_slice`` :47)."""
    m = torch.amax(img, dim=(-2, -1), keepdim=True)
    return torch.where(m == 0, img, img / m)


def sample_batch(images: torch.Tensor, labels: torch.Tensor, triples: torch.Tensor):
    """(N,S,S,S) f32 images and int labels + (B,3) rows → ((B,S,S,1) f32
    normalized, (B,S,S,1) int32). Plane (a, b) of row (n, v, i) is voxel
    ``[i,a,b]``, ``[a,i,b]`` or ``[a,b,i]`` of volume n for v = 0, 1, 2."""
    s = images.shape[-1]
    tr = triples.long()
    n, v, i = (tr[:, k, None, None] for k in range(3))
    a = torch.arange(s, device=images.device)[:, None]
    b = torch.arange(s, device=images.device)[None, :]
    x = torch.where(v == 0, i, a)
    y = torch.where(v == 0, a, torch.where(v == 1, i, b))
    z = torch.where(v == 2, i, b)
    img = images[n, x, y, z].float()
    m = torch.amax(img, dim=(1, 2), keepdim=True)
    img = torch.where(m == 0, img, img / m)
    return img[..., None], labels[n, x, y, z].int()[..., None]


def sample_batch_vt(vt_images: torch.Tensor, vt_labels: torch.Tensor, triples: torch.Tensor):
    """The same batch from the (3,N,S,S,S) f32 image and int32 label view
    stacks, every row one whole plane: one launch of the gather-normalize
    kernel on CUDA tensors, its plain version on CPU ones (bit-equal to
    ``sample_batch`` on the plain stack)."""
    _, n, s = vt_images.shape[:3]
    flat = flat_plane_index(triples.long(), n, s)
    imgs, lbls = gather_normalize_planes(
        vt_images.reshape(-1, s, s), flat, vt_labels.reshape(-1, s, s))
    return imgs[..., None], lbls[..., None]


def sample_rows(images: torch.Tensor, labels: torch.Tensor, triples: torch.Tensor):
    """The sampler of ``--stream``: ``images`` (B,S,S,1) and ``labels``
    (B,S,S,1) are a batch gathered and normalized on the host
    (``data/pipeline.py``), and ``triples[:, 0]`` are rows of it, so a
    microbatch takes its rows as the other samplers take theirs. The
    compact wires (bf16 images, uint8 masks) are widened here, on the
    device, to f32 and int32."""
    rows = triples[:, 0].long()
    return images[rows].float(), labels[rows].int()


def plane_coords(bases: torch.Tensor, offsets: torch.Tensor, s: int) -> torch.Tensor:
    """(P,S,S,3) f32 voxel coordinates of the planes with bases (P,3,3) at
    offsets (P,): ``((center + u·b0) + v·b1) + off·b2``."""
    grid = plane_grid(s, bases.device)
    uu, vv = torch.meshgrid(grid, grid, indexing="ij")
    b0, b1, b2 = (bases[:, None, None, k] for k in range(3))
    return ((s - 1) / 2.0 + uu[..., None] * b0) + vv[..., None] * b1 + offsets[:, None, None,
                                                                                None] * b2


def _linear_index(idx, size, scan):
    """(in-volume mask, clamped flat index) of integer voxel indices ``idx``
    (one tensor an axis) in a volume of ``size`` (X,Y,Z), or in volume
    ``scan`` of an (N,X,Y,Z) stack."""
    valid = ((idx[0] >= 0) & (idx[0] < size[0]) & (idx[1] >= 0) & (idx[1] < size[1])
             & (idx[2] >= 0) & (idx[2] < size[2]))
    k = [i.clamp(0, n - 1).long() for i, n in zip(idx, size)]
    lin = (k[0] * size[1] + k[1]) * size[2] + k[2]
    if scan is not None:
        lin = lin + scan * (size[0] * size[1] * size[2])
    return valid, lin


def nearest(volume: torch.Tensor, coords: torch.Tensor, scan=None) -> torch.Tensor:
    """The voxels of ``volume`` (X,Y,Z), or of (N,X,Y,Z) with ``scan`` as in
    :func:`trilinear`, at the rounded ``coords`` (half to even), 0 outside:
    ``trilinear`` at rounded coordinates for finite values (every corner
    but the first has weight 0 there)."""
    lead = 0 if scan is None else 1
    valid, lin = _linear_index(torch.round(coords).to(torch.int64).unbind(-1),
                               volume.shape[lead:lead + 3], scan)
    return torch.where(valid, volume.reshape(-1)[lin], 0)


def _as_bases(bases, device) -> torch.Tensor:
    return torch.as_tensor(bases, dtype=torch.float32).to(device)


def make_oblique_sampler(bases):
    """Sampler over k oblique views without view stacks
    (``--no-view-stacks``; JAX :112): sampler(images (N,S,S,S) f32,
    labels (N,S,S,S) int, triples (B,3)) → ((B,S,S,1) f32 trilinear planes
    each divided by its max, (B,S,S,1) int32 nearest label planes). Row
    (scan, view, slice) is the plane at offset ``slice − (S−1)/2`` along
    ``bases[view][2]``. One vectorized ``trilinear`` over the B planes; the
    port of the JAX package's XLA sampler, not a kernel's plain version."""
    def sampler(images, labels, triples):
        s = images.shape[-1]
        tr = triples.long()
        basis = _as_bases(bases, images.device)[tr[:, 1]]
        coords = plane_coords(basis, tr[:, 2].float() - (s - 1) / 2.0, s)
        scan = tr[:, 0, None, None]
        img = normalize_slice(trilinear(images, coords, scan))
        return img[..., None], nearest(labels, coords, scan).int()[..., None]

    return sampler


def oblique_label_planes(labels: torch.Tensor, bases) -> torch.Tensor:
    """(S,S,S) int labels, (V,3,3) bases → (V,S,S,S) int32 nearest label
    planes, plane i of view v at offset ``i − (S−1)/2``: the labels of
    ``make_oblique_sampler`` for every plane."""
    s = labels.shape[-1]
    bases = _as_bases(bases, labels.device)
    v = bases.shape[0]
    offsets = plane_grid(s, labels.device).repeat(v)
    coords = plane_coords(bases.repeat_interleave(s, 0), offsets, s)
    return nearest(labels, coords).int().reshape(v, s, s, s)


def make_oblique_view_stacks(images, labels, bases, device=None):
    """Precomputed oblique view stacks for k-view training (JAX :148):
    (N,S,S,S) images and int labels (numpy or tensors), (V,3,3) bases →
    (vt_images (V,N,S,S,S) f32, vt_labels (V,N,S,S,S) int32 on ``device``,
    nonempty (N,V,S) bool numpy, whether a label plane has foreground).
    ``stack[v, n, i]`` is plane i of view v of scan n, as
    ``make_oblique_sampler`` samples it. Scans go one at a time (as JAX
    does, to bound the peak memory): the image planes of a scan are one
    launch of the oblique-plane kernel on the card (its plain version on the
    CPU), its label planes :func:`oblique_label_planes`."""
    from pmpu_tpu_torch.ops.cuda.oblique_gather import oblique_planes

    device = torch.device(device) if device is not None else (
        images.device if torch.is_tensor(images) else torch.device("cpu"))
    bases = _as_bases(bases, device)
    n, s, v = images.shape[0], images.shape[-1], bases.shape[0]
    vt_images = torch.empty((v, n, s, s, s), dtype=torch.float32, device=device)
    vt_labels = torch.empty((v, n, s, s, s), dtype=torch.int32, device=device)
    for i in range(n):
        vol = torch.as_tensor(images[i]).to(device, torch.float32)
        vt_images[:, i] = oblique_planes(vol, bases).view(v, s, s, s)
        vt_labels[:, i] = oblique_label_planes(torch.as_tensor(labels[i]).to(device), bases)
    nonempty = (vt_labels.amax(dim=(3, 4)) > 0).permute(1, 0, 2).cpu().numpy()
    return vt_images, vt_labels, nonempty


def oblique_nonempty_table(labels, bases) -> np.ndarray:
    """(N,V,S) bool: whether the label plane of (scan, view, offset) has
    foreground (JAX :196), for ``--no-view-stacks``; ``labels`` (N,S,S,S)
    numpy or a tensor, computed where it lies, one scan at a time."""
    rows = []
    for i in range(labels.shape[0]):
        planes = oblique_label_planes(torch.as_tensor(labels[i]), bases)
        rows.append((planes.amax(dim=(2, 3)) > 0).cpu().numpy())
    return np.stack(rows)


def view_basis(normal) -> np.ndarray:
    """Right-handed orthonormal (u, v, n) basis for a unit view axis ``n``."""
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    helper = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(helper, n)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    return np.stack([u, v, n]).astype(np.float32)


def fibonacci_views(k: int) -> np.ndarray:
    """k unit axes about uniform on the half sphere (golden spiral); k = 3
    gives the standard axes."""
    if k == 3:
        return np.eye(3, dtype=np.float32)
    i = np.arange(k, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - i / k)
    theta = np.pi * (1.0 + 5**0.5) * i
    pts = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=1
    )
    return pts.astype(np.float32)


def trilinear(volume: torch.Tensor, coords: torch.Tensor, scan=None) -> torch.Tensor:
    """Trilinear interpolation of ``volume`` (X,Y,Z) or class-last
    (X,Y,Z,C) at ``coords`` (..., 3) in voxel units, zero outside the
    volume → (...) or (..., C). The classes share coordinates and weights,
    so one gather per corner fetches all of them. With ``scan`` (int64,
    broadcasting against ``coords[..., 0]``) ``volume`` is an (N,X,Y,Z)
    stack and each point reads volume ``scan``."""
    lead = 0 if scan is None else 1
    size = volume.shape[lead:lead + 3]
    chans = volume.shape[lead + 3:]
    flat = volume.reshape((-1,) + tuple(chans))
    c0f = torch.floor(coords)
    frac = coords - c0f
    c0 = c0f.to(torch.int32)
    fx, fy, fz = frac.unbind(-1)
    out = torch.zeros(coords.shape[:-1] + chans, dtype=volume.dtype, device=volume.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                valid, lin = _linear_index(
                    [c0[..., a] + d for a, d in enumerate((dx, dy, dz))], size, scan)
                vals = flat[lin]
                w = (fx if dx else 1 - fx) * (fy if dy else 1 - fy) * (fz if dz else 1 - fz)
                if chans:
                    valid, w = valid[..., None], w[..., None]
                out = out + w * torch.where(valid, vals, 0.0)
    return out


def plane_grid(size: int, device=None) -> torch.Tensor:
    """(size,) f32 in-plane grid ``arange(size) − (size−1)/2``."""
    return torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0


def oblique_plane(volume: torch.Tensor, basis: torch.Tensor, offset) -> torch.Tensor:
    """Sample the plane at signed distance ``offset`` from the cube's center
    along basis row 2 (the view normal), spanned by basis rows 0 and 1 →
    (S,S) f32. With the x-axis basis (``view_basis([1,0,0])``) the plane at
    offset ``i − (S−1)/2`` is ``volume[i]`` exactly."""
    s = volume.shape[0]
    basis = torch.as_tensor(basis, dtype=torch.float32, device=volume.device)
    offset = torch.as_tensor(offset, dtype=torch.float32, device=volume.device)
    return trilinear(volume, plane_coords(basis[None], offset[None], s)[0])
