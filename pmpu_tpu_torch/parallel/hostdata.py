"""Per-rank sharded data (counterpart of ``pmpu_tpu/parallel/hostdata.py``).

* :func:`host_volume_names` / :func:`load_host_store` — a rank's
  round-robin share of the dataset's volumes, padded to the cube of the
  whole dataset (:func:`global_cube`, read from the NIfTI headers alone),
  so that every rank's stacks have one shape.
* :class:`ShardedTripleBatcher` — the epoch batches of ``--sharded-volumes``:
  (scan, view, slice) rows with global scan ids partitioned by the shard
  that owns each scan (a contiguous block of ``n_volumes // n_shards``),
  scan ids made local to the shard, shuffled per shard and laid out shard
  after shard. numpy only, the JAX package's arithmetic: the same rows, the
  same order for one seed.
* :func:`make_global_batch` — every rank's rows gathered into the global
  batch (an ``all_gather``; the training path never needs it, each rank
  keeps its own rows).

The directory scans take the NIfTI names only (``nifti.is_nifti_name``),
as ``VolumeStore.from_dirs`` does.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.parallel.mesh import world


def _nifti_names(imgs_dir) -> list:
    return sorted(filter(nifti.is_nifti_name, os.listdir(imgs_dir)))


def host_volume_names(all_names, process_index: int | None = None,
                      process_count: int | None = None) -> list:
    """Round-robin share of the sorted volume names for one rank (default:
    this one of the world). Every rank passes the same names; the shares
    are disjoint and together the dataset."""
    rank, size = world()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    return sorted(all_names)[pi::pc]


def global_cube(imgs_dir: str, names=None) -> int:
    """The pad-to-cube size of the whole dataset, from the headers alone."""
    names = sorted(names if names is not None else _nifti_names(imgs_dir))
    return int(max(max(nifti.read_header(os.path.join(imgs_dir, n)).shape[:3]) for n in names))


def load_host_store(imgs_dir: str, masks_dir: str, process_index: int | None = None,
                    process_count: int | None = None):
    """This rank's share of the dataset as a ``VolumeStore`` padded to the
    global cube."""
    from pmpu_tpu_torch.data.volumes import VolumeStore

    all_names = _nifti_names(imgs_dir)
    mine = host_volume_names(all_names, process_index, process_count)
    if not mine:
        raise ValueError(f"host {process_index}/{process_count}: no volumes "
                         f"(dataset has {len(all_names)})")
    return VolumeStore.from_dirs(imgs_dir, masks_dir, names=mine,
                                 cube=global_cube(imgs_dir, all_names))


class ShardedTripleBatcher:
    """Epoch batching of a volume pool sharded over ``n_shards`` (JAX :81).

    ``pad=False`` (training): drop-last over the smallest shard, so a step
    count of ``min(shard rows) // per_shard``. ``pad=True`` (validation):
    each shard's rows cycled up to the longest shard's count, and a shard
    with no rows runs the sentinel row (0, 0, 0); ``shard_real_rows`` (the
    rows before padding) weighs each shard's metrics, so such a shard
    weighs 0. Steps are then ``ceil(min / per_shard)``, the last batch
    wrapping around the permutation."""

    def __init__(self, triples: np.ndarray, n_volumes: int, n_shards: int, pad: bool = False):
        if n_volumes % n_shards:
            raise ValueError(f"{n_volumes} volumes not divisible by {n_shards} shards")
        self.n_shards = n_shards
        self.pad = pad
        self.vols_per_shard = n_volumes // n_shards
        triples = np.asarray(triples)
        owner = triples[:, 0] // self.vols_per_shard
        self.shard_rows = []
        for k in range(n_shards):
            rows = triples[owner == k].copy()
            rows[:, 0] -= k * self.vols_per_shard
            self.shard_rows.append(rows)
        self.shard_real_rows = np.array([len(r) for r in self.shard_rows], np.float32)
        if pad:
            target = max(max(len(r) for r in self.shard_rows), 1)
            padded = []
            for rows in self.shard_rows:
                if len(rows) == 0:
                    rows = np.zeros((target, 3), np.int32)
                elif len(rows) < target:
                    reps = -(-target // len(rows))
                    rows = np.tile(rows, (reps, 1))[:target]
                padded.append(rows)
            self.shard_rows = padded

    def steps_per_epoch(self, per_shard: int) -> int:
        m = min(len(r) for r in self.shard_rows)
        if self.pad:
            return -(-m // per_shard)
        return m // per_shard

    def epoch_batches(self, per_shard: int, rng: np.random.Generator):
        """Yield (n_shards · per_shard, 3) int32 arrays, shard after shard."""
        perms = [rng.permutation(len(r)) for r in self.shard_rows]
        for i in range(self.steps_per_epoch(per_shard)):
            idx = np.arange(i * per_shard, (i + 1) * per_shard)
            chunks = [
                self.shard_rows[k][perms[k].take(idx, mode="wrap") if self.pad
                                   else perms[k][idx]]
                for k in range(self.n_shards)
            ]
            yield np.concatenate(chunks).astype(np.int32)


def make_global_batch(local_rows) -> np.ndarray:
    """Every rank's (B_local, ...) rows, equal in shape on every rank,
    concatenated in rank order into the (B_local · world, ...) batch (an
    ``all_gather`` over the default group; the rows themselves without
    one)."""
    rows = np.ascontiguousarray(local_rows)
    if world()[1] == 1:
        return rows
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    t = torch.from_numpy(rows).to(dev)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.cat(out).cpu().numpy()
