"""The slice-parallel evaluator's collective and its writer guard
(counterpart of the ``with_sharding_constraint`` of
``pmpu_tpu/inference/engine.py:459-466``, after which XLA all-gathers the
slab's logits for the fusion).

* :func:`gather_blocks` — the ranks' blocks of rows, of different lengths,
  concatenated in rank order on every rank of a group (the world, a
  mesh's data column or its model row): each block padded to the
  longest (``all_gather`` needs equal sizes), gathered in f32 so that no
  rounding point moves, and cut back. NCCL gathers on the card; gloo on
  the host, so a CUDA tensor goes through host memory.
* :func:`is_lead` — rank 0, the one rank that writes files (predictions,
  uncertainty maps, the int8 scale file): two ranks replacing one file at
  once is a race.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pmpu_tpu_torch.parallel.mesh import world


def is_lead() -> bool:
    """True on rank 0 of the default process group, and without one."""
    return world()[0] == 0


def gather_blocks(local: torch.Tensor, counts, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``local`` along ``dim`` concatenated in rank order, on
    every rank of ``group`` (default: the whole world): its rank r holds
    ``counts[r]`` rows there (0 allowed), the other axes equal on every
    rank. The result has ``local``'s dtype and device; the exchange runs in
    f32; the result is contiguous. Without a process group, or in a group
    of one rank, it is ``local``."""
    if world()[1] == 1:
        return local
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if size == 1:
        return local
    if len(counts) != size or local.shape[dim] != counts[rank]:
        raise ValueError(f"rank {rank} holds {local.shape[dim]} rows along dim {dim}, "
                         f"the counts {list(counts)} of {size} ranks say otherwise")
    longest = max(counts)
    x = local.movedim(dim, 0).float()
    if x.shape[0] < longest:
        x = torch.cat([x, x.new_zeros((longest - x.shape[0],) + x.shape[1:])])
    on_host = dist.get_backend(group) != "nccl" and x.is_cuda
    x = (x.cpu() if on_host else x).contiguous()
    blocks = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(blocks, x, group=group)
    out = torch.cat([blk[:n] for blk, n in zip(blocks, counts)])
    return out.to(local.device, local.dtype).movedim(0, dim).contiguous()
