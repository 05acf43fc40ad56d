"""Multi-rank train and eval steps (counterpart of
``pmpu_tpu/parallel/sharding.py``: ``make_dp_train_step`` :74,
``make_hostlocal_dp_train_step`` :117, ``make_hostlocal_eval_step`` :163).

Both train steps are ``train/steps.py::make_train_step`` with a
``parallel`` object that says which rows of a microbatch this rank runs
and how the step is reduced over the ranks. Each reduces with one
``all_reduce`` a step, over one flat f32 buffer (the gradients after
accumulation, then what else the step reduces, then the loss terms and the
interrupt flag), before the clip; XLA fuses the JAX package's ``pmean`` of
the tree the same way.

* **Data parallel** (:func:`make_dp_train_step`, ``--data-parallel``): the
  JAX step is the one-device step on the global batch, so this one is too.
  Every rank holds the whole view stacks and the global (scan, view,
  slice) rows; each microbatch of ``micro`` rows is split over the ranks
  as ``torch.tensor_split`` splits it (:func:`~pmpu_tpu_torch.parallel.mesh.data_sharding`;
  a rank may hold no rows, and still joins every collective). The
  posterior eps and the augmentation draws are drawn for the whole
  microbatch from one generator that is equal on every rank, and each rank
  takes its rows of them. BatchNorm runs on the microbatch's statistics
  (:class:`BatchShare` in ``models/unet.py::BatchNorm2d``, the f32 E[x] and
  E[x²] all-reduced as count-weighted sums in one autograd node whose
  backward all-reduces their gradients), so the running
  statistics are the global batch's and equal on every rank. Each rank's
  loss is its additive share of the global loss (:class:`BatchShare`:
  a mean over the batch becomes the local mean times the rank's fraction of
  the rows; ``Σce / Σw`` takes the global ``Σw``; a Dice loss is computed
  from all-reduced sums and divided by the world), so the gradients and
  the loss terms are all-reduced by **sum**.
* **Host-local** (:func:`make_hostlocal_dp_train_step`,
  ``--sharded-volumes``): each rank runs the ordinary step on its own block
  of volumes (the plain stack and ``sample_batch``, as the JAX step's
  ``shard_map`` body), BatchNorm on its local statistics, drawing from its
  own generator (the loop seeds it by ``(seed, rank)``, :func:`rank_seed`,
  as JAX folds the key by the shard index); the gradients, the BatchNorm
  running statistics and the loss terms are all-reduced to their **mean**
  (JAX's "sync-BN by averaging" is of the running statistics only).
* :func:`make_hostlocal_eval_step`: each rank's validation loss and
  per-class Dice weighed by its real rows (``ShardedTripleBatcher.shard_real_rows``)
  in one all-reduce: a shard of pad rows only weighs 0.
* :func:`sum_values`: host values summed over the ranks (the loop's
  data-parallel validation sums, its interrupt flag at an epoch's end).

In a world of 1 (no process group needed) nothing is reduced: both train
steps are then the one-device step.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from pmpu_tpu_torch.data.sampler import sample_batch
from pmpu_tpu_torch.models.unet import BatchNorm2d
from pmpu_tpu_torch.ops.metrics import per_class_dice
from pmpu_tpu_torch.parallel.mesh import Mesh, data_sharding, world
from pmpu_tpu_torch.train.steps import make_train_step


def rank_seed(seed: int, rank: int, step: int = 0) -> int:
    """The generator seed of rank ``rank`` in a run seeded by ``seed``
    (``--sharded-volumes``: independent draws on each rank), from ``step``
    on (a resumed run)."""
    return int(np.random.SeedSequence((seed, rank, step)).generate_state(1, np.uint64)[0])


def _check_world(mesh: Mesh) -> int:
    rank, size = world()
    if mesh.size != size:
        raise ValueError(f"the mesh spans {mesh.size} ranks, the world has {size}")
    return rank


class BatchShare:
    """This rank's ``n_local`` of a batch of ``n_global`` rows split over
    the ranks of the default process group."""

    def __init__(self, n_local: int, n_global: int):
        self.frac = n_local / n_global
        self.world = world()[1]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's additive share of the global batch's mean of ``x``
        (x over this rank's rows): the local mean times the rank's fraction
        of the rows, 0 without rows."""
        return (x.mean() if x.numel() else x.sum()) * self.frac

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, with gradients to every rank's ``x``."""
        return _AllReduceSum.apply(x)[0]

    def whole(self, value: torch.Tensor) -> torch.Tensor:
        """This rank's share of a value that every rank computes alike from
        :meth:`total` sums."""
        return value / self.world

    def batch_moments(self, x: torch.Tensor, dim) -> tuple:
        """The global batch's E[x] and E[x²] over ``dim`` (dim 0 the rows), in
        one all-reduce of the count-weighted local moments (computed in the
        order of the unsynchronized BatchNorm, which keeps its backward's
        order of summation: at world 1 the gradients are bit-equal)."""
        def local(t):
            return (t.mean(dim=dim) if t.numel() else t.sum(dim=dim)) * self.frac

        m1 = local(x)
        return _AllReduceSum.apply(m1, local(x * x))


class _AllReduceSum(torch.autograd.Function):
    """Tensors of one shape summed over the ranks in one all-reduce, each
    output's gradient the ranks' sum of the gradients (one node, so that
    the graph around it keeps the order of the unsynchronized one). Without
    a process group the sum is over this process alone."""

    @staticmethod
    def forward(ctx, *xs):
        buf = torch.stack(xs)
        _sum_over_ranks(buf)
        return tuple(t.clone() for t in buf.unbind())

    @staticmethod
    def backward(ctx, *grads):
        buf = torch.stack(grads)
        _sum_over_ranks(buf)
        return buf.unbind()


def _sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks in place (an all-reduce); nothing in a
    world of 1, which needs no process group."""
    if world()[1] > 1:
        dist.all_reduce(t)
    return t


@contextlib.contextmanager
def synced_batchnorm(net: torch.nn.Module, share: BatchShare):
    """The train-mode BatchNorms of ``net`` normalize with the global
    batch's statistics inside (``BatchNorm2d.sync``)."""
    bns = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.sync = share
    try:
        yield
    finally:
        for m in bns:
            del m.sync  # back to the class's None


def _all_reduce_step(state, tensors, metrics: dict, stop: bool, mean: bool) -> dict:
    """One all-reduce (sum) of the present gradients of ``state``, then
    ``tensors``, then ``metrics`` and the interrupt flag, over one flat f32
    buffer; ``mean`` divides by the world. The reduced values are written
    back; returns the metrics with ``"stop"`` (1.0 when a rank was
    interrupted)."""
    grads = [p.grad for p in state.params if p.grad is not None]
    keys = sorted(metrics)
    device = grads[0].device
    flags = torch.stack([*(metrics[k].float() for k in keys),
                         torch.tensor(float(bool(stop)), device=device)])
    parts = [*grads, *tensors]
    flat = torch.cat([t.reshape(-1).float() for t in parts] + [flags])
    _sum_over_ranks(flat)
    size = world()[1]
    if mean and size > 1:
        flat /= size
    with torch.no_grad():
        for t, v in zip(parts, flat.split([t.numel() for t in parts] + [len(keys) + 1])):
            t.copy_(v.view_as(t))
    out = flat[flat.numel() - len(keys) - 1:]
    reduced = dict(zip(keys, out[:-1]))
    reduced["stop"] = (out[-1] > 0).float()
    return reduced


class _DataParallel:
    """``make_train_step``'s ``parallel`` for the data-parallel step."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.rank = _check_world(mesh)

    def take(self, x):
        """This rank's rows of a microbatch-sized tensor."""
        return x[data_sharding(self.mesh, x.shape[0], self.rank)]

    def share(self, micro: int) -> BatchShare:
        rows = data_sharding(self.mesh, micro, self.rank)
        return BatchShare(rows.stop - rows.start, micro)

    def context(self, net, share):
        return synced_batchnorm(net, share)

    def reduce(self, state, metrics, stop):
        # the running statistics came from all-reduced batch statistics:
        # they are equal on every rank already
        return _all_reduce_step(state, [], metrics, stop, mean=False)


class _HostLocal:
    """``make_train_step``'s ``parallel`` for the host-local step."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        _check_world(mesh)

    def take(self, x):
        return x

    def share(self, micro: int):
        return None

    def context(self, net, share):
        return contextlib.nullcontext()

    def reduce(self, state, metrics, stop):
        return _all_reduce_step(state, list(state.net.buffers()), metrics, stop, mean=True)


def make_dp_train_step(task, mesh: Mesh, acc_steps: int = 1, sampler=sample_batch,
                       augment=None, remat: bool = False):
    """The data-parallel train step: ``step(state, images, labels, triples,
    lr, eps=None, draws=None, stop=False) → (state, metrics)`` with the
    whole stacks and the global (acc_steps·micro, 3) rows on every rank;
    ``eps`` and ``draws`` (injected) are the global microbatches' too.
    ``metrics`` are the global step's, plus ``"stop"``."""
    return make_train_step(task, acc_steps=acc_steps, sampler=sampler, augment=augment,
                           remat=remat, parallel=_DataParallel(mesh))


def make_hostlocal_dp_train_step(task, mesh: Mesh, acc_steps: int = 1, augment=None,
                                 remat: bool = False):
    """The host-local train step: ``step(state, images, labels, triples, lr,
    eps=None, draws=None, stop=False)`` with this rank's (N/world,S,S,S)
    volume block and its (per_shard, 3) rows with block-local scan ids;
    ``eps`` and ``draws`` this rank's. ``metrics`` are the ranks' mean,
    plus ``"stop"``."""
    return make_train_step(task, acc_steps=acc_steps, sampler=sample_batch, augment=augment,
                           remat=remat, parallel=_HostLocal(mesh))


def make_hostlocal_eval_step(task, mesh: Mesh):
    """``step(state, images, labels, triples, weight, eps=None) → (loss,
    per-class Dice, preds, img, msk)``: this rank's validation rows from its
    volume block; the loss and the Dice are the ranks' weighted mean with
    ``weight`` this rank's real rows (one all-reduce), preds, img and msk
    this rank's."""
    _check_world(mesh)

    @torch.no_grad()
    def step(state, images, labels, triples, weight, eps=None):
        img, msk = sample_batch(images, labels, triples)
        loss, preds = task.val_loss(img, msk, state.generator, eps)
        dice = per_class_dice(preds, msk, task.n_classes)
        w = float(weight)
        buf = torch.cat([(loss.float() * w).reshape(1), dice.float() * w,
                         torch.tensor([w], device=dice.device)])
        _sum_over_ranks(buf)
        denom = buf[-1] + 1e-12
        return buf[0] / denom, buf[1:-1] / denom, preds, img, msk

    return step


def sum_values(values) -> np.ndarray:
    """The f64 ``values`` summed over the ranks, on every rank (one
    all-reduce; NCCL's on this rank's card, gloo's on the host)."""
    arr = np.asarray(values, np.float64)
    if world()[1] == 1:
        return arr
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    t = torch.from_numpy(arr.copy()).to(dev)
    dist.all_reduce(t)
    return t.cpu().numpy()
