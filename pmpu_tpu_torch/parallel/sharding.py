"""The sharding rules and the multi-rank train and eval steps (counterpart
of ``pmpu_tpu/parallel/sharding.py``: ``param_spec`` :23,
``make_param_shardings`` :35, ``make_state_shardings`` :47,
``shard_state`` :68, ``make_dp_train_step`` :74,
``make_hostlocal_dp_train_step`` :117, ``make_hostlocal_eval_step`` :163).

* **The rules**: :func:`param_spec` gives each state_dict tensor its spec
  in torch layout (``("model", None, None, None)``, ``("model",)`` or
  ``()``, JAX's ``PartitionSpec`` with the exported tensor's axes);
  :func:`make_state_shardings` mirrors the parameters' specs on the SGD
  momentum buffers and replicates the step and the generator;
  :func:`shard_state` cuts this rank's slices of a whole ``TrainState``
  (``parallel/tensor.py::tensor_parallel``) and :func:`gather_state` builds the
  whole state back on every rank (what a checkpoint writes).

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

* **Tensor parallel** (:func:`make_dp_train_step` on a mesh of ``model >
  1``; no CLI flag, as JAX's loop builds its meshes with ``model=1``): the
  state is channel-sharded over each model row (:func:`shard_state`); the
  rows of a microbatch are split by data index, so every rank of a data
  row runs the same rows with the same eps and augmentation draws; the
  BatchNorm moments, the loss shares and the gradients (each rank its own
  slices) are summed over the data column only; the clip stays elementwise
  (``optax.clip(0.1)``), so no norm crosses a row; the metrics are then
  equal on every rank, and the interrupt flag is summed over the row too.
  The host-local steps require ``model == 1``: JAX's loop builds their
  mesh with ``model=1`` (``pmpu_tpu/train/loop.py:140``).

In a world of 1 (no process group needed) nothing is reduced: both train
steps are then the one-device step.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from pmpu_tpu_torch.data.sampler import sample_batch
from pmpu_tpu_torch.models.unet import BatchNorm2d
from pmpu_tpu_torch.ops.metrics import per_class_dice
from pmpu_tpu_torch.parallel.mesh import Mesh, data_sharding, world
from pmpu_tpu_torch.parallel.tensor import (
    gather_dim0,
    gather_module,
    is_tensor_parallel,
    model_block,
    tensor_parallel,
)
from pmpu_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step


def param_spec(shape, model_size: int, min_channels: int = 64) -> tuple:
    """The spec of one state_dict tensor (JAX :23 on the exported tree): dim
    0 of a 4-D kernel or of a 1-D tensor sharded over ``model`` when it is
    divisible by ``model_size`` and at least ``min_channels`` wide; ``()``
    replicates. ``export_torch_state_dict`` maps every kernel by
    ``transpose(3, 2, 0, 1)``, so JAX's last axis is dim 0 here: a conv's
    output channels, a transposed conv's input channels."""
    if len(shape) in (1, 4) and shape[0] % model_size == 0 and shape[0] >= min_channels:
        return ("model",) + (None,) * (len(shape) - 1)
    return ()


def make_param_shardings(state_dict, mesh: Mesh, min_channels: int = 64) -> dict:
    """{name: spec} of a whole state_dict (the parameters and the BatchNorm
    statistics: JAX's params and batch_stats); all ``()`` with ``model == 1``."""
    return {k: () if mesh.model == 1 else param_spec(tuple(v.shape), mesh.model, min_channels)
            for k, v in state_dict.items()}


@dataclass(frozen=True)
class StateShardings:
    """The specs of a ``TrainState`` (:func:`make_state_shardings`); its
    step and generator are replicated."""

    mesh: Mesh
    min_channels: int
    net: dict  # state_dict name → spec
    momentum: dict  # parameter name → spec (its parameter's)


def make_state_shardings(state, mesh: Mesh, min_channels: int = 64) -> StateShardings:
    """The specs of a whole ``TrainState``: parameters and BatchNorm
    statistics by the rule, each momentum buffer its parameter's; the step
    and the generator replicated (JAX :47)."""
    if is_tensor_parallel(state.net) is not None:
        raise ValueError("make_state_shardings takes the whole state; this one is sharded")
    net = make_param_shardings(state.net.state_dict(), mesh, min_channels)
    momentum = {n: net[n] for n, p in state.net.named_parameters() if p.requires_grad}
    return StateShardings(mesh, min_channels, net, momentum)


def _momentum(state) -> list:
    """(name, parameter, its momentum buffer or None) in parameter order."""
    names = {p: n for n, p in state.net.named_parameters()}
    return [(names[p], p, state.optimizer.state.get(p, {}).get("momentum_buffer"))
            for p in state.params]


def shard_state(state, shardings: StateShardings):
    """This rank's slices of a whole ``TrainState``, in place (the network
    through ``tensor.tensor_parallel``, each sharded momentum buffer cut
    like its parameter); returns it."""
    mesh = shardings.mesh
    if mesh.model == 1:
        return state
    tensor_parallel(state.net, mesh, shardings.min_channels)
    for name, p, buf in _momentum(state):
        if buf is not None and shardings.momentum[name]:
            state.optimizer.state[p]["momentum_buffer"] = model_block(buf, mesh, 0).clone()
    return state


def gather_state(state, shardings: StateShardings) -> TrainState:
    """The whole ``TrainState`` of a sharded one, on every rank (a
    collective of the mesh): a copy of the network with every sharded
    tensor gathered, SGD at the same momentum and learning rate with the
    gathered momentum buffers, a copy of the generator, the step. Bit-equal
    to the state that :func:`shard_state` cut."""
    if shardings.mesh.model == 1:
        return state
    net = gather_module(state.net, shardings.net)
    group = state.optimizer.param_groups[0]
    optimizer = make_optimizer([p for p in net.parameters() if p.requires_grad],
                               group["momentum"], group["lr"])
    whole = dict(net.named_parameters())
    for name, _, buf in _momentum(state):
        if buf is not None:
            buf = gather_dim0(buf, shardings.mesh) if shardings.momentum[name] else buf.clone()
            optimizer.state[whole[name]]["momentum_buffer"] = buf
    generator = torch.Generator(device=state.generator.device)
    generator.set_state(state.generator.get_state())
    return TrainState(net, optimizer, generator, state.step)


def rank_seed(seed: int, rank: int, step: int = 0) -> int:
    """The generator seed of rank ``rank`` in a run seeded by ``seed``
    (``--sharded-volumes``: independent draws on each rank), from ``step``
    on (a resumed run)."""
    return int(np.random.SeedSequence((seed, rank, step)).generate_state(1, np.uint64)[0])


def _check_world(mesh: Mesh) -> int:
    """This rank's data index on ``mesh``, which must span the world."""
    size = world()[1]
    if mesh.size != size:
        raise ValueError(f"the mesh spans {mesh.size} ranks, the world has {size}")
    return mesh.data_index


class BatchShare:
    """This rank's ``n_local`` of a batch of ``n_global`` rows split over
    the ranks of ``group`` (None: the default process group) of ``size``
    ranks (None: the world's)."""

    def __init__(self, n_local: int, n_global: int, group=None, size: int | None = None):
        self.frac = n_local / n_global
        self.group = group
        self.world = world()[1] if size is None else size

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's additive share of the global batch's mean of ``x``
        (x over this rank's rows): the local mean times the rank's fraction
        of the rows, 0 without rows."""
        return (x.mean() if x.numel() else x.sum()) * self.frac

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, with gradients to every rank's ``x``."""
        return _AllReduceSum.apply(self.group, x)[0]

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
        return _AllReduceSum.apply(self.group, m1, local(x * x))


class _AllReduceSum(torch.autograd.Function):
    """Tensors of one shape summed over the ranks in one all-reduce, each
    output's gradient the ranks' sum of the gradients (one node, so that
    the graph around it keeps the order of the unsynchronized one), over the
    ranks of ``group`` (None: the default process group). Without a process
    group the sum is over this process alone."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        buf = torch.stack(xs)
        _sum_over_ranks(buf, group)
        return tuple(t.clone() for t in buf.unbind())

    @staticmethod
    def backward(ctx, *grads):
        buf = torch.stack(grads)
        _sum_over_ranks(buf, ctx.group)
        return (None, *buf.unbind())


def _sum_over_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (None: the default process
    group) in place (an all-reduce); nothing over one rank, which needs no
    process group."""
    if (world()[1] if group is None else dist.get_world_size(group)) > 1:
        dist.all_reduce(t, group=group)
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


def _all_reduce_step(state, tensors, metrics: dict, stop: bool, mean: bool,
                     group=None) -> dict:
    """One all-reduce (sum) over ``group`` (None: the default process group)
    of the present gradients of ``state``, then ``tensors``, then
    ``metrics`` and the interrupt flag, over one flat f32 buffer; ``mean``
    divides by the world. The reduced values are written back; returns the
    metrics with ``"stop"`` (1.0 when a rank was interrupted)."""
    grads = [p.grad for p in state.params if p.grad is not None]
    keys = sorted(metrics)
    device = grads[0].device
    flags = torch.stack([*(metrics[k].float() for k in keys),
                         torch.tensor(float(bool(stop)), device=device)])
    parts = [*grads, *tensors]
    flat = torch.cat([t.reshape(-1).float() for t in parts] + [flags])
    _sum_over_ranks(flat, group)
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
        self.index = _check_world(mesh)

    def take(self, x):
        """This data index's rows of a microbatch-sized tensor."""
        return x[data_sharding(self.mesh, x.shape[0], self.index)]

    def share(self, micro: int) -> BatchShare:
        rows = data_sharding(self.mesh, micro, self.index)
        return BatchShare(rows.stop - rows.start, micro, self.mesh.data_group, self.mesh.data)

    def context(self, net, share):
        return synced_batchnorm(net, share)

    def reduce(self, state, metrics, stop):
        # the running statistics came from all-reduced batch statistics:
        # they are equal on every rank already
        out = _all_reduce_step(state, [], metrics, stop, mean=False, group=self.mesh.data_group)
        if self.mesh.model > 1:  # a stop on any rank of the row
            out["stop"] = (_sum_over_ranks(out["stop"].clone(), self.mesh.model_group) > 0).float()
        return out


class _HostLocal:
    """``make_train_step``'s ``parallel`` for the host-local step."""

    def __init__(self, mesh: Mesh):
        _require_data_only(mesh, "make_hostlocal_dp_train_step")
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


def _require_data_only(mesh: Mesh, what: str):
    if mesh.model != 1:
        raise NotImplementedError(
            f"{what}: model={mesh.model}: the host-local steps run on a mesh of model=1 "
            "(JAX's loop builds theirs with make_mesh(), pmpu_tpu/train/loop.py:140)")


def make_dp_train_step(task, mesh: Mesh, acc_steps: int = 1, sampler=sample_batch,
                       augment=None, remat: bool = False):
    """The data-parallel train step: ``step(state, images, labels, triples,
    lr, eps=None, draws=None, stop=False) → (state, metrics)`` with the
    whole stacks and the global (acc_steps·micro, 3) rows on every rank;
    ``eps`` and ``draws`` (injected) are the global microbatches' too.
    ``metrics`` are the global step's, plus ``"stop"``. On a mesh of
    ``model > 1`` the task's network must be channel-sharded over it
    (``shard_state(state, make_state_shardings(state, mesh,
    min_channels))``, as JAX's ``jit_for(state)`` is followed by
    ``shard_state``)."""
    layout = is_tensor_parallel(task.net)
    if mesh.model > 1 and (layout is None or layout[0] != mesh):
        raise ValueError(
            f"make_dp_train_step on a {mesh.data}x{mesh.model} mesh: the network is not "
            "channel-sharded over it; shard_state(state, make_state_shardings(state, mesh, "
            "min_channels)) first")
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
    _require_data_only(mesh, "make_hostlocal_eval_step")
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
