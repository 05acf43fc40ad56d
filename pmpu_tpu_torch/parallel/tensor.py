"""Tensor parallelism over the mesh's ``model`` axis (counterpart of the
channel-sharded state that ``pmpu_tpu/parallel/sharding.py::make_dp_train_step``
:94-103 gives XLA, which then inserts the collectives itself).

Torch inserts none, so they are placed here by hand, as conjugate autograd
functions over the mesh's model row (``Mesh.model_group``):

* :func:`copy_to_model` — forward the identity, backward an all-reduce: a
  whole activation entering a conv whose output channels are sharded (its
  gradient from this rank is only its block of output channels' share).
* :func:`gather_channels` — forward an all-gather of the ranks' channel
  blocks, backward this rank's block of the gradient; with
  ``reduce_grad`` the gradient is all-reduced first (a reduce-scatter,
  which gloo lacks): the gathered activation then enters a conv whose
  output channels are sharded, and the all-reduce is that conv's
  :func:`copy_to_model`.
* :func:`reduce_partial` — forward an all-reduce of partial sums, backward
  the identity: a transposed conv whose input channels are sharded.

Every whole activation's gradient is whole and equal on each rank of the
row, and a block's is whole for the block: each partial gradient is summed
exactly once, at the copy or the gather that made the whole activation the
sharded conv read.

:func:`tensor_parallel` turns a ``UNet`` or ``ProbabilisticUNet`` into this
rank's share of it, in place: each tensor that the sharding rule shards
(``parallel/sharding.py::param_spec``: dim 0 of a 4-D kernel, a 1-D tensor)
becomes this rank's block of it, under the same name (``state_dict()`` keys
still map onto JAX's tree), and the modules that read them change class:

* ``Conv2d`` — output channels sharded: it reads the whole input (gathered
  or copied) and writes its block of channels, which the BatchNorm and ReLU
  after it keep; replicated: it reads the whole input (gathered without a
  reduction). A conv outside an ``nn.Sequential`` is a head (``OutConv``,
  the μ/log σ conv, the fcomb's last layer): its output leaves whole.
* ``ConvTranspose2d`` — input channels sharded (JAX shards dim 0 of the
  exported kernel): its block of input channels makes a partial sum of
  every output channel, reduced over the row; a sharded bias is added by
  its owner before the reduction, a replicated one after it.
* ``Up`` — its skip input is gathered whole before the concatenation.
* ``UNet`` — its output (the probunet's features) leaves whole.
* ``BatchNorm2d`` keeps its class: on sharded channels it normalizes its
  block, on replicated ones the whole tensor alike on each rank; in the
  data-parallel step its moments are summed over the data column only.

A channel block's width tells it from the whole tensor: a block of ``c``
channels is ``c / model`` wide.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pmpu_tpu_torch.device import exact_f32_if
from pmpu_tpu_torch.models.unet import Conv2d, ConvTranspose2d, UNet, Up
from pmpu_tpu_torch.parallel.gather import gather_blocks
from pmpu_tpu_torch.parallel.mesh import Mesh


def model_block(t: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (of ``model`` equal blocks)."""
    n = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_index * n, n)


def _like(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out`` (contiguous) in ``x``'s dtype and device, channels_last when
    ``x`` is a 4-D channels_last tensor."""
    out = out.to(x.device, x.dtype)
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the model row, exchanged in f32."""
    buf = x.detach().float().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, group=mesh.model_group)
    return _like(buf, x)


def _all_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The row's blocks of ``x`` concatenated along ``dim`` in model order
    (``gather_blocks`` over the row: f32, through the host under gloo)."""
    counts = [x.shape[dim]] * mesh.model
    return _like(gather_blocks(x.detach(), counts, dim, mesh.model_group), x)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh), None


class _ReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, reduce_grad):
        ctx.mesh, ctx.dim, ctx.reduce_grad = mesh, dim, reduce_grad
        return _all_gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce_grad:
            grad = _all_reduce(grad, ctx.mesh)
        return model_block(grad, ctx.mesh, ctx.dim).contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_partial(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReducePartial.apply(x, mesh)


def gather_channels(x: torch.Tensor, mesh: Mesh, dim: int = 1,
                    reduce_grad: bool = False) -> torch.Tensor:
    return _GatherChannels.apply(x, mesh, dim, reduce_grad)


def whole(x: torch.Tensor, channels: int, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """``x`` with all ``channels`` along ``dim``: gathered when it is this
    rank's block, else as it is."""
    return x if x.shape[dim] == channels else gather_channels(x, mesh, dim)


class TPConv2d(Conv2d):
    """``Conv2d`` on the mesh's model row (``tp_mesh``): its weight and bias
    hold this rank's block of output channels when they are sharded
    (``out_channels`` stays the whole count); ``tp_head``: the output
    leaves whole."""

    @property
    def sharded(self) -> bool:
        return self.weight.shape[0] != self.out_channels

    def _whole_input(self, x):
        if x.shape[1] == self.in_channels:
            return copy_to_model(x, self.tp_mesh) if self.sharded else x
        return gather_channels(x, self.tp_mesh, reduce_grad=self.sharded)

    def forward(self, x):
        y = super().forward(self._whole_input(x))
        return gather_channels(y, self.tp_mesh) if self.tp_head and self.sharded else y

    def forward_split(self, xs):
        """Each of ``xs`` whole (``TPUp`` gathers its skip input)."""
        if self.sharded:
            xs = [copy_to_model(x, self.tp_mesh) for x in xs]
        return super().forward_split(xs)


class TPConvTranspose2d(ConvTranspose2d):
    """``ConvTranspose2d`` on the mesh's model row: a sharded weight holds
    this rank's block of input channels, a sharded bias its block of output
    channels."""

    def forward(self, x):
        mesh = self.tp_mesh
        if self.weight.shape[0] == self.in_channels:  # replicated (so is the bias)
            return super().forward(whole(x, self.in_channels, mesh))
        if x.shape[1] == self.in_channels:
            x = model_block(copy_to_model(x, mesh), mesh)
        w, b = self.weight, self.bias
        cd = self.compute_dtype
        if cd is not None:
            x, w, b = x.to(cd), w.to(cd), b.to(cd)
        with exact_f32_if(x.dtype):
            y = F.conv_transpose2d(x, w, None, stride=2)
        if b.shape[0] == self.out_channels:
            return reduce_partial(y, mesh) + b[:, None, None]
        lo = mesh.model_index * b.shape[0]
        y = y + F.pad(b, (lo, self.out_channels - lo - b.shape[0]))[:, None, None]
        return reduce_partial(y, mesh)


class TPUp(Up):
    """``Up`` whose skip input may arrive as this rank's channel block."""

    def forward(self, x1, x2):
        skip = self.conv.double_conv[0].in_channels - self.up.out_channels
        return super().forward(x1, whole(x2, skip, self.tp_mesh))


class TPUNet(UNet):
    """``UNet`` whose output leaves whole (the probunet's features may end
    as a channel block)."""

    def forward(self, x):
        y = super().forward(x)
        channels = self.outc.conv.out_channels if self.apply_last_layer else self.num_filters[0]
        return whole(y, channels, self.tp_mesh, dim=-1)


_TP = {Conv2d: TPConv2d, ConvTranspose2d: TPConvTranspose2d, Up: TPUp, UNet: TPUNet}
_PLAIN = {v: k for k, v in _TP.items()}


def _heads(net: nn.Module) -> set:
    """The convs that no ``nn.Sequential`` holds."""
    seq = {id(m) for s in net.modules() if isinstance(s, nn.Sequential) for m in s}
    return {m for m in net.modules() if isinstance(m, Conv2d) and id(m) not in seq}


def is_tensor_parallel(net: nn.Module):
    """``(mesh, min_channels)`` of a net made by :func:`tensor_parallel`,
    else None."""
    return getattr(net, "tp_layout", None)


@torch.no_grad()
def tensor_parallel(net: nn.Module, mesh: Mesh, min_channels: int = 64) -> nn.Module:
    """``net`` (whole) made this rank's share of it over ``mesh``'s model
    row, in place, by JAX's rule (``sharding.make_param_shardings`` at
    ``min_channels``): each sharded tensor keeps its object and takes this
    rank's block of dim 0; the modules that read them change class."""
    from pmpu_tpu_torch.parallel.sharding import make_param_shardings

    if is_tensor_parallel(net) is not None:
        raise ValueError("tensor_parallel: the network is already channel-sharded")
    tensors = dict(net.state_dict(keep_vars=True))
    for name, spec in make_param_shardings(tensors, mesh, min_channels).items():
        if spec:
            t = tensors[name]
            t.data = model_block(t.data, mesh, 0).clone()
    heads = _heads(net)
    for m in net.modules():
        if type(m) in _TP:
            m.__class__ = _TP[type(m)]
            m.tp_mesh = mesh
            if isinstance(m, Conv2d):
                m.tp_head = m in heads
    net.tp_layout = (mesh, min_channels)
    return net


def gather_dim0(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The row's blocks of ``t`` along dim 0, whole, on every rank."""
    return _all_gather(t, mesh, 0)


@torch.no_grad()
def gather_module(net: nn.Module, specs: dict) -> nn.Module:
    """A whole copy of a net made by :func:`tensor_parallel`, whose tensors'
    specs are ``specs``: its own classes, every sharded tensor gathered over
    the row (a collective: every rank of the mesh calls it alike)."""
    mesh = is_tensor_parallel(net)[0]
    out = copy.deepcopy(net)
    for p in out.parameters():
        p.grad = None
    tensors = dict(out.state_dict(keep_vars=True))
    for name, spec in specs.items():
        if spec:
            t = tensors[name]
            t.data = gather_dim0(t.data, mesh)
    for m in out.modules():
        if type(m) in _PLAIN:
            m.__class__ = _PLAIN[type(m)]
            del m.tp_mesh
            m.__dict__.pop("tp_head", None)
    del out.tp_layout
    return out
