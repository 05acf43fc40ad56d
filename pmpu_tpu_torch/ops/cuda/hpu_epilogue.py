"""The epilogues of the HPU-Net's residual-block convs: CUDA kernels and
plain versions.

Replaces no TPU kernel (the JAX package has no HPU-Net). In the port each
conv of ``models/hprob_unet.py::ResBlock`` is cuDNN's conv, after which ATen
ran passes of its own over the bf16 activation: the conv's bias add (with
one more launch to cast the bias), the next conv's pre-activation ReLU
(``clamp_min``) and, after the block's 1×1 conv, the skip conv's bias add and
the residual add. The kernels (``csrc/hpu_epilogue.cu``) do that work in one
pass, rounding where ATen's passes round, so their outputs are bit-equal to
theirs:

* ``bias_relu_``: after each 3×3 conv, ``relu(y + bias)`` in place;
* ``residual_``: after the block's 1×1 conv, ``s + (y + bias)`` over ``y``,
  ``s`` the block's input or its 1×1 skip conv's output plus that conv's
  bias, and, with ``relu``, also ``relu`` of the sum into a new tensor (the
  next block's first conv reads it; its residual reads the sum).

They are bound by bytes: 16-byte loads and stores of 8 elements a thread, C
any width whose channels repeat within a block (12 included), the biases in
registers, one wave of blocks.

The route is ``models/hprob_unet.py::run_blocks`` in inference only; f32,
grad enabled, CPU tensors and every output these kernels do not take keep
``ResBlock.forward``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pmpu_tpu_torch.ops.cuda import _build

MAX_PERIOD = 256  # C / gcd(C, 8): the vectors after which a thread's channels repeat


def takes_shape(numel: int, channels: int) -> bool:
    """Whether the kernels take an activation of ``numel`` elements and
    ``channels`` channels: whole 16-byte vectors, under 2^31 − 1 elements
    (ATen's own channels_last path, whose arithmetic they repeat), and a
    channel period that one block holds."""
    return (0 < channels and channels // math.gcd(channels, 8) <= MAX_PERIOD
            and numel % 8 == 0 and numel < 2**31 - 1)


def _takes(y, bias) -> bool:
    c = y.shape[1] if y.dim() == 4 else 0
    return (y.dtype == torch.bfloat16 and takes_shape(y.numel(), c)
            and y.is_contiguous(memory_format=torch.channels_last) and y.data_ptr() % 16 == 0
            and bias.dtype == torch.float32 and bias.shape == (c,)
            and bias.is_contiguous() and bias.get_device() == y.get_device())


def _refuse(name, y):
    raise ValueError(
        f"{name}: the tensors must be CUDA bf16 channels_last (N,C,H,W) activations of one shape, "
        "16-byte aligned, in whole 16-byte vectors under 2^31 - 1 elements, with "
        f"C // gcd(C, 8) <= {MAX_PERIOD}, and the biases (C,) contiguous f32 on their device; "
        f"got {tuple(y.shape)} {y.dtype} on {y.device}")


def bias_relu_reference(y, bias):
    """The plain version: ATen's bias add (the bias cast to ``y``'s dtype)
    into ``y``, then ``torch.relu``; returns the result."""
    return torch.relu(y.add_(bias.to(y.dtype)[:, None, None]))


def residual_reference(y, bias, s, skip_bias=None, relu: bool = False):
    """The plain version: ``s + (y + bias)``, ``s`` plus ``skip_bias`` first
    where given, each an ATen bf16 add as ``ResBlock.forward`` runs them (the
    bias added into ``y``); returns (the sum, its ReLU with ``relu`` or
    None)."""
    t = y.add_(bias.to(y.dtype)[:, None, None])
    if skip_bias is not None:
        s = s + skip_bias.to(s.dtype)[:, None, None]
    out = s + t
    return out, torch.relu(out) if relu else None


def bias_relu_(y, bias):
    """``relu(y + bias)`` in place over a CUDA ``y`` (returned), by the plain
    version on the CPU. For grad-free use (the route's own condition). A
    CUDA tensor the kernel does not take raises."""
    if not (y.is_cuda and _takes(y, bias)):
        if y.device.type == "cpu":
            with torch.no_grad():
                return bias_relu_reference(y, bias)
        _refuse("bias_relu_", y)
    lib = _library()
    dev = y.get_device()
    rc = lib.pmpu_hpu_bias_relu(y.data_ptr(), y.numel(), y.shape[1], bias.data_ptr(), dev,
                                torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        _build.check(lib, rc, f"bias_relu_ {tuple(y.shape)}")
    bias_relu_.launches += 1
    return y


def residual_(y, bias, s, skip_bias=None, relu: bool = False):
    """``s (+ skip_bias) + (y + bias)`` over a CUDA ``y``, and with ``relu``
    its ReLU in a new tensor: returns (``y``, the ReLU or None). The plain
    version on the CPU. For grad-free use; a CUDA tensor the kernel does not
    take raises."""
    if not (y.is_cuda and _takes(y, bias) and s.dtype == torch.bfloat16 and s.shape == y.shape
            and s.is_contiguous(memory_format=torch.channels_last) and s.data_ptr() % 16 == 0
            and s.get_device() == y.get_device()
            and (skip_bias is None or (skip_bias.dtype == torch.float32
                                       and skip_bias.shape == bias.shape
                                       and skip_bias.is_contiguous()
                                       and skip_bias.get_device() == y.get_device()))):
        if y.device.type == "cpu":
            with torch.no_grad():
                return residual_reference(y, bias, s, skip_bias, relu)
        _refuse("residual_", y)
    r = torch.empty_like(y) if relu else None
    lib = _library()
    dev = y.get_device()
    rc = lib.pmpu_hpu_residual(y.data_ptr(), s.data_ptr(), None if r is None else r.data_ptr(),
                               y.numel(), y.shape[1], bias.data_ptr(),
                               None if skip_bias is None else skip_bias.data_ptr(), dev,
                               torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        _build.check(lib, rc, f"residual_ {tuple(y.shape)}")
    residual_.launches += 1
    return y, r


bias_relu_.launches = 0  # kernel launches since the last reset
residual_.launches = 0


@functools.cache
def _library():
    lib = _build.library("hpu_epilogue")
    lib.pmpu_hpu_bias_relu.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.pmpu_hpu_residual.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.pmpu_hpu_bias_relu, lib.pmpu_hpu_residual):
        fn.restype = ctypes.c_int
    return lib
