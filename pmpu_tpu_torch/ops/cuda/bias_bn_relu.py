"""Conv bias + eval BatchNorm + ReLU in one pass: CUDA kernel and plain version.

Replaces no TPU kernel. In the JAX package XLA fuses the bias, BatchNorm
and ReLU that follow each 3×3 conv of the backbone and the prior tower into
the conv's output. In the port cuDNN computes the conv and ATen then runs
three passes over the bf16 activation: the conv's bias add, the eval
BatchNorm and ReLU (``clamp_min``), each reading and writing all of it, with
a few more launches for BatchNorm's statistics and the bias's cast. The
kernel (``csrc/bias_bn_relu.cu``) does the three in place in one read and
one write, rounding where the three passes round, so its output is
bit-equal to theirs. It is bound by bytes (2 × 2 bytes an element at 3.35
TB/s): 16-byte loads and stores of 8 channels a thread, several loads in
flight, each thread's channel parameters in registers, one wave of blocks.

The model takes this route in inference only (``models/unet.py::run_layers``,
decided before the conv): train-mode BatchNorm, grad enabled, f32, CPU
tensors and every output this kernel does not take keep the three modules.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pmpu_tpu_torch.ops.cuda import _build

MAX_CHANNELS = 2048  # C / 8 vectors a row, at most one block of 256 threads


def bias_bn_relu_reference(y, conv_bias, mean, var, weight, bias, eps: float):
    """The plain version: the three ATen calls themselves (the bias add a
    cuDNN conv gets, eval ``F.batch_norm``, ``torch.relu``). Adds the bias
    into ``y``; returns the result."""
    y = y.add_(conv_bias.to(y.dtype)[:, None, None])
    return torch.relu(F.batch_norm(y, mean, var, weight, bias, False, 0.0, eps))


def takes(y, conv_bias, mean, var, weight, bias) -> bool:
    """Whether the kernel takes these tensors: ``y`` a CUDA bf16 (N,C,H,W)
    channels_last activation, C a multiple of 8 up to ``MAX_CHANNELS``,
    under 2^31 − 1 elements (ATen's own channels_last path, whose arithmetic
    the kernel repeats), 16-byte aligned; the five others (C,) f32 on its
    device."""
    if not (y.is_cuda and y.dtype == torch.bfloat16 and y.dim() == 4
            and y.is_contiguous(memory_format=torch.channels_last)
            and y.numel() < 2**31 - 1 and y.data_ptr() % 16 == 0):
        return False
    c = y.shape[1]
    return c % 8 == 0 and 0 < c <= MAX_CHANNELS and all(
        t.dtype == torch.float32 and t.shape == (c,) and t.is_contiguous()
        and t.device == y.device for t in (conv_bias, mean, var, weight, bias))


@torch.no_grad()
def bias_bn_relu_(y, conv_bias, mean, var, weight, bias, eps: float):
    """``relu(batch_norm(y + conv_bias))`` with BatchNorm's running statistics
    (``mean``, ``var``) and affine ``weight``, ``bias``: in place over a CUDA
    ``y`` (returned), by the plain version on the CPU. A CUDA tensor that
    ``takes`` refuses raises."""
    if y.device.type == "cpu":
        return bias_bn_relu_reference(y, conv_bias, mean, var, weight, bias, eps)
    if not takes(y, conv_bias, mean, var, weight, bias):
        raise ValueError(
            "bias_bn_relu_: y must be a CUDA bf16 channels_last (N,C,H,W) tensor with C % 8 == 0, "
            f"C <= {MAX_CHANNELS}, under 2^31 - 1 elements, 16-byte aligned, and the parameters "
            f"(C,) contiguous f32 on its device; got {tuple(y.shape)} {y.dtype} on {y.device}")
    lib = _library()
    with torch.cuda.device(y.device):
        rc = lib.pmpu_bias_bn_relu(
            y.data_ptr(), y.numel() // 8, y.shape[1] // 8, conv_bias.data_ptr(),
            mean.data_ptr(), var.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps,
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, rc, f"bias_bn_relu_ {tuple(y.shape)}")
    bias_bn_relu_.launches += 1
    return y


bias_bn_relu_.launches = 0  # kernel launches since the last reset


@functools.cache
def _library():
    lib = _build.library("bias_bn_relu")
    fn = lib.pmpu_bias_bn_relu
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
