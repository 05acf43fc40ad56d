"""Device resolution and f32 precision shared by the port's modules."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; ``"cuda:N"`` names card N. A CUDA request
    without a CUDA device (or without card N) raises: the port never carries
    on quietly on the CPU; callers that want the plain CPU path ask for
    ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); the port "
            "runs on the GPU by default — pass device='cpu' for the plain "
            "PyTorch path (the CLIs: --device cpu; bench_torch.py: BENCH_DEVICE=cpu)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda', 'cuda:N' or 'cpu', got {device!r}")
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise ValueError(f"{dev}: there are {torch.cuda.device_count()} CUDA devices")
    return dev


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the f32 convolutions (cuDNN) and matmuls (cuBLAS) run
    inside, whatever the process set (PyTorch's default lets cuDNN use
    TF32); both settings are restored on exit. The JAX package computes
    these in exact f32. A forward op enters it only for f32 operands
    (:func:`exact_f32_if`); the train step's backward enters it in every
    dtype, since the flags change no bf16 op."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(mm)


def exact_f32_if(dtype):
    """:func:`exact_f32` for f32 operands, else a context that does nothing."""
    return exact_f32() if dtype == torch.float32 else contextlib.nullcontext()


def card_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``), the line that stands beside every
    number a tool records; ``"cpu"`` for the CPU."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "-i", str(dev.index or 0),
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
