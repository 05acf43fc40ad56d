"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA request without a CUDA device
    raises: the port never carries on quietly on the CPU; callers that want
    the plain CPU path ask for ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); the port "
            "runs on the GPU by default — pass device='cpu' for the plain "
            "PyTorch path (the CLIs: --device cpu; bench_torch.py: BENCH_DEVICE=cpu)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
