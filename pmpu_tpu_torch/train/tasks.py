"""Task adapters, inference subset (counterpart of
``pmpu_tpu/train/tasks.py:30-219``): a task owns the network and says how
many classes it predicts and whether it is probabilistic. Losses and train
steps come with the training path.

A task's network is made from a seed: initialized on the CPU with a
``torch.Generator`` (the reference's init families,
``models/initializers.py``), then moved to the device in
``torch.channels_last`` memory, in eval mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.models import ProbabilisticUNet, UNet
from pmpu_tpu_torch.models.initializers import initialize


def _place(net: torch.nn.Module, device, seed: int) -> torch.nn.Module:
    dev = resolve_device(device)
    initialize(net, torch.Generator().manual_seed(seed))
    # inference only in this slice: eval mode, no autograd state
    return net.to(dev, memory_format=torch.channels_last).eval().requires_grad_(False)


class UNetTask:
    name = "unet"
    is_probabilistic = False

    def __init__(
        self,
        n_channels: int = 1,
        n_classes: int = 1,
        num_filters: Sequence[int] = (64, 128, 256, 512, 1024),
        dtype: Optional[torch.dtype] = None,
        device=None,
        seed: int = 0,
    ):
        self.n_classes = n_classes
        self.net = _place(
            UNet(n_channels, n_classes, tuple(num_filters), dtype=dtype), device, seed
        )


class ProbUNetTask:
    name = "probunet"
    is_probabilistic = True

    def __init__(
        self,
        n_channels: int = 1,
        n_classes: int = 3,
        num_filters: Sequence[int] = (64, 128, 256, 512, 1024),
        latent_dim: int = 6,
        no_convs_fcomb: int = 4,
        dtype: Optional[torch.dtype] = None,
        device=None,
        seed: int = 0,
    ):
        self.n_classes = n_classes
        self.net = _place(
            ProbabilisticUNet(
                input_channels=n_channels, num_classes=n_classes,
                num_filters=tuple(num_filters), latent_dim=latent_dim,
                no_convs_fcomb=no_convs_fcomb, dtype=dtype,
            ),
            device, seed,
        )


def make_task(name: str, **kw):
    """Factory keyed by the reference's ``-m unet|probunet`` flag; ``device``
    None means ``"cuda"`` and ``seed`` makes the random weights."""
    if name == "unet":
        kw.setdefault("n_classes", 1)
        return UNetTask(**kw)
    if name == "probunet":
        kw.setdefault("n_classes", 3)
        return ProbUNetTask(**kw)
    raise ValueError(f"unknown model {name!r} (expected unet|probunet)")
