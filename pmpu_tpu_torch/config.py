"""Typed configuration: the port's copy of ``pmpu_tpu/config.py``
(``parse_num_filters`` :19, ``Config`` :26 with ``resolved_n_classes`` and
``task_kwargs`` :128), kept here because importing the JAX package pulls in
jax and flax.

``Config`` has the JAX package's fields and defaults, so a configuration
moves between the two packages field for field. What the port runs so far
reads the model fields and the inference ones; the training fields wait for
the training path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch


def parse_num_filters(v: str) -> tuple:
    """argparse converter for --num-filters: "64,128,..." → (64, 128, ...)."""
    return tuple(int(x) for x in v.split(","))


@dataclass
class Config:
    # reference train.py flags (train.py:199-225)
    epochs: int = 5
    batchsize: int = 2
    lr: float = 0.001
    lrf: float = 0.1  # plateau factor
    lrp: int = 5  # plateau patience
    om: float = 0.9  # SGD momentum
    load: Optional[str] = None
    scale: float = 1.0  # accepted for CLI parity (unused by the reference too)
    val: float = 10.0  # validation percent
    net: str = "unet"  # unet | probunet
    dir: Optional[str] = None

    # model hyperparameters (reference construction sites train.py:241-244)
    n_channels: int = 1
    n_classes: Optional[int] = None  # default: 1 for unet, 3 for probunet
    num_filters: Sequence[int] = (64, 128, 256, 512, 1024)
    latent_dim: int = 6
    no_convs_fcomb: int = 4
    beta: float = 10.0

    # extensions of the JAX package (defaults keep the reference's behavior)
    seed: int = 0
    bf16: bool = False  # bfloat16 compute (params stay f32)
    checkpoint_dir: str = "checkpoints"
    logdir: Optional[str] = None
    save_cp: bool = True
    checkpoint_every: int = 1  # epochs between checkpoints
    async_checkpoints: bool = False  # per-epoch saves as Orbax directories
    num_views: int = 3  # 3 = the standard axes; else isotropic oblique views
    eval_samples: int = 5  # prior samples per slice for probunet eval
    eval_batch: int = 0  # slices per model call at eval; 0 = auto
    data_parallel: bool = False
    view_stacks: bool = True
    pallas_sampler: bool = False
    profile_dir: Optional[str] = None
    nan_checks: bool = False
    augment: bool = False
    remat: bool = False
    train_views: Optional[Sequence[int]] = None
    loss: str = "auto"  # auto | dice | ce+dice (unet only)
    class_weights: Optional[Sequence[float]] = None
    save_uncertainty: Optional[str] = None  # eval: fused entropy NIfTIs here
    ged: int = 0  # eval: GED over N whole-volume samples (probunet)
    elastic_alpha: float = 0.0
    eval_mode: str = "sequential"  # sequential | batched
    eval_volumes_batch: int = 2
    stream: bool = False
    mmap_store: Optional[str] = None
    compile_cache: Optional[str] = None  # XLA only; the port has none
    pipeline_depth: int = 2  # volumes dispatched ahead of the fetch
    sharded_volumes: bool = False
    quantize: Optional[str] = None  # eval: None | "int8"
    calibration: Optional[str] = None  # int8 scale file (JSON)
    input_dtype: Optional[str] = None  # H2D wire: None (auto), float32, bfloat16, uint8
    split_decoder: bool = False  # not ported yet
    identity_affine: bool = False  # exports: padded cube + identity affine
    autosave_minutes: float = 0.0
    epoch_offset: int = 0
    rss_limit_mb: float = 0.0
    slice_filter: bool = True

    def resolved_n_classes(self) -> int:
        if self.n_classes is not None:
            return self.n_classes
        return 1 if self.net == "unet" else 3

    def task_kwargs(self) -> dict:
        """Keyword arguments of ``pmpu_tpu_torch.train.tasks.make_task``.
        The loss options (``beta``, ``loss``, ``class_weights``) come with
        the training path; ``split_decoder`` is not ported yet."""
        if self.split_decoder:
            raise NotImplementedError("split_decoder is not ported yet (pmpu_tpu_torch runs "
                                      "the concatenating decoder; the weights are the same)")
        kw = dict(
            n_channels=self.n_channels,
            n_classes=self.resolved_n_classes(),
            num_filters=tuple(self.num_filters),
            dtype=torch.bfloat16 if self.bf16 else None,
        )
        if self.net == "probunet":
            kw.update(latent_dim=self.latent_dim, no_convs_fcomb=self.no_convs_fcomb)
        return kw
