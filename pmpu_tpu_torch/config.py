"""Typed configuration: the port's copy of ``pmpu_tpu/config.py``
(``parse_num_filters`` :19, ``Config`` :26 with ``resolved_n_classes`` and
``task_kwargs`` :128, ``add_train_args`` :148, ``add_eval_args`` :165,
``_add_extension_args`` :174-283, ``config_from_args`` :285), kept here
because importing the JAX package pulls in jax and flax.

``Config`` has the JAX package's fields and defaults, so a configuration
moves between the two packages field for field, save ``num_filters``: None
here, each model's own widths (``resolved_num_filters``; the JAX package's
default for the U-Net and the probunet), since the hpunet has others. The
CLIs take the JAX package's flags with its defaults (``--num-filters`` as
``num_filters``), plus ``--device``. A flag of a path the port has not
ported yet is accepted by the parser and refused by the entry point that
would need it (the train loop names each one).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import torch


def parse_num_filters(v: str) -> tuple:
    """argparse converter for --num-filters: "64,128,..." → (64, 128, ...)."""
    return tuple(int(x) for x in v.split(","))


NUM_FILTERS = (64, 128, 256, 512, 1024)  # the reference's widths


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
    net: str = "unet"  # unet | probunet | hpunet (inference only)
    dir: Optional[str] = None

    # model hyperparameters (reference construction sites train.py:241-244)
    n_channels: int = 1
    n_classes: Optional[int] = None  # default: 1 for unet, 3 for probunet
    num_filters: Optional[Sequence[int]] = None  # default: the model's own widths
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
    split_decoder: bool = False  # decoder conv0 as conv(skip)+conv(up), no concat
    identity_affine: bool = False  # exports: padded cube + identity affine
    autosave_minutes: float = 0.0
    epoch_offset: int = 0
    rss_limit_mb: float = 0.0
    slice_filter: bool = True

    def resolved_n_classes(self) -> int:
        if self.n_classes is not None:
            return self.n_classes
        return 1 if self.net == "unet" else 3

    def resolved_num_filters(self) -> Optional[tuple]:
        """The widths by level: ``num_filters``, else the reference's for the
        U-Net and the probunet, and None for the hpunet (its task's default,
        the published widths)."""
        if self.num_filters is not None:
            return tuple(self.num_filters)
        return None if self.net == "hpunet" else NUM_FILTERS

    def task_kwargs(self) -> dict:
        """Keyword arguments of ``pmpu_tpu_torch.train.tasks.make_task``."""
        kw = dict(
            n_channels=self.n_channels,
            n_classes=self.resolved_n_classes(),
            dtype=torch.bfloat16 if self.bf16 else None,
        )
        filters = self.resolved_num_filters()
        if self.net == "hpunet":
            if filters is not None:  # its widths by level
                kw["channels_per_block"] = filters
            return kw
        kw["num_filters"] = filters
        if self.split_decoder:
            kw["split_decoder"] = True
        if self.net == "unet" and self.loss != "auto":
            kw["loss_type"] = self.loss
        if self.class_weights is not None:
            kw["class_weights"] = tuple(self.class_weights)
        if self.net == "probunet":
            kw.update(latent_dim=self.latent_dim, no_convs_fcomb=self.no_convs_fcomb,
                      beta=self.beta)
        return kw


def add_train_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX train CLI's flags (reference ``train.py:199-225`` and the JAX
    package's extensions), with the same names and defaults, plus
    ``--device``."""
    p.add_argument("-e", "--epochs", metavar="E", type=int, default=5, dest="epochs")
    p.add_argument("-b", "--batch-size", metavar="B", type=int, nargs="?", default=2,
                   dest="batchsize")
    p.add_argument("-l", "--learning-rate", metavar="LR", type=float, nargs="?", default=0.001,
                   dest="lr")
    p.add_argument("-r", "--schedule-factor", metavar="LRF", type=float, nargs="?", default=0.1,
                   dest="lrf")
    p.add_argument("-p", "--schedule-patience", metavar="LRP", type=int, nargs="?", default=5,
                   dest="lrp")
    p.add_argument("-o", "--optimizer-momentum", metavar="OM", type=float, nargs="?",
                   default=0.9, dest="om")
    p.add_argument("-f", "--load", dest="load", type=str, default=None)
    p.add_argument("-s", "--scale", dest="scale", type=float, default=1)
    p.add_argument("-v", "--validation", dest="val", type=float, default=10.0)
    p.add_argument("-m", "--model", dest="net", type=str, default="unet")
    p.add_argument("-d", "--dir", dest="dir", type=str, default=None)
    return _add_extension_args(p)


def add_eval_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX eval CLI's flags (reference ``eval.py:25-36`` and the JAX
    package's extensions), with the same names and defaults, plus
    ``--device``."""
    p.add_argument("-f", "--load", dest="load", type=str, default=None)
    p.add_argument("-d", "--dir", dest="dir", type=str, default=None)
    p.add_argument("-m", "--model", dest="net", type=str, default="unet",
                   help="unet, probunet or hpunet (the Hierarchical Probabilistic U-Net; "
                   "--num-filters its widths by level, default the published ones)")
    return _add_extension_args(p)


def _views(v: str) -> tuple:
    return tuple(int(x) for x in v.split(","))


def _floats(v: str) -> tuple:
    return tuple(float(x) for x in v.split(","))


def _add_extension_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    g = p.add_argument_group("framework extensions")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--bf16", action="store_true")
    g.add_argument("--checkpoint-dir", dest="checkpoint_dir", type=str, default="checkpoints")
    g.add_argument("--logdir", type=str, default=None)
    g.add_argument("--num-views", dest="num_views", type=int, default=3)
    g.add_argument("--eval-samples", dest="eval_samples", type=int, default=5)
    g.add_argument("--eval-batch", dest="eval_batch", type=int, default=0)
    g.add_argument("--data-parallel", dest="data_parallel", action="store_true",
                   help="shard batches over the visible devices (one device: "
                   "no effect; more raise until the parallel path is ported)")
    g.add_argument("--split-decoder", dest="split_decoder", action="store_true",
                   help="compute decoder convs as conv(skip)+conv(up) with "
                   "sliced kernels (no concat materialization; identical checkpoints)")
    g.add_argument("--identity-affine", dest="identity_affine", action="store_true",
                   help="strict reference-parity exports: padded cube + "
                   "identity affine (eval.py:51-57). Default: un-pad to the "
                   "source shape and carry the input scan's affine/spacing "
                   "through to the output NIfTI header")
    g.add_argument("--n-classes", dest="n_classes", type=int, default=None)
    g.add_argument("--num-filters", dest="num_filters", type=parse_num_filters,
                   default=None,
                   help="comma-separated encoder widths (default: the model's own; the "
                   "reference's 64,128,256,512,1024 for unet and probunet)")
    g.add_argument("--latent-dim", dest="latent_dim", type=int, default=6)
    g.add_argument("--beta", dest="beta", type=float, default=10.0)
    g.add_argument("--no-view-stacks", dest="view_stacks", action="store_false",
                   help="train from the plain (N,S,S,S) stack instead of the "
                   "(3,N,S,S,S) view stacks")
    g.add_argument("--pallas-sampler", dest="pallas_sampler", action="store_true",
                   help="the JAX package's Pallas sampler; on the card it is the same "
                   "gather-normalize kernel as the default view-stack sampler")
    g.add_argument("--profile-dir", dest="profile_dir", type=str, default=None)
    g.add_argument("--nan-checks", dest="nan_checks", action="store_true")
    g.add_argument("--augment", dest="augment", action="store_true")
    g.add_argument("--remat", dest="remat", action="store_true")
    g.add_argument("--train-views", dest="train_views", type=_views, default=None,
                   help="restrict training to these view indices (e.g. 0 = axial only)")
    g.add_argument("--loss", dest="loss", type=str, default="auto",
                   choices=["auto", "dice", "ce+dice"])
    g.add_argument("--class-weights", dest="class_weights", type=_floats, default=None,
                   help="per-class CE weights, e.g. 1,2,8 to upweight thin classes")
    g.add_argument("--save-uncertainty", dest="save_uncertainty", type=str, default=None)
    g.add_argument("--ged", dest="ged", type=int, default=0,
                   help="report GED^2 over N whole-volume samples (probunet)")
    g.add_argument("--checkpoint-every", dest="checkpoint_every", type=int, default=1,
                   help="epochs between checkpoints")
    g.add_argument("--async-checkpoints", dest="async_checkpoints", action="store_true")
    g.add_argument("--autosave-minutes", dest="autosave_minutes", type=float, default=0.0,
                   help="save a consistent {net}_autosave.pt snapshot every N "
                   "minutes of the train phase (0 = off)")
    g.add_argument("--rss-limit-mb", dest="rss_limit_mb", type=float, default=0.0)
    g.add_argument("--epoch-offset", dest="epoch_offset", type=int, default=0,
                   help="global epoch numbering base of checkpoint files and log lines")
    g.add_argument("--elastic-alpha", dest="elastic_alpha", type=float, default=0.0)
    g.add_argument("--eval-mode", dest="eval_mode", type=str, default="sequential",
                   choices=["sequential", "batched"],
                   help="batched = volume groups through the model together")
    g.add_argument("--eval-volumes-batch", dest="eval_volumes_batch", type=int, default=2)
    g.add_argument("--stream", dest="stream", action="store_true")
    g.add_argument("--mmap-store", dest="mmap_store", type=str, default=None,
                   help="out-of-core volume pool: build/reuse the padded "
                   "dataset as file-backed memmaps in this directory")
    g.add_argument("--sharded-volumes", dest="sharded_volumes", action="store_true")
    g.add_argument("--compile-cache", dest="compile_cache", type=str, default=None,
                   help="the JAX package's XLA compilation cache; accepted and "
                   "ignored (PyTorch runs eagerly)")
    g.add_argument("--pipeline-depth", dest="pipeline_depth", type=int, default=2,
                   help="eval: volumes dispatched ahead of the result fetch "
                   "(0 = synchronous; results are bit-identical either way)")
    g.add_argument("--quantize", dest="quantize", type=str, default=None, choices=["int8"],
                   help="post-training int8 inference")
    g.add_argument("--calibration", dest="calibration", type=str, default=None,
                   help="int8 activation-scale JSON: loaded if present "
                   "(skips first-volume self-calibration), saved after "
                   "self-calibration otherwise (with --quantize int8)")
    g.add_argument("--input-dtype", dest="input_dtype", type=str, default=None,
                   choices=["float32", "bfloat16", "uint8"],
                   help="eval H2D volume wire dtype (default: bf16 iff --bf16); "
                   "uint8 = 8-bit fixed point vs per-volume max")
    g.add_argument("--include-empty-slices", dest="slice_filter", action="store_false",
                   help="train on all-background slices too (the reference drops them)")
    g.add_argument("--device", type=str, default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    """A ``Config`` from parsed flags; flags that are not fields (``--device``)
    are left out."""
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in known})
