"""Checkpoint reading and weights from the JAX package's variable tree
(counterpart of ``pmpu_tpu/train/checkpoint.py:49-53, 225-276, 287-354,
417-446``).

``load_flax_variables`` turns a ``{"params", "batch_stats"}`` tree of arrays
into the port's ``state_dict`` under the reference's torch module names —
the tree ``pmpu_tpu.train.checkpoint.export_torch_state_dict`` produces —
and loads it with ``strict=True``. This module keeps its own copy of the
name tables; it imports nothing of the JAX package.

``load_checkpoint`` reads the JAX package's pickle checkpoint without jax:
the pickled optimizer state names optax's state classes, which a
restricted unpickler replaces by stubs. ``load_for_inference`` builds the
task of a checkpoint: a JAX pickle (its ``model_config`` overrides the
architecture flags) or a reference torch ``state_dict`` (the architecture
from the flags). Orbax directories need orbax, which imports jax: they
raise.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from collections.abc import Mapping

import numpy as np
import torch

from pmpu_tpu_torch.models import ProbabilisticUNet, UNet


def _unet_name_pairs(num_filters):
    """[(flax path, torch prefix, kind)] for the UNet backbone. torch
    DoubleConv Sequential: convs at 0 and 3, BNs at 1 and 4; Down wraps it
    at ``maxpool_conv.1``; ``up_blocks.{i}`` is flax ``up{i}``."""
    pairs = []

    def double_conv(flax_prefix, torch_prefix):
        for j, tidx in ((0, 0), (1, 3)):
            pairs.append(((*flax_prefix, f"conv{j}", "conv"), f"{torch_prefix}.double_conv.{tidx}", "conv"))
        for j, tidx in ((0, 1), (1, 4)):
            pairs.append(((*flax_prefix, f"bn{j}"), f"{torch_prefix}.double_conv.{tidx}", "bn"))

    double_conv(("inc",), "inc")
    for i in range(len(num_filters) - 1):
        double_conv((f"down{i}", "double_conv"), f"down_blocks.{i}.maxpool_conv.1")
        pairs.append(((f"up{i}", "up", "conv"), f"up_blocks.{i}.up", "deconv"))
        double_conv((f"up{i}", "double_conv"), f"up_blocks.{i}.conv")
    pairs.append((("outc", "conv", "conv"), "outc.conv", "conv"))
    return pairs


def _encoder_name_pairs(flax_root, torch_root, num_filters, no_convs_per_block=2):
    """Encoder Sequential: per block i, [AvgPool (i>0)], then Conv, BN, ReLU
    per conv."""
    pairs, t = [], 0
    for i in range(len(num_filters)):
        if i != 0:
            t += 1
        for j in range(no_convs_per_block):
            pairs.append(((*flax_root, f"block{i}_conv{j}", "conv"), f"{torch_root}.layers.{t}", "conv"))
            pairs.append(((*flax_root, f"block{i}_bn{j}"), f"{torch_root}.layers.{t + 1}", "bn"))
            t += 3
    return pairs


def probunet_name_pairs(num_filters, no_convs_per_block=2, no_convs_fcomb=4):
    pairs = [(("unet",) + p[0], "unet." + p[1], p[2]) for p in _unet_name_pairs(num_filters)]
    for tower in ("prior", "posterior"):
        pairs += _encoder_name_pairs((tower, "encoder"), f"{tower}.encoder", num_filters,
                                     no_convs_per_block)
        pairs.append(((tower, "conv_layer"), f"{tower}.conv_layer", "conv"))
    for i in range(no_convs_fcomb - 1):  # fcomb Sequential alternates Conv, ReLU
        pairs.append((("fcomb", f"layer{i}", "conv"), f"fcomb.layers.{2 * i}", "conv"))
    pairs.append((("fcomb", "last_layer", "conv"), "fcomb.last_layer", "conv"))
    return pairs


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def flax_to_state_dict(variables, pairs) -> dict:
    """Tree → torch-layout numpy state_dict. Both kernel layouts take one
    permutation: conv HWIO → OIHW; transposed conv (kh,kw,cout,cin) →
    (cin,cout,kh,kw). A tensor of the tree that no pair reads raises."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd, used_params, used_stats = {}, set(), set()
    for flax_path, prefix, kind in pairs:
        if kind in ("conv", "deconv"):
            node = _lookup(params, flax_path)
            sd[f"{prefix}.weight"] = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))
            sd[f"{prefix}.bias"] = np.asarray(node["bias"])
            used_params |= {(*flax_path, "kernel"), (*flax_path, "bias")}
        else:
            p, b = _lookup(params, flax_path), _lookup(stats, flax_path)
            sd[f"{prefix}.weight"] = np.asarray(p["scale"])
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])
            sd[f"{prefix}.running_mean"] = np.asarray(b["mean"])
            sd[f"{prefix}.running_var"] = np.asarray(b["var"])
            used_params |= {(*flax_path, "scale"), (*flax_path, "bias")}
            used_stats |= {(*flax_path, "mean"), (*flax_path, "var")}
    extra = sorted("/".join(map(str, p)) for p in
                   (set(_leaf_paths(params)) - used_params) | (set(_leaf_paths(stats)) - used_stats))
    if extra:
        raise ValueError(f"tensors of the tree that the model does not have: {extra}")
    return sd


@torch.no_grad()
def load_flax_variables(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load the JAX package's ``{"params", "batch_stats"}`` tree (numpy or
    array-like leaves) into a port ``UNet`` or ``ProbabilisticUNet`` with
    ``strict=True``; a missing or extra tensor raises."""
    if isinstance(module, ProbabilisticUNet):
        pairs = probunet_name_pairs(module.num_filters, module.no_convs_per_block,
                                    module.no_convs_fcomb)
    elif isinstance(module, UNet):
        pairs = _unet_name_pairs(module.num_filters)
    else:
        raise TypeError(f"load_flax_variables: unsupported module {type(module).__name__}")
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in flax_to_state_dict(variables, pairs).items()}
    module.load_state_dict(sd, strict=True)
    return module


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------

# the JAX stack's modules, whose classes (optax's optimizer states) a
# checkpoint's opt_state names; their instances become stubs
_STUBBED = ("optax", "jax", "jaxlib", "flax", "chex")
_NUMPY = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
          "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer")
_BUILTINS = ("set", "frozenset", "complex", "slice", "range", "bytearray")


class StubState:
    """Stands in for an object of the JAX stack in an unpickled checkpoint
    (an optax state); it keeps what it was built from, and nothing reads it."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _CheckpointUnpickler(pickle.Unpickler):
    """numpy arrays, plain containers and stubs for the JAX stack's classes;
    any other class raises."""

    def __init__(self, file):
        super().__init__(file)
        self._stubs = {}

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in _STUBBED:
            key = (module, name)
            if key not in self._stubs:
                self._stubs[key] = type(name, (StubState,), {"__module__": module})
            return self._stubs[key]
        if ((module in _NUMPY and name in _NUMPY_NAMES) or module == "numpy.dtypes"
                or (module == "builtins" and name in _BUILTINS)
                or (module == "collections" and name == "OrderedDict")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint names {module}.{name}, which is not read")


def load_checkpoint(path: str) -> dict:
    """The JAX package's pickle checkpoint (``save_checkpoint``) as a dict:
    ``params``, ``batch_stats``, ``step``, ``plateau``, ``rng_key`` and
    ``extra`` as written; ``opt_state`` holds stubs."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def load_for_inference(path: str, cfg, device=None):
    """(task, cfg) of a checkpoint, its weights loaded with ``strict=True``.

    A JAX pickle checkpoint carries its model config (written by the
    training loop): it overrides ``cfg``'s architecture fields. A reference
    torch ``state_dict`` (``torch.save``) takes the architecture from
    ``cfg``; its ``num_batches_tracked`` counters (training state the
    inference BatchNorm has no use for) are dropped. An Orbax directory
    raises: reading it needs orbax, which imports jax."""
    from pmpu_tpu_torch.train.tasks import make_task

    if os.path.isdir(path):
        raise ValueError(f"{path} is an Orbax checkpoint directory; pmpu_tpu_torch reads "
                         "only pickle checkpoints and torch state_dicts (reading Orbax "
                         "needs orbax, which imports jax): save it as a pickle with the "
                         "JAX package's save_checkpoint")
    try:
        payload = load_checkpoint(path)
    except pickle.UnpicklingError:  # a torch.save zip archive
        payload = None
    if not (isinstance(payload, dict) and "params" in payload):
        payload = None
    if payload is not None:
        mc = (payload.get("extra") or {}).get("model_config")
        if mc:
            cfg = dataclasses.replace(
                cfg,
                net=mc["net"],
                n_channels=mc.get("n_channels", 1),
                n_classes=mc.get("n_classes"),
                num_filters=tuple(mc.get("num_filters", cfg.num_filters)),
                latent_dim=mc.get("latent_dim", cfg.latent_dim),
                no_convs_fcomb=mc.get("no_convs_fcomb", cfg.no_convs_fcomb),
                beta=mc.get("beta", cfg.beta),
            )
        task = make_task(cfg.net, **cfg.task_kwargs(), device=device)
        load_flax_variables(task.net, {"params": payload["params"],
                                       "batch_stats": payload["batch_stats"]})
        return task, cfg
    task = make_task(cfg.net, **cfg.task_kwargs(), device=device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if not k.endswith(".num_batches_tracked")}
    task.net.load_state_dict(sd, strict=True)
    return task, cfg
