"""Checkpoints and weights in the JAX package's variable tree (counterpart
of ``pmpu_tpu/train/checkpoint.py:29-88, 225-276, 287-354, 417-446``).

``load_flax_variables`` turns a ``{"params", "batch_stats"}`` tree of arrays
into the port's ``state_dict`` under the reference's torch module names —
the tree ``pmpu_tpu.train.checkpoint.export_torch_state_dict`` produces —
and loads it with ``strict=True``; ``flax_variables`` is the inverse. This
module keeps its own copy of the name tables; it imports nothing of the JAX
package.

``save_checkpoint`` writes the JAX package's pickle payload (``params`` and
``batch_stats`` under flax names, ``step``, ``plateau``, ``extra``) with
numpy arrays and builtins only, so the JAX package's ``load_for_inference``
and ``restore_train_state`` read it; ``rng_key`` and ``opt_state`` are None
and the port's own momentum buffers and generator state go under keys of
their own. ``restore_train_state`` resumes from either package's file (a
JAX file has no port momentum: it starts fresh).

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
import logging
import os
import pickle
from collections.abc import Mapping

import numpy as np
import torch

from pmpu_tpu_torch.models import ProbabilisticUNet, UNet

log = logging.getLogger(__name__)


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


def _assign(tree: dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def state_dict_to_flax(sd, pairs) -> dict:
    """Torch-layout state_dict → ``{"params", "batch_stats"}`` numpy trees
    under flax names, the inverse of :func:`flax_to_state_dict` (kernels
    OIHW → HWIO and (cin,cout,kh,kw) → (kh,kw,cout,cin), one permutation).
    A tensor of the state_dict that no pair reads raises."""
    sd = {k: np.array(v.detach().cpu() if hasattr(v, "detach") else v, copy=True)
          for k, v in sd.items()}
    params, stats, used = {}, {}, set()
    for flax_path, prefix, kind in pairs:
        if kind in ("conv", "deconv"):
            _assign(params, (*flax_path, "kernel"),
                    np.ascontiguousarray(np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))))
            _assign(params, (*flax_path, "bias"), sd[f"{prefix}.bias"])
            used |= {f"{prefix}.weight", f"{prefix}.bias"}
        else:
            for tname, fname, tree in (("weight", "scale", params), ("bias", "bias", params),
                                       ("running_mean", "mean", stats),
                                       ("running_var", "var", stats)):
                _assign(tree, (*flax_path, fname), sd[f"{prefix}.{tname}"])
                used.add(f"{prefix}.{tname}")
    extra = sorted(set(sd) - used)
    if extra:
        raise ValueError(f"tensors of the state_dict that the flax tree does not have: {extra}")
    return {"params": params, "batch_stats": stats}


def module_name_pairs(module: torch.nn.Module):
    if isinstance(module, ProbabilisticUNet):
        return probunet_name_pairs(module.num_filters, module.no_convs_per_block,
                                   module.no_convs_fcomb)
    if isinstance(module, UNet):
        return _unet_name_pairs(module.num_filters)
    raise TypeError(f"unsupported module {type(module).__name__}")


def flax_variables(module: torch.nn.Module) -> dict:
    """The port model's weights as the JAX package's variable tree (numpy)."""
    return state_dict_to_flax(module.state_dict(), module_name_pairs(module))


@torch.no_grad()
def load_flax_variables(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load the JAX package's ``{"params", "batch_stats"}`` tree (numpy or
    array-like leaves) into a port ``UNet`` or ``ProbabilisticUNet`` with
    ``strict=True``; a missing or extra tensor raises."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in flax_to_state_dict(variables, module_name_pairs(module)).items()}
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


def save_checkpoint(path: str, state, plateau=None, extra: dict | None = None):
    """Write a training state (``steps.TrainState``) as the JAX package's
    pickle payload, atomically (a temporary file renamed over ``path``)."""
    net = state.net
    names = {p: n for n, p in net.named_parameters()}
    momentum = {names[p]: s["momentum_buffer"].detach().cpu().numpy()
                for p, s in state.optimizer.state.items()
                if s.get("momentum_buffer") is not None}
    payload = {
        **flax_variables(net),
        "opt_state": None,
        "step": int(state.step),
        "plateau": plateau.state_dict() if plateau is not None else None,
        "rng_key": None,
        "extra": extra or {},
        "torch_momentum": momentum,
        "torch_generator": state.generator.get_state().numpy(),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)


def _merge(cur: dict, new) -> dict:
    """``cur`` with each leaf that ``new`` has at the same path and shape
    taken from ``new`` (the JAX package's lenient restore)."""
    out = {}
    for k, v in cur.items():
        cand = new.get(k) if isinstance(new, Mapping) else None
        if isinstance(v, dict):
            out[k] = _merge(v, cand)
        elif cand is not None and np.shape(cand) == v.shape:
            out[k] = np.asarray(cand, v.dtype)
        else:
            out[k] = v
    return out


def restore_train_state(path: str, state) -> dict:
    """Resume ``state`` from a pickle checkpoint of either package and
    return its payload (the loop restores the plateau from it). Weights and
    BatchNorm statistics load where the file has them at the model's shapes,
    as the JAX restore does; the step always. From a port checkpoint also
    the momentum buffers and the generator; a JAX checkpoint carries optax
    state, which the port does not read, so the momentum starts fresh."""
    payload = load_checkpoint(path)
    cur = flax_variables(state.net)
    load_flax_variables(state.net, {k: _merge(cur[k], payload.get(k)) for k in cur})
    state.step = int(payload.get("step") or 0)
    momentum = payload.get("torch_momentum")
    if momentum is None:
        log.info("%s has no port optimizer state (a JAX checkpoint): the momentum "
                 "starts fresh", path)
    else:
        names = {p: n for n, p in state.net.named_parameters()}
        for p in state.params:
            buf = momentum.get(names[p])
            if buf is not None and buf.shape == tuple(p.shape):
                state.optimizer.state[p]["momentum_buffer"] = torch.from_numpy(buf).to(p)
    gen = payload.get("torch_generator")
    if gen is not None and gen.size == state.generator.get_state().numel():
        state.generator.set_state(torch.from_numpy(np.asarray(gen, np.uint8)))
    elif gen is not None:
        log.info("%s holds the generator of another device type: not restored", path)
    return payload


def load_checkpoint(path: str) -> dict:
    """A pickle checkpoint of either package as a dict: ``params``,
    ``batch_stats``, ``step``, ``plateau``, ``rng_key`` and ``extra`` as
    written; a JAX file's ``opt_state`` holds stubs."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def load_for_inference(path: str, cfg, device=None):
    """(task, cfg) of a checkpoint, its weights loaded with ``strict=True``.

    A pickle checkpoint of either package carries its model config (written
    by the training loop): it overrides ``cfg``'s architecture fields. A reference
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
