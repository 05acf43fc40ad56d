"""The port's weight loading (pmpu_tpu_torch.train.checkpoint) against the
JAX package's torch export: the JAX tree loads strictly and the port's
state_dict equals ``export_torch_state_dict`` key for key, bit for bit.

Also holds the helpers the other ``test_torch_*`` files share: a small JAX
task with randomized BatchNorm statistics, and the same weights in the
port on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.train import checkpoint as jax_ckpt
from pmpu_tpu.train.tasks import make_task as jax_make_task
from pmpu_tpu_torch.train.checkpoint import load_flax_variables
from pmpu_tpu_torch.train.tasks import make_task


def _randomize_bn(tree, rng, in_stats=False, in_bn=False):
    """Copy of a variables tree (numpy leaves) whose BatchNorm scale, bias,
    mean and var are random, so eval-mode BN is not the identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize_bn(v, rng, in_stats or k == "batch_stats",
                                   in_bn or "bn" in str(k))
            continue
        v = np.asarray(v)
        if in_stats and k == "mean":
            v = rng.normal(0.0, 0.2, v.shape)
        elif in_stats and k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif in_bn and k == "scale":
            v = rng.uniform(0.8, 1.2, v.shape)
        elif in_bn and k == "bias":
            v = rng.normal(0.0, 0.1, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def jax_task_and_variables(name="probunet", num_filters=(4, 8), n_classes=3,
                           ncf=4, latent=3, dtype=None, cube=16, seed=0):
    """A JAX task and its variables as a numpy tree, BN randomized."""
    kw = dict(n_classes=n_classes, num_filters=num_filters, dtype=dtype)
    if name == "probunet":
        kw.update(latent_dim=latent, no_convs_fcomb=ncf)
    task = jax_make_task(name, **kw)
    variables = task.init_variables(
        jax.random.key(seed),
        jnp.zeros((2, cube, cube, 1), jnp.float32),
        jnp.zeros((2, cube, cube, 1), jnp.int32),
    )
    tree = jax.tree_util.tree_map(np.asarray, variables)
    return task, _randomize_bn(tree, np.random.default_rng(seed + 100))


def port_task(name="probunet", num_filters=(4, 8), n_classes=3, ncf=4, latent=3,
              dtype=None, variables=None):
    """The port's task on the CPU, loaded from ``variables`` when given."""
    kw = dict(n_classes=n_classes, num_filters=num_filters, dtype=dtype, device="cpu")
    if name == "probunet":
        kw.update(latent_dim=latent, no_convs_fcomb=ncf)
    task = make_task(name, **kw)
    if variables is not None:
        load_flax_variables(task.net, variables)
    return task


CASES = [
    ("unet", 1, 4), ("unet", 3, 4),
    ("probunet", 3, 2), ("probunet", 3, 3), ("probunet", 3, 4),
]


@pytest.mark.parametrize("name,n_classes,ncf", CASES)
def test_load_equals_torch_export(name, n_classes, ncf):
    """Strict load of the JAX tree; state_dict == export_torch_state_dict
    exactly (same keys, same f32 bits)."""
    nf = (4, 8, 16)
    _, variables = jax_task_and_variables(name, nf, n_classes, ncf)
    task = port_task(name, nf, n_classes, ncf, variables=variables)
    kw = {"no_convs_fcomb": ncf} if name == "probunet" else {}
    want = jax_ckpt.export_torch_state_dict(variables, name, nf, **kw)
    got = {k: v.detach().numpy() for k, v in task.net.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32), err_msg=k)


def test_load_rejects_mismatched_tree():
    """A tree with a tensor the model lacks (fcomb depth 4 into a depth-3
    port model) and a tree missing one raise."""
    _, variables = jax_task_and_variables("probunet", (4, 8), ncf=4)
    with pytest.raises(ValueError, match="does not have"):
        port_task("probunet", (4, 8), ncf=3, variables=variables)
    del variables["params"]["fcomb"]["last_layer"]
    with pytest.raises(KeyError):
        port_task("probunet", (4, 8), ncf=4, variables=variables)


def test_seeded_weights_are_device_independent():
    """make_task builds its weights from the seed on the CPU: two builds
    with one seed are equal, another seed differs."""
    a = port_task("probunet").net.state_dict()
    b = port_task("probunet").net.state_dict()
    c = make_task("probunet", num_filters=(4, 8), latent_dim=3, device="cpu",
                  seed=1).net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fcomb.last_layer.weight"], c["fcomb.last_layer.weight"])
