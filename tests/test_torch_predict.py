"""The port's configuration, checkpoint reading, predict CLI and bench on
the CPU against the JAX package: ``Config`` has the JAX fields and
defaults; a JAX pickle checkpoint (with a real optax ``opt_state``) loads
into the port in a process where jax, optax and flax cannot be imported,
its tensors equal to the JAX export and its ``model_config`` honoured; a
reference torch ``state_dict`` loads strictly; ``python -m
pmpu_tpu_torch.predict --device cpu`` writes the segmentations of the JAX
engine with ``restore_geometry`` (equal) and its entropy (within 1 LSB);
``bench_torch.py`` prints one JSON line with ``bench_infer``'s keys."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu import config as jax_config
from pmpu_tpu.data import nifti as jax_nifti
from pmpu_tpu.data import volumes as jax_volumes
from pmpu_tpu.inference.engine import VolumeEvaluator as JaxEvaluator
from pmpu_tpu.train import checkpoint as jax_ckpt
from pmpu_tpu.train.schedule import ReduceLROnPlateau
from pmpu_tpu.train.steps import create_train_state, make_optimizer
from pmpu_tpu.train.tasks import make_task as jax_make_task
from pmpu_tpu_torch import config
from pmpu_tpu_torch.train import checkpoint
from tests.test_torch_weights import _randomize_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "optax", "flax", "chex", "ml_dtypes")
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "min_s", "median_s", "repeat_times_s",
    "device_compute_s_per_volume", "device_mfu", "stream_s_per_volume", "stream_round_times_s",
    "stream_volumes", "stream_vs_baseline", "stream_mfu", "flops_per_volume", "achieved_tflops",
    "peak_tflops", "mfu", "device", "bf16", "eval_batch", "quantize", "input_dtype",
}
# bench.py's train line (metric, value, unit, vs_baseline) and bench_train's keys
BENCH_TRAIN_KEYS = {
    "metric", "value", "unit", "vs_baseline", "train_slices_per_sec_per_chip", "train_batch",
    "train_vs_baseline", "train_flops_per_step", "train_achieved_tflops", "train_mfu",
}


def _run(args, env=None, timeout=300):
    return subprocess.run(args, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, **(env or {})})


def _model_kw(name):
    return dict(latent_dim=3, no_convs_fcomb=3) if name == "probunet" else {}


def _jax_checkpoint(path, name, nf=(4, 8), n_classes=3, seed=0):
    """A JAX pickle checkpoint of a train state (SGD-momentum opt_state,
    BatchNorm randomized) with its model_config; returns its variables."""
    task = jax_make_task(name, n_classes=n_classes, num_filters=nf, **_model_kw(name))
    state = create_train_state(task, jax.random.key(seed), jnp.zeros((1, 16, 16, 1)),
                               jnp.zeros((1, 16, 16, 1), jnp.int32), make_optimizer())
    tree = _randomize_bn(jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}),
        np.random.default_rng(seed + 7))
    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"])
    mc = {"net": name, "n_channels": 1, "n_classes": n_classes, "num_filters": list(nf),
          **_model_kw(name)}
    jax_ckpt.save_checkpoint(path, state, ReduceLROnPlateau(lr=0.01, mode="min"),
                             jax.random.key(1), extra={"model_config": mc})
    return tree


def _torch_export(tree, name, nf=(4, 8)):
    kw = dict(no_convs_per_block=2, no_convs_fcomb=3) if name == "probunet" else {}
    return jax_ckpt.export_torch_state_dict(tree, name, num_filters=nf, **kw)


def test_config_matches_jax():
    port = {f.name: f.default for f in dataclasses.fields(config.Config)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_config.Config)}
    # the port's widths default to each model's own: the JAX default for both of its models
    assert port.pop("num_filters") is None
    for net in ("unet", "probunet"):
        assert config.Config(net=net).resolved_num_filters() == tuple(ref["num_filters"])
        assert config.Config(net=net).task_kwargs()["num_filters"] == \
            jax_config.Config(net=net).task_kwargs()["num_filters"]
    ref.pop("num_filters")
    assert port == ref
    assert config.parse_num_filters("8,16,32") == jax_config.parse_num_filters("8,16,32")
    for kw in (dict(net="unet"), dict(net="probunet"), dict(net="unet", n_classes=4)):
        assert config.Config(**kw).resolved_n_classes() == \
            jax_config.Config(**kw).resolved_n_classes()
    for net in ("unet", "probunet"):
        for split, loss in ((False, "auto"), (True, "dice")):
            for weights in (None, [1.0, 2.0, 4.0]):
                kw = dict(net=net, bf16=True, num_filters=[4, 8], split_decoder=split, loss=loss,
                          class_weights=weights, beta=3.0)
                got = config.Config(**kw).task_kwargs()
                want = jax_config.Config(**kw).task_kwargs()
                assert got.pop("dtype") is torch.bfloat16 and want.pop("dtype") == jnp.bfloat16
                assert got == want
                assert got.get("split_decoder", False) is split


@pytest.mark.parametrize("name", ["unet", "probunet"])
def test_jax_checkpoint_loads_without_jax(tmp_path, name):
    """The loader runs where jax, optax, flax, chex and ml_dtypes cannot be
    imported; the architecture comes from the checkpoint, not from the
    (wrong) flags; the tensors equal the JAX export exactly."""
    path = str(tmp_path / "ck.pt")
    tree = _jax_checkpoint(path, name)
    wrong = "probunet" if name == "unet" else "unet"
    code = (
        "import json, sys\n"
        f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
        "import numpy as np\n"
        "from pmpu_tpu_torch.config import Config\n"
        "from pmpu_tpu_torch.train.checkpoint import load_checkpoint, load_for_inference\n"
        f"task, cfg = load_for_inference({path!r}, Config(net={wrong!r}, num_filters=(16, 32),"
        " latent_dim=6), device='cpu')\n"
        f"np.savez({str(tmp_path / 'sd.npz')!r}, "
        "**{k: v.numpy() for k, v in task.net.state_dict().items()})\n"
        f"p = load_checkpoint({path!r})\n"
        "loaded = sorted(m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in ('jax', 'optax', 'flax', 'chex', 'pmpu_tpu'))\n"
        "print(json.dumps({'net': cfg.net, 'nf': list(cfg.num_filters), 'c': task.n_classes,"
        " 'step': p['step'], 'plateau': p['plateau'], 'opt': type(p['opt_state']).__name__,"
        " 'loaded': loaded}))\n"
    )
    out = _run([sys.executable, "-c", code])
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["net"] == name and info["nf"] == [4, 8] and info["c"] == 3
    assert info["step"] == 0 and info["plateau"]["lr"] == 0.01
    assert info["opt"] == "InjectStatefulHyperparamsState" and info["loaded"] == []
    got = np.load(tmp_path / "sd.npz")
    want = _torch_export(tree, name)
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)


def test_reference_state_dict_loads_strictly(tmp_path):
    """A reference torch state_dict (num_batches_tracked included) loads
    with strict=True; an extra or a missing tensor raises."""
    tree = _randomize_bn(jax.tree_util.tree_map(np.asarray, jax_make_task(
        "unet", n_classes=3, num_filters=(4, 8)).init_variables(
        jax.random.key(3), jnp.zeros((1, 16, 16, 1)), jnp.zeros((1, 16, 16, 1), jnp.int32))),
        np.random.default_rng(3))
    sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
          _torch_export(tree, "unet").items()}
    ref = dict(sd)
    for k in list(sd):
        if k.endswith("running_var"):
            ref[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    cfg = config.Config(net="unet", n_classes=3, num_filters=(4, 8))
    torch.save(ref, tmp_path / "ref.pt")
    task, got_cfg = checkpoint.load_for_inference(str(tmp_path / "ref.pt"), cfg, device="cpu")
    assert got_cfg == cfg
    state = task.net.state_dict()
    assert sorted(state) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(state[k], v), k
    for bad in ({**sd, "outc.conv.extra": torch.zeros(1)},
                {k: v for k, v in sd.items() if k != "inc.double_conv.0.bias"}):
        torch.save(bad, tmp_path / "bad.pt")
        with pytest.raises(RuntimeError, match="state_dict"):
            checkpoint.load_for_inference(str(tmp_path / "bad.pt"), cfg, device="cpu")


def test_orbax_directory_and_foreign_classes_raise(tmp_path):
    (tmp_path / "orbax" / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        checkpoint.load_for_inference(str(tmp_path / "orbax"), config.Config(), device="cpu")
    with open(tmp_path / "evil.pt", "wb") as f:
        pickle.dump({"params": {}, "hook": os.system}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.system|os.system"):
        checkpoint.load_checkpoint(str(tmp_path / "evil.pt"))


def _scans(directory):
    rng = np.random.default_rng(5)
    names = []
    for i, shape in enumerate(((12, 16, 10), (16, 9, 14), (11, 13, 16))):
        affine = np.diag([1.0 + 0.5 * i, 2.0, 0.75, 1.0])
        affine[:3, 3] = (i, -3.0 * i, 8.0)
        img = rng.random(shape).astype(np.float32)
        img[2:8, 3:9, 2:8] += 0.7
        names.append(f"s{i}.nii")
        jax_nifti.save(os.path.join(directory, names[-1]), img, affine)
    return names


@pytest.mark.parametrize("mode", ["directory", "file", "file identity-affine"])
def test_predict_cli_matches_jax_engine(tmp_path, mode):
    """The same JAX checkpoint (a U-Net, 3 classes) through the port's CLI
    on the CPU and through the JAX engine: segmentations equal after
    ``restore_geometry`` (shape and affine the source's, or the padded cube
    and identity), entropy within 1 LSB of the uint16 step."""
    ck = str(tmp_path / "ck.pt")
    _jax_checkpoint(ck, "unet", seed=2)
    indir = tmp_path / "in"
    indir.mkdir()
    names = _scans(str(indir))
    (indir / "notes.txt").write_text("not a scan")
    identity = mode.endswith("identity-affine")
    if mode == "directory":
        src, seg_out, ent_out = str(indir), str(tmp_path / "seg"), str(tmp_path / "ent")
    else:
        names = names[1:2]
        src = str(indir / names[0])
        seg_out, ent_out = str(tmp_path / "seg.nii"), str(tmp_path / "ent.nii")
    cmd = [sys.executable, "-m", "pmpu_tpu_torch.predict", "-m", "probunet", "-f", ck,
           "-i", src, "-o", seg_out, "--uncertainty", ent_out, "--device", "cpu"]
    out = _run(cmd + (["--identity-affine"] if identity else []))
    assert out.returncode == 0, out.stderr

    task, variables, _ = jax_ckpt.load_for_inference(ck, jax_config.Config(net="probunet"))
    jev = JaxEvaluator(task, n_samples=1, eval_batch=0)
    paths = [str(indir / n) for n in names]
    geoms = [jax_volumes.geom_from_header(jax_nifti.read_header(p), p) for p in paths]
    if mode == "directory":
        cube = max(max(g.shape) for g in geoms)
        want = jev.predict_volumes_pipelined(
            variables, [jax_volumes.pad_to_cube(jax_nifti.load(p), cube) for p in paths],
            key=jax.random.key(0), want_entropy=True)
        outs = [(os.path.join(seg_out, n), os.path.join(ent_out, n)) for n in names]
    else:
        res = jev.evaluate_volume(variables, jax_volumes.pad_to_cube(jax_nifti.load(paths[0])),
                                  key=jax.random.key(0))
        want = [(res["argmax"], jev._fetch_entropy(jev._entropy(res["fused"])))]
        outs = [(seg_out, ent_out)]
    step = np.log(3) / 65535.0
    for (seg, ent), geom, (seg_path, ent_path) in zip(want, geoms, outs):
        seg, aff = jax_volumes.restore_geometry(np.asarray(seg, np.float32), geom, identity)
        ent, _ = jax_volumes.restore_geometry(np.asarray(ent, np.float32), geom, identity)
        got = jax_nifti.load(seg_path)
        np.testing.assert_array_equal(got, seg)
        assert got.shape == (max(geom.shape),) * 3 if identity else geom.shape
        want_aff = np.eye(4) if aff is None else aff
        np.testing.assert_array_equal(jax_nifti.read_header(seg_path).affine, want_aff)
        got_ent = jax_nifti.load(ent_path)
        assert np.abs(np.rint(got_ent / step) - np.rint(ent / step)).max() <= 1


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_bench_torch_prints_one_line_with_every_key(mode):
    env = dict(BENCH_DEVICE="cpu", BENCH_CUBE="16", BENCH_FILTERS="4,8", BENCH_REPEATS="1",
               BENCH_STREAM="2", BENCH_STREAM_ROUNDS="1", BENCH_DEVICE_REPEATS="1",
               BENCH_TRAIN_BATCH="4", BENCH_TRAIN_STEPS="2", BENCH_MODE=mode)
    out = _run([sys.executable, "bench_torch.py"], env=env)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    if mode == "train":
        assert BENCH_TRAIN_KEYS <= set(line)
        assert line["device"] == "cpu" and line["train_mfu"] is None
        assert line["train_batch"] == 4 and line["unit"] == "slices/s"
        assert line["value"] == line["train_slices_per_sec_per_chip"] > 0
        assert line["train_flops_per_step"] > 0 and np.isfinite(line["train_loss"])
        return
    assert set(line) == BENCH_KEYS
    assert line["device"] == "cpu" and line["peak_tflops"] is None and line["mfu"] is None
    assert line["stream_volumes"] == 2 and len(line["repeat_times_s"]) == 1
    assert line["input_dtype"] == "uint8" and line["bf16"] is True
    assert line["flops_per_volume"] > 0 and line["value"] == line["min_s"] > 0
