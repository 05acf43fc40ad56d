"""The port's VolumeEvaluator with quantize="int8" on the CPU (the conv-chain
kernel's plain version) against the JAX package's int8 engine, in f32 with
mean_z, and its calibration file: one file serves both packages, it is
read back bit for bit, tampered scales reach the forward, and an
unreadable file is recalibrated and replaced."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.inference import engine as jax_engine
from pmpu_tpu_torch.inference import engine
from tests.test_torch_engine import _volume_and_truth
from tests.test_torch_weights import jax_task_and_variables, port_task


def _jax_eval(jtask, variables, vol, truth, path):
    ev = jax_engine.VolumeEvaluator(jtask, eval_batch=20, mean_z=True, quantize="int8",
                                    calibration=str(path))
    return ev.evaluate_volume(jax.tree_util.tree_map(jnp.asarray, variables), vol, truth)


@pytest.mark.parametrize("name", ["unet", "probunet"])
def test_int8_evaluator_matches_jax_with_one_scale_file(tmp_path, name):
    """The JAX engine self-calibrates and writes the file; the port loads
    it: argmax equal everywhere, Dice equal to 1e-6. The port's own
    self-calibration writes a file the JAX engine loads, and the two then
    agree again."""
    nf = (4, 8)
    jtask, variables = jax_task_and_variables(name, nf, 3)
    task = port_task(name, nf, 3, variables=variables)
    vol, truth = _volume_and_truth()
    jax_file, port_file = tmp_path / "jax.json", tmp_path / "port.json"
    want = _jax_eval(jtask, variables, vol, truth, jax_file)
    ev = engine.VolumeEvaluator(task, eval_batch=20, mean_z=True, quantize="int8",
                                calibration=str(jax_file), device="cpu")
    got = ev.evaluate_volume(vol, truth)
    np.testing.assert_array_equal(got["argmax"], want["argmax"])
    np.testing.assert_allclose(got["dice"], want["dice"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["fused"].numpy(), np.asarray(want["fused"]), rtol=0, atol=1e-5)

    ev2 = engine.VolumeEvaluator(task, eval_batch=20, mean_z=True, quantize="int8",
                                 calibration=str(port_file), device="cpu")
    got2 = ev2.evaluate_volume(vol, truth)
    saved = json.loads(port_file.read_text())
    assert saved["version"] == 2 and saved["probabilistic"] == (name == "probunet")
    assert len(saved["us"]) == 1 and all(v > 0 for v in saved["xs"])
    want2 = _jax_eval(jtask, variables, vol, truth, port_file)
    np.testing.assert_array_equal(got2["argmax"], want2["argmax"])
    np.testing.assert_allclose(got2["dice"], want2["dice"], rtol=0, atol=1e-6)


def test_calibration_file_round_trip_and_tampering(tmp_path):
    """A fresh evaluator loads the written file and reproduces the fused
    volume bit for bit; scaled-up scales change it (the file is consumed,
    not recalibrated over)."""
    task = port_task("probunet", (4, 8), variables=jax_task_and_variables("probunet", (4, 8))[1])
    vol, truth = _volume_and_truth()
    path = tmp_path / "scales.json"

    def run():
        ev = engine.VolumeEvaluator(task, eval_batch=24, mean_z=True, quantize="int8",
                                    calibration=str(path), device="cpu")
        return ev.evaluate_volume(vol, truth)

    a = run()
    saved = json.loads(path.read_text())
    b = run()
    assert torch.equal(a["fused"], b["fused"])
    np.testing.assert_array_equal(a["argmax"], b["argmax"])
    path.write_text(json.dumps({**saved, "xs": [v * 40.0 for v in saved["xs"]]}))
    c = run()
    assert not torch.equal(c["fused"], a["fused"])
    path.write_text(json.dumps({**saved, "num_filters": [64, 128]}))
    with pytest.raises(ValueError, match="num_filters"):
        run()


def test_corrupt_calibration_file_is_recalibrated(tmp_path):
    task = port_task("unet", (4, 8))
    vol, truth = _volume_and_truth()
    path = tmp_path / "scales.json"
    path.write_text('{"version": 1, "xs": [0.1,')  # a truncated write
    ev = engine.VolumeEvaluator(task, eval_batch=24, quantize="int8", calibration=str(path),
                                device="cpu")
    r = ev.evaluate_volume(vol, truth)
    assert torch.isfinite(r["fused"]).all()
    saved = json.loads(path.read_text())
    assert saved["xs"] and all(v > 0 for v in saved["xs"])
    assert not (tmp_path / "scales.json.tmp").exists()


def test_quantized_tree_is_cached_by_the_weights():
    """One tree per set of weights: a second volume reuses it; reloading
    the weights in place builds a new one."""
    task = port_task("unet", (4, 8))
    vol, _ = _volume_and_truth()
    ev = engine.VolumeEvaluator(task, eval_batch=24, quantize="int8", device="cpu")
    ev.evaluate_volume(vol)
    tree = ev._qvars
    assert ev._qvars_calibrated
    ev.evaluate_volume(vol)
    assert ev._qvars is tree
    with torch.no_grad():
        task.net.inc.double_conv[0].weight.mul_(2.0)
    ev.evaluate_volume(vol)
    assert ev._qvars is not tree
    with pytest.raises(ValueError, match="quantize"):
        engine.VolumeEvaluator(task, quantize="int4", device="cpu")
