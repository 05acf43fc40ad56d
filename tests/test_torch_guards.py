"""Boundaries of the port: it imports neither jax nor the JAX package, its
entry points refuse to run on the CPU unless asked, and importing its
kernel modules builds and loads nothing."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_weights import port_task

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "pmpu_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_import_pulls_in_no_jax():
    """In a fresh interpreter (tests/conftest.py imports jax here), every
    port module and ``bench_torch.py`` import without jax, flax, optax,
    ml_dtypes or pmpu_tpu."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES + ['bench_torch']!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'chex', 'ml_dtypes', 'pmpu_tpu'))\n"
        "print(len(sys.modules), bad)\n"
    )
    assert _run(code).split()[-1] == "[]"
    assert len(MODULES) >= 40
    assert {"pmpu_tpu_torch.eval", "pmpu_tpu_torch.data.native", "pmpu_tpu_torch.data.index_map",
            "pmpu_tpu_torch.train.steps", "pmpu_tpu_torch.train.schedule",
            "pmpu_tpu_torch.train.loop", "pmpu_tpu_torch.train.__main__",
            "pmpu_tpu_torch.utils.tblog", "pmpu_tpu_torch.utils.colorize",
            "pmpu_tpu_torch.data.augment", "pmpu_tpu_torch.data.pipeline",
            "pmpu_tpu_torch.tools.profile_train", "pmpu_tpu_torch.serve",
            "pmpu_tpu_torch.visualize_sampling", "pmpu_tpu_torch.inference.uncertainty",
            "pmpu_tpu_torch.tools.soak_serve", "pmpu_tpu_torch.tools.ab_device_compute",
            "pmpu_tpu_torch.utils.profiling", "pmpu_tpu_torch.parallel",
            "pmpu_tpu_torch.parallel.mesh", "pmpu_tpu_torch.parallel.hostdata",
            "pmpu_tpu_torch.parallel.sharding"} <= set(MODULES)


def test_parallel_imports_no_jax():
    """``pmpu_tpu_torch.parallel`` alone, in a fresh interpreter: no jax,
    no JAX package, no process group started."""
    code = (
        "import sys, pmpu_tpu_torch.parallel as p, torch.distributed as d\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'chex', 'ml_dtypes', 'pmpu_tpu'))\n"
        "print(d.is_initialized(), p.init_distributed('cpu'), bad)\n"
    )
    assert _run(code).strip() == "False (0, 1) []"


def test_resolve_device_names_a_card(monkeypatch):
    """``cuda:N`` is accepted for a card that exists, raises without a card
    or past the last one; ``local_device`` takes torchrun's LOCAL_RANK."""
    import torch

    from pmpu_tpu_torch.device import resolve_device
    from pmpu_tpu_torch.parallel.mesh import local_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="there are 2 CUDA devices"):
        resolve_device("cuda:2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert local_device() == torch.device("cuda", 1)
    assert local_device("cpu") == torch.device("cpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_source_scan_finds_no_jax_import():
    """No port module, nor ``chip_smoke.py`` (its training phases 10 and 11
    included) or ``bench_torch.py``, imports jax or the JAX package, at
    any depth of a function."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "chex", "ml_dtypes", "pmpu_tpu",
                                "tests"), (f, name)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    from pmpu_tpu_torch import VolumeEvaluator, make_task

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_task("probunet", num_filters=(4, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VolumeEvaluator(port_task())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VolumeEvaluator(port_task(), quantize="int8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VolumeEvaluator(port_task(), num_views=6)
    with pytest.raises(ValueError, match="device must be"):
        VolumeEvaluator(port_task(), device="meta")
    # the predict CLI and the bench: the card unless --device cpu / BENCH_DEVICE=cpu
    from pmpu_tpu_torch.predict import main as predict_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_main(["-i", "scan.nii"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_main(["-i", "scan.nii", "--device", "cuda"])
    # the eval CLI: the card unless --device cpu, before any data is read
    from pmpu_tpu_torch.eval import main as eval_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_main(["-d", "no-such-dir"])
    # the train CLI and the training entry points: the same
    from pmpu_tpu_torch.config import Config
    from pmpu_tpu_torch.data.volumes import VolumeStore
    from pmpu_tpu_torch.train.__main__ import main as train_main
    from pmpu_tpu_torch.train.loop import train_net

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["-d", "no-such-dir"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["-d", "no-such-dir", "--device", "cuda:0", "--data-parallel"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net(Config(), VolumeStore.from_arrays(np.zeros((1, 4, 4, 4)), np.zeros((1, 4, 4, 4))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_task("unet", num_filters=(4, 8), train=True)
    # the streaming pipeline and the train-step profiler: the same
    from pmpu_tpu_torch.data.pipeline import PrefetchPipeline
    from pmpu_tpu_torch.tools.profile_train import main as profile_train_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchPipeline(VolumeStore.from_arrays(np.zeros((1, 4, 4, 4)), np.zeros((1, 4, 4, 4))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_train_main([])
    for mode in ("infer", "train"):
        out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, capture_output=True,
                             text=True, timeout=300,
                             env={**os.environ, "BENCH_DEVICE": "cuda", "BENCH_MODE": mode})
        assert out.returncode != 0 and "no CUDA device" in out.stderr and out.stdout == ""


def test_serving_tools_need_cuda_or_an_explicit_cpu(tmp_path):
    """The daemon, the visualizer, the soak harness and the A/B tool run on
    the card unless given ``--device cpu``: without CUDA they raise before
    reading or starting anything (the soak harness starts no daemon)."""
    from pmpu_tpu_torch.serve import main as serve_main
    from pmpu_tpu_torch.tools.ab_device_compute import main as ab_main
    from pmpu_tpu_torch.tools.soak_serve import main as soak_main
    from pmpu_tpu_torch.visualize_sampling import main as viz_main

    for main, argv in ((serve_main, ["--watch", "no-such-dir", "--out", "out", "--once"]),
                       (viz_main, ["-d", "no-such-dir"]),
                       (soak_main, ["--workdir", str(tmp_path / "soak")]),
                       (ab_main, ["--cube", "8"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([*argv, "--device", "cuda"])
    assert not (tmp_path / "soak").exists()


def test_kernel_modules_build_and_load_nothing_on_cpu():
    """Importing the kernel modules and running every wrapper on CPU
    tensors (their plain versions), the int8 and the 6-view paths included,
    starts no nvcc, loads no library and counts no launch on either fcomb
    route, nor of the conv epilogue."""
    code = (
        "import subprocess, torch\n"
        "def no_nvcc(*a, **k): raise AssertionError('nvcc started')\n"
        "subprocess.Popen = no_nvcc\n"
        "from pmpu_tpu_torch.ops.cuda import (_build, bias_bn_relu, fcomb_mean, oblique_gather,\n"
        "                                     qconv, slice_gather)\n"
        "from pmpu_tpu_torch import VolumeEvaluator\n"
        "from pmpu_tpu_torch.data.sampler import make_oblique_view_stacks, sample_batch_vt\n"
        "from pmpu_tpu_torch.train.tasks import make_task\n"
        "task = make_task('probunet', num_filters=(4, 8), device='cpu')\n"
        "fcomb_mean.fcomb_mean_decode(torch.rand(2, 4, 4, 4), torch.rand(3, 2, 6),\n"
        "                             task.net.fcomb_params())\n"
        "slice_gather.gather_normalize_planes(torch.rand(3, 4, 4), torch.arange(3))\n"
        "sample_batch_vt(torch.rand(3, 2, 4, 4, 4),\n"
        "                torch.zeros(3, 2, 4, 4, 4, dtype=torch.int32),\n"
        "                torch.tensor([[1, 2, 3]]))\n"
        "qconv.fused_qchain(torch.rand(1, 5, 5, 4), qconv.make_random_chain(0, [(4, 8)]))\n"
        "oblique_gather.oblique_planes(torch.rand(5, 5, 5), torch.eye(3)[None])\n"
        "make_oblique_view_stacks(torch.rand(2, 5, 5, 5), torch.zeros(2, 5, 5, 5, dtype=torch.int32),\n"
        "                         torch.eye(3)[None].repeat(2, 1, 1))\n"
        "VolumeEvaluator(task, quantize='int8', eval_batch=8, device='cpu')"
        ".evaluate_volume(torch.rand(8, 8, 8).numpy())\n"
        "VolumeEvaluator(task, num_views=6, eval_batch=16, device='cpu')"
        ".evaluate_volume(torch.rand(8, 8, 8).numpy())\n"
        "print(_build.library.cache_info().currsize,\n"
        "      fcomb_mean.fcomb_mean_decode.launches,\n"
        "      sum(fcomb_mean.fcomb_mean_decode.launches_by_route.values()),\n"
        "      slice_gather.gather_normalize_planes.launches,\n"
        "      qconv.fused_qchain.launches,\n"
        "      oblique_gather.oblique_planes.launches,\n"
        "      bias_bn_relu.bias_bn_relu_.launches)\n"
    )
    assert _run(code).split() == ["0", "0", "0", "0", "0", "0", "0"]
