"""Boundaries of the port: it imports neither jax nor the JAX package, its
entry points refuse to run on the CPU unless asked, and importing its
kernel modules builds and loads nothing."""

import ast
import pathlib
import subprocess
import sys

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
    port module imports without jax, flax, ml_dtypes or pmpu_tpu."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'pmpu_tpu'))\n"
        "print(len(sys.modules), bad)\n"
    )
    assert _run(code).split()[-1] == "[]"
    assert len(MODULES) >= 15


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_source_scan_finds_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "ml_dtypes", "pmpu_tpu", "tests"), (f, name)


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


def test_kernel_modules_build_and_load_nothing_on_cpu():
    """Importing the kernel modules and running every wrapper on CPU
    tensors (their plain versions), the int8 and the 6-view paths included,
    starts no nvcc, loads no library and counts no launch on either fcomb
    route."""
    code = (
        "import subprocess, torch\n"
        "def no_nvcc(*a, **k): raise AssertionError('nvcc started')\n"
        "subprocess.Popen = no_nvcc\n"
        "from pmpu_tpu_torch.ops.cuda import _build, fcomb_mean, oblique_gather, qconv, slice_gather\n"
        "from pmpu_tpu_torch import VolumeEvaluator\n"
        "from pmpu_tpu_torch.train.tasks import make_task\n"
        "task = make_task('probunet', num_filters=(4, 8), device='cpu')\n"
        "fcomb_mean.fcomb_mean_decode(torch.rand(2, 4, 4, 4), torch.rand(3, 2, 6),\n"
        "                             task.net.fcomb_params())\n"
        "slice_gather.gather_normalize_planes(torch.rand(3, 4, 4), torch.arange(3))\n"
        "qconv.fused_qchain(torch.rand(1, 5, 5, 4), qconv.make_random_chain(0, [(4, 8)]))\n"
        "oblique_gather.oblique_planes(torch.rand(5, 5, 5), torch.eye(3)[None])\n"
        "VolumeEvaluator(task, quantize='int8', eval_batch=8, device='cpu')"
        ".evaluate_volume(torch.rand(8, 8, 8).numpy())\n"
        "VolumeEvaluator(task, num_views=6, eval_batch=16, device='cpu')"
        ".evaluate_volume(torch.rand(8, 8, 8).numpy())\n"
        "print(_build.library.cache_info().currsize,\n"
        "      fcomb_mean.fcomb_mean_decode.launches,\n"
        "      sum(fcomb_mean.fcomb_mean_decode.launches_by_route.values()),\n"
        "      slice_gather.gather_normalize_planes.launches,\n"
        "      qconv.fused_qchain.launches,\n"
        "      oblique_gather.oblique_planes.launches)\n"
    )
    assert _run(code).split() == ["0", "0", "0", "0", "0", "0"]
