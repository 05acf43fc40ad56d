"""No run may load JAX or the JAX package, compared by whole top-level
module names; the reference imports nothing of the program."""

import ast
import pathlib
import subprocess
import sys

import pytest

from benchmark import core

BENCH = pathlib.Path(core.__file__).resolve().parent


@pytest.mark.parametrize("names,found", [
    (["pmpu_tpu_torch", "pmpu_tpu_torch.ops.cuda", "torch", "numpy"], []),
    (["pmpu_tpu.models"], ["pmpu_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "pmpu_tpu_tools"], []),
])
def test_forbidden_modules_compares_whole_top_level_names(names, found):
    assert core.forbidden_modules(names) == found


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_benchmark_file_imports_jax(path):
    assert not core.forbidden_modules(_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "pmpu_tpu_torch" not in _imports(path)


def test_run_without_a_card_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "probunet-3view-bf16.backlog", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr
