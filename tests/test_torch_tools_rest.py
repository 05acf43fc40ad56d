"""The port's copies of the remaining root tools on the CPU
(``pmpu_tpu_torch/tools/``), each against the root tool where that runs on
the CPU, or against the port's own engine and the reference mirror:

* ``measure_baseline``: infer and train at cube 16, filters 4,8, with the
  root tool's JSON keys (the root tool run beside it) plus the device, the
  card and the TF32 fields, written to ``runs/measure_baseline/`` by
  default; ``--full`` at cube 8 runs exactly 3 x cube timed slices;
* ``trace_breakdown`` on a synthetic Chrome trace of known kernel, copy
  and host events (sums checked exactly, the groups equal to
  ``profile_volume.summarize``'s), and its refusal of a trace without device
  operations;
* ``bench_int8_resident`` at filters 4,8: A takes the resident path and B
  does not, and A is bit-equal to ``VolumeEvaluator(quantize="int8")``;
* ``bench_stream``: every compact wire gives the wide wire's losses bit for
  bit under bf16 over 2 steps;
* ``demo_mmap_ramcap`` at 4 volumes of 128³ (a 64 MiB pool, so that the
  cap lies tens of MB from either run's VmData): the in-RAM run's peak lies
  at least 0.8 of the pool above the mmap run's, the mmap run lives, the
  in-RAM run dies, caps outside the measured range are refused, a child
  whose VmData passes the cap is killed;
* ``debug_probunet_drift``: 10 steps within 1e-4 relative of the mirror,
  the CLI's ``--steps``, and the injected eps are what the step draws itself;
* ``repro_client_staging_leak`` for 3 and 7 iterations beside the root
  tool;
* the two run scripts: ``bash -n``, and with a stub ``python3`` on PATH they
  issue exactly the port's module commands and report their codes;
* every tool that takes ``--device`` raises without a card unless asked for
  the CPU.

Heavy torch work runs on one intra-op thread (a pool of threads per test
worker, spinning beside the other workers', once took minutes).
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from pmpu_tpu_torch.inference.engine import VolumeEvaluator
from pmpu_tpu_torch.models import quantized as qz
from pmpu_tpu_torch.tools import (
    bench_int8_resident,
    bench_stream,
    debug_probunet_drift,
    demo_mmap_ramcap,
    measure_baseline,
    profile_volume,
    repro_client_staging_leak,
    trace_breakdown,
)
from pmpu_tpu_torch.train.tasks import make_task

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _root_tool(name):
    """The JAX package's ``tools/{name}.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_root(name, argv) -> str:
    """The root tool's ``main()`` with ``argv``; its standard output."""
    mod = _root_tool(name)
    buf = io.StringIO()
    with mock.patch.object(sys, "argv", [name, *argv]), contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


# ---------------------------------------------------------------- measure_baseline

@pytest.mark.parametrize("mode", ["infer", "train"])
def test_measure_baseline_keys_and_default_out(mode, tmp_path, monkeypatch, one_thread):
    argv = ["--cube", "16", "--num-filters", "4,8", "--slices", "2", "--mode", mode]
    root = json.loads(_run_root("measure_baseline", argv + ["--out", str(tmp_path / "root.json")])
                      .strip().splitlines()[-1])
    monkeypatch.chdir(tmp_path)
    out = measure_baseline.main(argv + ["--device", "cpu"])
    written = tmp_path / "runs" / "measure_baseline" / f"reference_{mode}_cpu.json"
    assert json.loads(written.read_text()) == out
    assert not (tmp_path / "baselines").exists()
    assert set(root) <= set(out), set(root) - set(out)
    assert {"device", "card", "cudnn_allow_tf32", "matmul_allow_tf32"} <= set(out)
    assert (out["device"], out["card"]) == ("cpu", "cpu")
    assert out["cudnn_allow_tf32"] == torch.backends.cudnn.allow_tf32
    same = ("cube", "num_filters") + (("batch", "steps_timed") if mode == "train" else
                                       ("samples_per_slice", "timed_slices", "slices_per_volume"))
    assert {k: out[k] for k in same} == {k: root[k] for k in same}
    assert measure_baseline.parser().parse_args([]).out is None


def test_measure_baseline_full_times_every_slice(tmp_path, monkeypatch, one_thread):
    calls = []

    class Counted(measure_baseline.TProbUNet):
        def forward(self, patch, segm):
            calls.append(patch.shape)
            return super().forward(patch, segm)

    monkeypatch.setattr(measure_baseline, "TProbUNet", Counted)
    out = measure_baseline.main(["--cube", "8", "--num-filters", "4,8", "--samples", "1",
                                 "--full", "--device", "cpu", "--out", str(tmp_path / "m.json")])
    assert out["full_measurement"] and out["timed_slices"] == out["slices_per_volume"] == 24
    assert len(calls) == out["warmup_slices"] + 24
    assert all(s == (1, 1, 8, 8) for s in calls)  # batch-1 slices
    assert out["sec_per_volume_extrapolated"] == pytest.approx(24 * out["sec_per_slice_median"])


# ---------------------------------------------------------------- trace_breakdown

def _synthetic_trace(with_device=True):
    """Host annotations, launches and ops on thread 1; a conv kernel and a
    hand kernel launched inside two ``model`` spans, a copy after them, and
    a kernel outside the window. Durations in microseconds, multiples of
    125 so that every sum in ms is exact."""
    host, dev = 100, 0

    def x(cat, name, pid, tid, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        {"ph": "M", "name": "process_name", "pid": host, "args": {"name": "python"}},
        x("Trace", "PyTorch Profiler (0)", host, 1, -10, 5000),
        x("user_annotation", "profiled_volume", host, 1, 0, 4000),
        x("user_annotation", "model", host, 1, 100, 1000),
        x("user_annotation", "model", host, 1, 1500, 1000),
        x("cpu_op", "aten::conv2d", host, 1, 140, 250),
        x("cpu_op", "aten::conv2d", host, 1, 1540, 125),
        x("cuda_runtime", "cudaLaunchKernel", host, 1, 150, 125, 1),
        x("cuda_runtime", "cudaLaunchKernel", host, 1, 1550, 125, 2),
        x("cuda_runtime", "cudaMemcpyAsync", host, 1, 3000, 250, 3),
    ]
    if with_device:
        events += [
            x("kernel", "cudnn::fprop_kernel", dev, 7, 160, 500, 1),
            x("kernel", "fcomb_mean_tc_kernel", dev, 7, 1600, 375, 2),
            x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", dev, 8, 3100, 125, 3),
            x("gpu_user_annotation", "model", dev, 7, 160, 500),
            x("kernel", "after_the_window", dev, 7, 9000, 125),
        ]
    return {"traceEvents": events}


def test_trace_breakdown_sums_a_synthetic_trace():
    trace = _synthetic_trace()
    b = trace_breakdown.breakdown(trace)
    assert b["window"] == {"annotation": "profiled_volume", "window_ms": 4.0, "busy_ms": 1.0,
                           "device_ops": 3, "idle_share": 0.75}
    assert b["spans"] == {"profiled_volume": [1.0, 1], "model": [0.875, 2]}
    assert b["groups"] == {"conv (cuDNN)": 0.5, "hand kernels": 0.375, "copies": 0.125}
    assert b["host"] == {"aten::conv2d": 0.375, "cudaLaunchKernel": 0.25,
                         "cudaMemcpyAsync": 0.25}
    # the groups are profile_volume's, over the same window
    summary = profile_volume.summarize(trace, "profiled_volume")
    assert {g: ms for g, ms in summary["groups_ms"].items() if ms} == b["groups"]
    assert summary["busy_ms"] == b["window"]["busy_ms"]


def test_trace_breakdown_cli_reads_the_newest_trace(tmp_path, capsys):
    for name, trace in (("old", {"traceEvents": []}), ("new", _synthetic_trace())):
        (tmp_path / name).mkdir()
        (tmp_path / name / "trace.json").write_text(json.dumps(trace))
    os.utime(tmp_path / "old" / "trace.json", (1, 1))
    assert trace_breakdown.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "== device time per annotated span ==" in out and "total device op time: 1.000 ms" in out
    line = next(l for l in out.splitlines() if l.startswith("BREAKDOWN "))
    assert json.loads(line[len("BREAKDOWN "):])["trace"].endswith(os.path.join("new", "trace.json"))


def test_trace_breakdown_refuses_a_trace_without_device_operations(tmp_path, capsys):
    (tmp_path / "trace.json").write_text(json.dumps(_synthetic_trace(with_device=False)))
    assert trace_breakdown.main([str(tmp_path)]) == 1
    captured = capsys.readouterr()
    assert "no device operations" in captured.err and "BREAKDOWN" not in captured.out


# ---------------------------------------------------------------- bench_int8_resident

def test_bench_int8_resident_paths_and_engine_parity(tmp_path, monkeypatch, one_thread):
    res = bench_int8_resident.main(["--device", "cpu", "--cube", "16", "--filters", "4,8",
                                    "--samples", "2", "--rounds", "1", "--n", "1"])
    assert res["argmax_agreement"] > 0.99 and res["max_abs_dprob"] < 0.05
    assert res["qchain_launches_per_volume"]["resident"]["all"] == 0  # the plain version on the CPU
    task = make_task("probunet", num_filters=(4, 8), dtype=torch.bfloat16, device=CPU, seed=0)
    vol = np.random.default_rng(0).random((16, 16, 16)).astype(np.float32)
    calls = []
    real = qz._unet_int8_resident

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(qz, "_unet_int8_resident", spy)
    with torch.inference_mode():
        ev_a, ev_b = bench_int8_resident.evaluators(task, vol, 2, CPU, str(tmp_path))
        up = ev_a._upload(vol)
        a = ev_a._predict_volume(up, 7)[-1]
        n_a = len(calls)
        b = ev_b._predict_volume(up, 7)[-1]
        assert n_a > 0 and len(calls) == n_a  # A resident, B not
        plain = VolumeEvaluator(task, n_samples=2, eval_batch=0, input_dtype="uint8",
                                quantize="int8", device=CPU)
        plain._maybe_quantize(sample_vol=vol)
        want = plain._predict_volume(plain._upload(vol), 7)[-1]
    assert torch.equal(a, want) and torch.equal(res["fused"]["resident"], want)
    assert torch.equal(b, res["fused"]["fused"]) and not torch.equal(a, b)


# ---------------------------------------------------------------- bench_stream

@pytest.mark.parametrize("model", ["unet", "probunet"])
@pytest.mark.parametrize("wire", [(torch.bfloat16, torch.uint8), (torch.bfloat16, torch.int32),
                                  (torch.float32, torch.uint8)], ids=["bf16+u8", "bf16+i32", "f32+u8"])
def test_bench_stream_compact_wires_bit_equal(model, wire, one_thread):
    store = bench_stream._SynthStore(2, 16)
    triples = bench_stream._batches(store, 4, 2, seed=1)
    wide = bench_stream.wire_losses(store, model, 4, triples, CPU, *bench_stream.WIRES["wide"],
                                    num_filters=(4, 8))
    got = bench_stream.wire_losses(store, model, 4, triples, CPU, *wire, num_filters=(4, 8))
    assert got == wide and len(got) == 2 and all(np.isfinite(got))


# ---------------------------------------------------------------- demo_mmap_ramcap

def test_demo_mmap_ramcap_discriminates(tmp_path, monkeypatch, capsys):
    shim = tmp_path / "shim" / "tensorboard"  # its import takes seconds a process
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text('raise ImportError("hidden by the test")\n')
    monkeypatch.setenv("PYTHONPATH", str(tmp_path / "shim"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = demo_mmap_ramcap.main(["--volumes", "4", "--cube", "128", "--device", "cpu",
                                "--workdir", str(tmp_path / "work")])
    out = capsys.readouterr().out
    verdict = json.loads(out.strip().splitlines()[-1])
    assert rc == 0, out
    assert verdict["discriminating"] and verdict["mmap_stream_rc"] == 0 and verdict["inram_rc"] != 0
    assert verdict["pool_on_heap"] and verdict["inram_over_mmap_per_pool"] >= 0.8
    assert verdict["cap_enforced_by_tool"] == (not all(verdict["rlimit_data_enforced"].values()))
    if not verdict["cap_enforced_by_tool"]:  # a kernel that holds the child to the limit
        assert verdict["inram_allocation_failure"] and not verdict["inram_killed_over_cap"]
    assert verdict["pool_gib"] == 4 * 128**3 * 8 / 2**30
    assert verdict["baseline_vm_data_gib"] < verdict["cap_gib"] < (
        verdict["baseline_vm_data_gib"] + verdict["pool_gib"])
    assert "[mmap-store] rc=0" in out and "died under the cap (expected)" in out


@pytest.mark.parametrize("cap_mb", [100, 300, 315, 400])
def test_demo_mmap_ramcap_refuses_caps_outside_the_range(cap_mb):
    base, pool = 300 * 2**20, 20 * 2**20
    cap = cap_mb * 2**20
    if base < cap < base + pool:
        demo_mmap_ramcap.check_cap(cap, base, pool)
    else:
        with pytest.raises(ValueError, match="outside the discriminating range"):
            demo_mmap_ramcap.check_cap(cap, base, pool)


@pytest.mark.parametrize("police", [True, False])
def test_demo_mmap_ramcap_kills_a_child_past_its_cap(police, tmp_path, monkeypatch):
    """Where the kernel lets a child's VmData past RLIMIT_DATA (a private
    mapping, as gVisor allows), the tool's sample kills it; where the kernel
    holds the child to the limit, the tool leaves it to the kernel."""
    monkeypatch.setattr(demo_mmap_ramcap, "vm_data_bytes", lambda pid: 2**40)
    child = demo_mmap_ramcap.Child("over", ["--help"], 2**40 - 1, str(tmp_path), police)
    try:
        demo_mmap_ramcap.run_children([child], timeout=60)
    finally:
        child.close()
    assert child.over_cap == police and child.peak_vm_data == 2**40
    assert child.proc.returncode < 0 if police else child.proc.returncode == 0


def test_rlimit_data_probe_reads_both_paths():
    """This kernel's answer decides who enforces the cap; under Linux both
    requests past the limit are refused."""
    enforced = demo_mmap_ramcap.rlimit_data_enforced()
    assert set(enforced) == {"mmap", "brk"} and all(isinstance(v, bool) for v in enforced.values())


# ---------------------------------------------------------------- debug_probunet_drift

def test_drift_probe_tracks_the_mirror(one_thread):
    out = debug_probunet_drift.drift(10, CPU)
    assert len(out["port"]) == len(out["mirror"]) == 10
    assert out["max_rel_drift"] <= 1e-4, out["rel_drift"]


def test_drift_probe_cli_takes_steps(one_thread, capsys):
    out = debug_probunet_drift.main(["--steps", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["steps"] == 2 and len(out["port"]) == len(out["mirror"]) == 2
    assert "step   1" in printed and '"steps": 2' in printed
    assert out["max_rel_drift"] <= 1e-4


def test_drift_probe_injects_the_steps_own_eps(one_thread):
    probe = debug_probunet_drift.Probe(CPU, 3)
    injected, eps = probe.port(inject=True)
    drawn, _ = probe.port(inject=False)
    assert injected == drawn and len(eps) == 3 and eps[0].shape == (4, 6)


# ---------------------------------------------------------------- repro_client_staging_leak

@pytest.mark.parametrize("n_iters", [3, 7])
def test_staging_leak_repro_runs_beside_the_root_tool(n_iters, capsys):
    """3 iterations as the root tool; 7 leave two after the port's warm-up
    of 5 (the root tool's is 3), whose creep is measured."""
    out = repro_client_staging_leak.main([str(n_iters), "16", "float32", "--device", "cpu"])
    port = capsys.readouterr().out
    root = _run_root("repro_client_staging_leak", [str(n_iters), "16", "float32"])
    assert len(out["rss_mb"]) == n_iters
    want = [l.split()[0:2] for l in root.splitlines() if l.startswith("iter ")]
    assert [l.split()[0:2] for l in port.splitlines() if l.startswith("iter ")] == want
    if n_iters > repro_client_staging_leak.WARMUP:
        assert abs(out["creep_per_iter_mb"]) < 1.0
    else:
        assert out["creep_per_iter_mb"] is None and "creep_per_iter_mb n/a" in port
    assert "after_empty_cache" in port


# ---------------------------------------------------------------- the run scripts

SCRIPTS = ("run_6view_probunet.sh", "run_probunet_h2h.sh")


@pytest.mark.parametrize("script", SCRIPTS)
def test_run_script_parses(script):
    res = subprocess.run(["bash", "-n", str(ROOT / "pmpu_tpu_torch" / "tools" / script)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("script,fail_on,knobs", [
    ("run_6view_probunet.sh", None, {}),
    ("run_6view_probunet.sh", "pmpu_tpu_torch.eval", {}),
    ("run_6view_probunet.sh", None, {"DEVICE": "cpu"}),
    ("run_probunet_h2h.sh", None, {}),
    ("run_probunet_h2h.sh", None, {"DEVICE": "cpu", "LOGS": "logs/arms"}),
], ids=["6view", "6view-eval-fails", "6view-cpu", "h2h", "h2h-cpu-logs"])
def test_run_script_issues_the_ports_commands(script, fail_on, knobs, tmp_path):
    """A stub ``python3`` logs its arguments (and eats a heredoc); with
    ``fail_on`` it exits 3 for that module, whose code the script must
    report through its ``| tail`` (pipefail). The script runs from a copy
    in a tree of its own, into whose root it changes (its logs land there).
    Both run on the card unless ``DEVICE=cpu``."""
    tree = tmp_path / "tree" / "pmpu_tpu_torch" / "tools"
    tree.mkdir(parents=True)
    shutil.copy(ROOT / "pmpu_tpu_torch" / "tools" / script, tree / script)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "calls.log"
    stub = bin_dir / "python3"
    stub.write_text(f'#!/bin/sh\necho "$*" >> "{log}"\n[ "$1" = "-" ] && cat > /dev/null\n'
                    f'[ "$2" = "{fail_on}" ] && exit 3\nexit 0\n')
    stub.chmod(0o755)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
           "DATA": str(tmp_path / "data"), **knobs}
    for knob in {"PYTHON", "DEVICE", "LOGS"} - set(knobs):
        env.pop(knob, None)
    device = knobs.get("DEVICE", "cuda")
    res = subprocess.run(["bash", str(tree / script)],
                         capture_output=True, text=True, timeout=60, env=env)
    calls = log.read_text().splitlines()
    d = tmp_path / "data"
    if script == "run_6view_probunet.sh":
        assert calls == [
            "-",
            f"-m pmpu_tpu_torch.train -m probunet -d {d}/train --num-views 6 --bf16 -e 40 -b 16 "
            f"-l 0.0005 -p 6 --include-empty-slices --num-filters 64,128,256,512,1024 "
            f"--checkpoint-every 10 --checkpoint-dir {d}/ckpt --device {device}",
            f"-m pmpu_tpu_torch.eval -m probunet -f {d}/ckpt/probunet_model.pt -d {d}/test "
            f"--num-views 6 --bf16 --ged 16 --eval-samples 5 --device {device}",
        ]
        rc = 3 if fail_on else 0
        assert f"DONE train rc=0 eval rc={rc}" in res.stdout and res.returncode == rc
    else:
        common = ("-m pmpu_tpu_torch.tools.compare_with_reference --train --model probunet "
                  "--filters 8,16 --cube 24 -e 40 -b 4 -l 0.02 --n-train 10 --n-test 12 "
                  f"--task hard --seeds 4 --shared-init --device {device}")
        assert calls == [f"{common} -p 6 --ged 16", f"{common} -p 999"]
        assert res.returncode == 0 and "arm A rc=0" in res.stdout and "arm B rc=0" in res.stdout
        logs = tmp_path / "tree" / knobs.get("LOGS", "runs/h2h")
        assert sorted(os.listdir(logs)) == [
            "probunet_armA.log", "probunet_armB.log"]


# ---------------------------------------------------------------- no card

@pytest.mark.parametrize("tool,argv", [
    (measure_baseline, []), (bench_int8_resident, []), (bench_stream, []),
    (demo_mmap_ramcap, []), (debug_probunet_drift, []), (repro_client_staging_leak, []),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1])
def test_tools_run_on_the_card_unless_asked_for_the_cpu(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


def test_tools_import_nothing_of_jax():
    for mod in (measure_baseline, trace_breakdown, bench_int8_resident, bench_stream,
                demo_mmap_ramcap, debug_probunet_drift, repro_client_staging_leak):
        src = pathlib.Path(mod.__file__).read_text()
        assert "import jax" not in src and "pmpu_tpu." not in src and "from tests" not in src
