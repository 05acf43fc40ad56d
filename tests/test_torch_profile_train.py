"""``pmpu_tpu_torch.tools.profile_train``: the grouping of a train step's
device operations on a synthetic Chrome trace (each group reached once),
and the tool end to end on the CPU at a tiny size (its trace has no device
operations: empty groups, a null idle share)."""

import pytest

from pmpu_tpu_torch.tools import profile_train


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _launch(corr, ts, tid, kernel, dur):
    return [_x("cuda_runtime", "cudaLaunchKernel", ts, 2, tid, correlation=corr),
            _x("kernel", kernel, 1000 + 100 * corr, dur, 7, correlation=corr)]


def test_train_groups_on_a_synthetic_trace():
    ev = [
        _x("user_annotation", "profiled_step", 0, 3000),
        _x("user_annotation", "forward", 10, 390), _x("user_annotation", "batchnorm", 100, 100),
        _x("user_annotation", "backward", 400, 500), _x("user_annotation", "optimizer", 900, 90),
        _x("cpu_op", "aten::convolution", 40, 30, **{"Sequence number": 3}),
        _x("cpu_op", "aten::mul", 140, 20, **{"Sequence number": 7}),
        _x("cpu_op", "autograd::engine::evaluate_function: MulBackward0", 500, 50, 2,
           **{"Sequence number": 7}),
        _x("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", 600, 50, 2,
           **{"Sequence number": 3}),
    ]
    ev += _launch(1, 50, 1, "cudnn::fprop_implicit_gemm", 10.0)
    ev += _launch(2, 150, 1, "at::elementwise_kernel<mul>", 20.0)
    ev += _launch(3, 300, 1, "at::elementwise_kernel<clamp>", 30.0)
    ev += _launch(4, 510, 2, "at::reduce_kernel<sum>", 40.0)
    ev += _launch(5, 610, 2, "sm90_xmma_wgrad", 50.0)
    ev += _launch(6, 620, 2, "at::elementwise_kernel<add>", 60.0)
    ev += _launch(7, 950, 1, "at::elementwise_kernel<sgd>", 70.0)
    ev += _launch(8, 20, 1, "pmpu_gather_normalize_kernel", 80.0)
    ev.append(_x("kernel", "lost_kernel", 2500, 90.0, 7, correlation=99))
    g = profile_train.train_groups({"traceEvents": ev}, "profiled_step")
    want = {"conv forward": 0.01, "batchnorm forward": 0.02, "other forward": 0.03,
            "batchnorm backward": 0.04, "conv backward": 0.05, "other backward": 0.06,
            "optimizer": 0.07, "gather": 0.08, "augment": 0.0, "other": 0.09}
    assert g["groups_ms"] == pytest.approx(want)
    assert g["device_ops"] == 9 and g["unplaced_ops"] == 1 and g["window_ms"] == 3.0
    assert g["busy_ms"] == pytest.approx(0.45) and g["idle_share"] == pytest.approx(0.85)


def test_profile_train_runs_on_the_cpu(tmp_path, capsys):
    out = profile_train.run(["--device", "cpu", "--cube", "8", "--filters", "4,8", "--steps",
                             "4:2", "--trace-dir", str(tmp_path)])
    r = out["4:2"]
    assert r["device_ops"] == 0 and r["idle_share"] is None
    assert set(r["groups_ms"]) == set(profile_train.TRAIN_GROUPS)
    assert len(r["host_enqueue_ms"]) == 3 and r["wall_ms"] > 0
    assert (tmp_path / "b4x2" / "trace.json").exists()
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines if ln[:1].isupper()][:4] == [
        "UNTRACED", "ENQUEUE", "TRACED", "GROUPS"]
