"""The port's serving path on the CPU (plain kernel versions) against the
JAX package: ``predict_volumes_pipelined`` (argmax equal to the JAX
engine's in mean_z mode; every depth bit-equal to depth 0 and to
``evaluate_volume`` with the volume's derived seed), the uint16 entropy
(within 1 LSB of the JAX ``_entropy`` on the same probabilities; clipped at
full scale), the pooled host buffers, and the profile tool's trace
arithmetic."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.inference import engine as jax_engine
from pmpu_tpu_torch.inference import engine
from pmpu_tpu_torch.tools import profile_volume
from tests.test_torch_weights import jax_task_and_variables, port_task

RNG = np.random.default_rng(23)
CUBE = 16


def _volumes(n, cube=CUBE, seed=0):
    rng = np.random.default_rng(seed)
    vols = []
    for _ in range(n):
        v = rng.random((cube, cube, cube)).astype(np.float32)
        v[3:11, 4:12, 2:10] += 0.5
        vols.append(v)
    return vols


@pytest.mark.parametrize("name", ["unet", "probunet"])
def test_pipelined_matches_jax_mean_z(name):
    """The same weights, mean_z, a generator of 3 volumes at depth 2, the
    entropy on: argmax volumes equal to the JAX engine's (host f32), the
    entropy within 1 LSB of the uint16 step."""
    nf = (4, 8)
    jtask, variables = jax_task_and_variables(name, nf, 3)
    task = port_task(name, nf, 3, variables=variables)
    vols = _volumes(3)
    jev = jax_engine.VolumeEvaluator(jtask, eval_batch=20, mean_z=True)
    want = jev.predict_volumes_pipelined(jax.tree_util.tree_map(jnp.asarray, variables),
                                         (v for v in vols), key=jax.random.key(0),
                                         pipeline_depth=2, want_entropy=True)
    ev = engine.VolumeEvaluator(task, eval_batch=20, mean_z=True, device="cpu")
    got = ev.predict_volumes_pipelined((v for v in vols), seed=0, pipeline_depth=2,
                                       want_entropy=True)
    assert len(got) == len(want) == 3
    step = np.log(3) / 65535.0
    for (seg, ent), (jseg, jent) in zip(got, want):
        assert seg.dtype == np.float32 and ent.dtype == np.float32
        np.testing.assert_array_equal(seg, jseg)
        assert np.abs(np.rint(ent / step) - np.rint(np.asarray(jent) / step)).max() <= 1


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_depths_are_bit_equal_in_sampled_mode(depth):
    """Sampled draws (3 chunks a volume): every depth gives each volume
    what ``evaluate_volume`` gives with its derived seed, argmax and
    entropy alike, exactly; the pool holds depth + 1 buffers a shape."""
    task = port_task("probunet")
    vols = _volumes(5, seed=1)
    ev = engine.VolumeEvaluator(task, n_samples=3, eval_batch=16, device="cpu")
    got = ev.predict_volumes_pipelined(iter(vols), seed=4, pipeline_depth=depth,
                                       want_entropy=True)
    ref = engine.VolumeEvaluator(task, n_samples=3, eval_batch=16, device="cpu")
    for i, (seg, ent) in enumerate(got):
        r = ref.evaluate_volume(vols[i], seed=engine.derive_seed(4, i))
        np.testing.assert_array_equal(seg, r["argmax"])
        want = ref._entropy(r["fused"]).numpy().astype(np.float32) * (float(np.log(3)) / 65535.0)
        np.testing.assert_array_equal(ent, want)
    seg_key = ((CUBE, CUBE, CUBE // 4), torch.uint8)
    assert ev._pool.allocated[seg_key] == depth + 1
    assert ev._pool.allocated[((CUBE,) * 3, torch.uint16)] == depth + 1


def test_evaluate_volume_is_a_dispatch_and_a_fetch():
    """The handle holds host copies that are fetched once; Dice comes back
    as (num_views + 1, C - 1) f32; more than 4 classes travel unpacked."""
    task = port_task("unet", n_classes=5)
    ev = engine.VolumeEvaluator(task, device="cpu")
    vol = _volumes(1)[0]
    truth = (vol > 0.9).astype(np.int32)
    h = ev._dispatch_volume(vol, truth, want_entropy=True)
    assert set(h) == {"fused", "views", "argmax_u8", "dice", "entropy", "copied"}
    seg = ev._fetch_seg(h)
    with pytest.raises(KeyError):
        ev._fetch_seg(h)
    r = ev.evaluate_volume(vol, truth)
    np.testing.assert_array_equal(seg, r["argmax"])
    assert r["dice"].shape == (4, 4) and r["dice"].dtype == np.float32
    assert ev._fetch_entropy(h).max() <= np.log(5) + 1e-6


@pytest.mark.parametrize("n_classes", [2, 3, 4])
def test_entropy_matches_jax_within_one_lsb(n_classes):
    """The same probability volume (normalized, and sub-normalized as at
    oblique boundary voxels) through both packages' uint16 entropy."""
    jtask, _ = jax_task_and_variables("unet", (4, 8), n_classes)
    jev = jax_engine.VolumeEvaluator(jtask)
    ev = engine.VolumeEvaluator(port_task("unet", n_classes=n_classes), device="cpu")
    p = RNG.random((12, 12, 12, n_classes)).astype(np.float32) ** 3
    p /= p.sum(-1, keepdims=True)
    p[:3] *= 0.7
    got = ev._entropy(torch.from_numpy(p)).numpy()
    want = np.asarray(jev._entropy(jnp.asarray(p)))
    assert got.dtype == np.uint16
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_entropy_clips_at_full_scale():
    """Sub-normalized vectors can push -sum(p log p) past ln C; the uint16
    wire clips to 65535 instead of wrapping."""
    ev = engine.VolumeEvaluator(port_task("unet", n_classes=1), device="cpu")
    p = torch.full((2, 2, 2, 2), 0.368)  # sums to 0.736; entropy 0.7358 > ln 2
    enc = ev._entropy(p)
    assert enc.dtype == torch.uint16 and int(enc.to(torch.int32).max()) == 65535
    ent = ev._fetch_entropy(ev._copy_to_host({"entropy": enc}))
    assert abs(ent.max() - np.log(2)) < 1e-4


def test_derive_seed_seeds_the_chunks():
    assert engine.chunk_generator(torch.device("cpu"), 3, 1).initial_seed() == \
        engine.derive_seed(3, 1)
    seeds = {engine.derive_seed(s, i) for s in range(3) for i in range(4)}
    assert len(seeds) == 12 and all(0 <= x < 2**63 for x in seeds)


def test_host_pool_reuses_a_buffer_once_given_back():
    pool = engine.HostPool(pinned=False)
    a = pool.take((4, 4), torch.uint8)
    b = pool.take((4, 4), torch.uint8)
    assert a.data_ptr() != b.data_ptr() and pool.allocated[((4, 4), torch.uint8)] == 2
    pool.give(a)
    assert pool.take((4, 4), torch.uint8).data_ptr() == a.data_ptr()
    assert pool.take((2, 8), torch.uint8).shape == (2, 8)
    with torch.inference_mode():
        c = pool.take((3,), torch.float32)
    c.copy_(torch.ones(3))  # a normal tensor, writable outside the mode too
    assert not c.is_inference()


def _event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_profile_groups_and_idle_share():
    """Device time by group and the busy union inside the annotated
    window; events outside it are left out."""
    trace = {"traceEvents": [
        _event("profiled_volume", 100.0, 100.0, "user_annotation"),
        _event("sm90_xmma_fprop_implicit_gemm_bf16_kernel__5x_cudnn", 110.0, 30.0),
        _event("void at::native::batch_norm_transform_input_channels_last_kernel", 120.0, 10.0),
        _event("void at::native::max_pool_forward_nhwc<c10::BFloat16>", 150.0, 5.0),
        _event("void (anonymous namespace)::tc::fcomb_mean_tc_kernel<64>", 160.0, 5.0),
        _event("Memcpy HtoD (Pinned -> Device)", 170.0, 2.0, "gpu_memcpy"),
        _event("void at::native::reduce_kernel<argmax>", 180.0, 4.0),
        _event("void at::native::elementwise_kernel<CUDAFunctor_add>", 300.0, 50.0),
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 105.0, "dur": 50.0},
    ]}
    s = profile_volume.summarize(trace, "profiled_volume")
    assert s["groups_ms"] == {"hand kernels": 0.005, "copies": 0.002, "pools": 0.005,
                              "conv (cuDNN)": 0.03, "batchnorm/relu/add elementwise": 0.01,
                              "other": 0.004}
    assert s["device_ops"] == 6 and s["window_ms"] == 0.1
    assert s["busy_ms"] == pytest.approx(0.046)  # the BN kernel overlaps the conv
    assert s["idle_share"] == pytest.approx(0.54)
    empty = profile_volume.summarize({"traceEvents": trace["traceEvents"][:1]},
                                     "profiled_volume")
    assert empty["idle_share"] is None and empty["busy_ms"] == 0.0
    with pytest.raises(ValueError, match="annotations"):
        profile_volume.summarize(trace, "profiled_stream")


def test_profile_tool_runs_on_the_cpu(tmp_path, capsys):
    """The tool end to end at a tiny size on the CPU: its lines, its two
    traces, and null idle shares (a CPU run has no device to idle)."""
    assert profile_volume.main(["--device", "cpu", "--cube", "8", "--filters", "4,8",
                                "--trace-dir", str(tmp_path)]) == 0
    lines = dict(line.split(" ", 1) for line in capsys.readouterr().out.splitlines()
                 if line.split(" ", 1)[0] in ("UNTRACED", "ENQUEUE", "TRACED", "GROUPS"))
    assert set(lines) == {"UNTRACED", "ENQUEUE", "TRACED", "GROUPS"}
    groups = json.loads(lines["GROUPS"])
    assert groups["device"] == "cpu" and groups["volume"]["idle_share"] is None
    assert groups["stream"]["volumes"] == 4 and groups["stream"]["idle_share"] is None
    assert len(json.loads(lines["ENQUEUE"])["host_enqueue_ms"]) == 3
    for name in ("volume", "stream"):
        assert (tmp_path / name / "trace.json").stat().st_size > 0
