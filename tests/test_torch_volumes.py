"""The port's host data path (``pmpu_tpu_torch.data.native`` and
``VolumeStore``) on the CPU against the JAX package: the same NIfTI tree
gives byte-equal images, labels, ids, cube and geometries through the
native loader and the numpy reader; the shape guard and the header
fallback behave as in ``tests/test_native_io.py``; an out-of-core pool built
by either package reopens in the other without a rebuild.

The JAX store is always read through the JAX package's numpy reader
(``_jax_store``), which ``tests/test_native_io.py`` holds byte-equal to
its native reader. The JAX native library is built in place by ``make`` at
first use, and a test process that loads it while another process is
still writing it pins it as unavailable for the rest of that process."""

import os

import numpy as np
import pytest

from pmpu_tpu.data import nifti as jax_nifti
from pmpu_tpu.data.volumes import VolumeStore as JaxStore
from pmpu_tpu_torch.data import native
from pmpu_tpu_torch.data.volumes import VolumeStore
from tests.test_native_io import _write_big_endian_pair

SHAPES = ((12, 16, 10), (16, 9, 14), (11, 13, 16))


def _tree(root, suffixes=(".nii", ".nii.gz", ".nii")):
    """Images of mixed shapes, affines and suffixes with 3-class labels."""
    rng = np.random.default_rng(17)
    for sub in ("images", "labels"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i, (shape, suffix) in enumerate(zip(SHAPES, suffixes)):
        affine = np.diag([1.0 + 0.25 * i, 0.8, 1.5, 1.0])
        affine[:3, 3] = (2.0 * i, -5.0, 1.0)
        img = (rng.random(shape) * 40).astype(np.float32)
        lbl = rng.integers(0, 3, size=shape).astype(np.int16)
        jax_nifti.save(root / "images" / f"v{i}{suffix}", img, affine)
        jax_nifti.save(root / "labels" / f"v{i}{suffix}", lbl)
    return root / "images", root / "labels"


def _jax_store(imgs, lbls, **kw):
    """The JAX package's store from its numpy reader (see the module
    docstring)."""
    return JaxStore.from_dirs(imgs, lbls, use_native=False, **kw)


def _assert_same_store(got, want):
    assert got.images.dtype == want.images.dtype == np.float32
    assert got.labels.dtype == want.labels.dtype == np.int32
    assert got.images.tobytes() == np.asarray(want.images).tobytes()
    assert got.labels.tobytes() == np.asarray(want.labels).tobytes()
    assert got.ids == want.ids and got.cube == want.cube
    assert len(got.geoms) == len(want.geoms)
    for g, w in zip(got.geoms, want.geoms):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.affine, w.affine)


def test_native_builds_from_source():
    """The loader is built from ``native/pmpu_io.cpp`` into the port's own
    build directory, never from or into ``native/``."""
    assert native.available()
    lib = native.target()
    assert native.get_lib()._name == str(lib) and lib.exists()
    assert lib.parent == native.BUILD_DIR and native.BUILD_DIR.parent.name == "data"


@pytest.mark.parametrize("use_native", [True, False])
def test_from_dirs_matches_jax(tmp_path, use_native):
    imgs, lbls = _tree(tmp_path)
    got = VolumeStore.from_dirs(imgs, lbls, use_native=use_native)
    _assert_same_store(got, _jax_store(imgs, lbls))
    assert got.cube == 16 and got.images.shape == (3, 16, 16, 16)
    assert got.image_dims == (16, 16, 16) and got.slices_per_volume == 48
    # names and a forced cube, as the per-host loading passes them
    sub = VolumeStore.from_dirs(imgs, lbls, use_native=use_native, names=["v1.nii.gz"],
                                cube=20)
    _assert_same_store(sub, _jax_store(imgs, lbls, names=["v1.nii.gz"], cube=20))


def test_native_and_numpy_readers_agree(tmp_path):
    imgs, lbls = _tree(tmp_path)
    a = VolumeStore.from_dirs(imgs, lbls, use_native=True)
    b = VolumeStore.from_dirs(imgs, lbls, use_native=False)
    assert a.images.tobytes() == b.images.tobytes()
    assert a.labels.tobytes() == b.labels.tobytes()
    np.testing.assert_array_equal(
        native.load_volume(str(imgs / "v1.nii.gz")), jax_nifti.load(imgs / "v1.nii.gz"))


@pytest.mark.parametrize("use_native", [True, False])
def test_shape_mismatch_raises(tmp_path, use_native):
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    jax_nifti.save(tmp_path / "images" / "v.nii", np.ones((6, 6, 6), np.float32))
    jax_nifti.save(tmp_path / "labels" / "v.nii", np.zeros((4, 4, 4), np.float32))
    with pytest.raises(ValueError, match="image .* != label"):
        VolumeStore.from_dirs(tmp_path / "images", tmp_path / "labels", use_native=use_native)
    with pytest.raises(ValueError, match="image .* != label"):
        VolumeStore.from_dirs(tmp_path / "images", tmp_path / "labels",
                              mmap_dir=str(tmp_path / "pool"))


def test_native_header_error_falls_back(tmp_path):
    """A big-endian pair: the default falls back to the numpy reader (as
    the JAX store does); ``use_native=True`` raises."""
    data = _write_big_endian_pair(tmp_path)
    store = VolumeStore.from_dirs(tmp_path / "images", tmp_path / "labels")
    assert store.images.shape == (1, 4, 4, 4)
    np.testing.assert_array_equal(store.images[0, :2, :3, :4], data)
    _assert_same_store(store, _jax_store(tmp_path / "images", tmp_path / "labels"))
    with pytest.raises(ValueError):
        VolumeStore.from_dirs(tmp_path / "images", tmp_path / "labels", use_native=True)


def _pool_stamp(pool):
    return {n: os.stat(os.path.join(pool, n)).st_mtime_ns
            for n in ("images.dat", "labels.dat", "manifest.json")}


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_mmap_pool_crosses_packages(tmp_path, builder):
    """A pool built by one package reopens read-only in the other, its
    files untouched, with the in-RAM store's arrays; a changed source
    rebuilds it."""
    imgs, lbls = _tree(tmp_path)
    pool = str(tmp_path / "pool")
    port = VolumeStore.from_dirs
    build, reopen = (_jax_store, port) if builder == "jax" else (port, _jax_store)
    built = build(imgs, lbls, mmap_dir=pool)
    stamp = _pool_stamp(pool)
    again = reopen(imgs, lbls, mmap_dir=pool)
    assert _pool_stamp(pool) == stamp
    assert isinstance(again.images, np.memmap) and again.images.mode == "r"
    ram = VolumeStore.from_dirs(imgs, lbls)
    for store in (built, again):
        _assert_same_store(store, ram)
    jax_nifti.save(imgs / "v0.nii", np.ones(SHAPES[0], np.float32))
    rebuilt = VolumeStore.from_dirs(imgs, lbls, mmap_dir=pool)
    assert _pool_stamp(pool)["manifest.json"] != stamp["manifest.json"]
    np.testing.assert_array_equal(rebuilt.images[0, :12, :16, :10], 1.0)


def test_from_arrays_matches_jax():
    rng = np.random.default_rng(3)
    imgs, lbls = rng.random((2, 8, 8, 8)), rng.integers(0, 3, (2, 8, 8, 8))
    got, want = VolumeStore.from_arrays(imgs, lbls), JaxStore.from_arrays(imgs, lbls)
    assert got.images.tobytes() == want.images.tobytes()
    assert got.labels.tobytes() == want.labels.tobytes()
    assert got.ids == want.ids == ["vol0.nii", "vol1.nii"] and got.cube == 8
    assert got.geoms is None and len(got) == 2


def test_without_a_compiler_the_numpy_reader_serves(tmp_path, monkeypatch, caplog):
    """When the library cannot be built the store falls back to the numpy
    reader, logged once; ``use_native=True`` raises."""
    imgs, lbls = _tree(tmp_path)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    native.get_lib.cache_clear()
    try:
        with caplog.at_level("WARNING", logger=native.__name__):
            store = VolumeStore.from_dirs(imgs, lbls)
            VolumeStore.from_dirs(imgs, lbls)
        assert not native.available()
        assert sum("native NIfTI loader unavailable" in r.message for r in caplog.records) == 1
        _assert_same_store(store, _jax_store(imgs, lbls))
        with pytest.raises(RuntimeError, match="native io requested but unavailable"):
            VolumeStore.from_dirs(imgs, lbls, use_native=True)
    finally:
        native.get_lib.cache_clear()
