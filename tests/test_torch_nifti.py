"""The port's NIfTI codec and volume geometry (``pmpu_tpu_torch.data``)
against the JAX package's (``pmpu_tpu.data``): a file written by either
package reads back equal in the other (headers, data, affines, ``.nii.gz``
too; exact), ``AsyncWriter`` drains and surfaces a write error, and the
geometry helpers give the JAX functions' arrays and affines exactly."""

import struct

import numpy as np
import pytest

from pmpu_tpu.data import nifti as jax_nifti
from pmpu_tpu.data import volumes as jax_volumes
from pmpu_tpu_torch.data import nifti, volumes

RNG = np.random.default_rng(31)
PACKAGES = {"jax": jax_nifti, "port": nifti}
HEADER_FIELDS = ("dim", "datatype", "bitpix", "pixdim", "vox_offset", "scl_slope", "scl_inter",
                 "qform_code", "sform_code", "quatern", "qoffset", "descrip", "magic", "endian",
                 "shape")


def _affine(i=0):
    a = np.diag([0.8 + 0.1 * i, 1.25, 2.0, 1.0])
    a[0, 1] = 0.05 * i
    a[:3, 3] = (-12.5, 4.0 + i, 30.0)
    return a


def _assert_headers_equal(a, b):
    for f in HEADER_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f
    np.testing.assert_array_equal(a.srow, b.srow)
    np.testing.assert_array_equal(a.affine, b.affine)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
def test_files_cross_between_packages(tmp_path, writer, reader, suffix, dtype):
    data = (RNG.random((7, 9, 5)) * 100).astype(dtype)
    path = str(tmp_path / f"v{suffix}")
    PACKAGES[writer].save(path, data, _affine(1))
    w, r = PACKAGES[writer], PACKAGES[reader]
    _assert_headers_equal(r.read_header(path), w.read_header(path))
    got = r.load(path)
    np.testing.assert_array_equal(got, w.load(path))
    np.testing.assert_array_equal(got, data.astype(np.float32))
    np.testing.assert_array_equal(r.load(path, dtype=dtype), data)
    np.testing.assert_allclose(r.read_header(path).affine, _affine(1), rtol=0, atol=1e-6)


def test_save_writes_the_same_bytes(tmp_path):
    data = RNG.random((6, 4, 5)).astype(np.float32)
    for name, pkg in PACKAGES.items():
        pkg.save(str(tmp_path / f"{name}.nii"), data, _affine(2))
    assert (tmp_path / "jax.nii").read_bytes() == (tmp_path / "port.nii").read_bytes()


def _patch(path, fmt, offset, *values):
    raw = bytearray(open(path, "rb").read())
    struct.pack_into(fmt, raw, offset, *values)
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("case", ["scaled", "qform", "pixdim_only", "nan_slope", "big_endian"])
def test_headers_of_other_writers_read_alike(tmp_path, case):
    """scl_slope/inter, a quaternion qform, pixdim-only spacing, unset
    (NaN) scaling and a big-endian file: both packages agree exactly."""
    path = str(tmp_path / "v.nii")
    data = (RNG.random((5, 6, 4)) * 50).astype(np.int16)
    jax_nifti.save(path, data, _affine(3))
    if case == "scaled":
        _patch(path, "<2f", 112, 0.5, -3.0)
    elif case == "qform":
        _patch(path, "<2h", 252, 1, 0)
        _patch(path, "<6f", 256, 0.1, -0.2, 0.3, 5.0, 6.0, 7.0)
        _patch(path, "<f", 76, -1.0)  # qfac
    elif case == "pixdim_only":
        _patch(path, "<2h", 252, 0, 0)
    elif case == "nan_slope":
        _patch(path, "<2f", 112, float("nan"), 4.0)
    else:
        raw = bytearray(open(path, "rb").read())
        hdr = jax_nifti.read_header(path)
        out = bytearray(raw)
        for off, fmt in ((0, "i"), (40, "8h"), (70, "h"), (72, "h"), (76, "8f"), (108, "f"),
                         (112, "f"), (116, "f"), (252, "h"), (254, "h"), (256, "3f"),
                         (268, "3f"), (280, "4f"), (296, "4f"), (312, "4f")):
            struct.pack_into(">" + fmt, out, off, *struct.unpack_from("<" + fmt, raw, off))
        out[352:] = data.astype(">i2").tobytes(order="F")
        open(path, "wb").write(bytes(out))
        assert hdr.shape == (5, 6, 4)
    _assert_headers_equal(nifti.read_header(path), jax_nifti.read_header(path))
    np.testing.assert_array_equal(nifti.load(path), jax_nifti.load(path))
    if case == "big_endian":
        assert nifti.read_header(path).endian == ">"
        np.testing.assert_array_equal(nifti.load(path), data.astype(np.float32))


@pytest.mark.parametrize("corruption", ["truncated", "magic", "pair", "dim", "vox_offset"])
def test_corrupt_files_raise_alike(tmp_path, corruption):
    path = str(tmp_path / "v.nii")
    jax_nifti.save(path, np.zeros((3, 3, 3), np.float32))
    if corruption == "truncated":
        open(path, "wb").write(open(path, "rb").read()[:200])
    elif corruption == "magic":
        _patch(path, "4s", 344, b"xx1\x00")
    elif corruption == "pair":
        _patch(path, "4s", 344, b"ni1\x00")
    elif corruption == "dim":
        _patch(path, "<2h", 40, 3, -3)
    else:
        _patch(path, "<f", 108, 12.0)
    with pytest.raises(ValueError) as want:
        jax_nifti.load(path)
    with pytest.raises(ValueError) as got:
        nifti.load(path)
    assert str(got.value) == str(want.value)


def test_is_nifti_name():
    for name in ("a.nii", "b.nii.gz", "c.img", "d.nii.bak", "e.gz", "f"):
        assert nifti.is_nifti_name(name) == jax_nifti.is_nifti_name(name)


def test_async_writer_drains(tmp_path):
    vols = [RNG.random((4, 5, 6)).astype(np.float32) for _ in range(6)]
    with nifti.AsyncWriter(max_pending=2) as w:
        for i, v in enumerate(vols):
            w.save(str(tmp_path / "out" / f"v{i}.nii.gz"), v, _affine(i))
    for i, v in enumerate(vols):
        path = str(tmp_path / "out" / f"v{i}.nii.gz")
        np.testing.assert_array_equal(jax_nifti.load(path), v)
        np.testing.assert_allclose(jax_nifti.read_header(path).affine, _affine(i), atol=1e-6)


def test_async_writer_surfaces_a_write_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    w = nifti.AsyncWriter()
    w.save(str(blocker / "v.nii"), np.zeros((2, 2, 2), np.float32))
    with pytest.raises(OSError):
        w.close()
    with pytest.raises(RuntimeError, match="after close"):
        w.save(str(tmp_path / "v.nii"), np.zeros((2, 2, 2), np.float32))
    # an error inside the block is not masked by the write error
    with pytest.raises(KeyError):
        with nifti.AsyncWriter() as w2:
            w2.save(str(blocker / "w.nii"), np.zeros((2, 2, 2), np.float32))
            raise KeyError("inside")


@pytest.mark.parametrize("shape", [(7, 9, 5), (12, 3, 12), (1, 1, 4), (6, 6, 6), (5, 8, 3, 1)])
def test_geometry_matches_jax(tmp_path, shape):
    vol = RNG.random(shape).astype(np.float32)
    np.testing.assert_array_equal(volumes.pad_to_cube(vol), jax_volumes.pad_to_cube(vol))
    cube = max(shape) + 3
    padded = volumes.pad_to_cube(vol, cube)
    np.testing.assert_array_equal(padded, jax_volumes.pad_to_cube(vol, cube))
    path = str(tmp_path / "v.nii")
    jax_nifti.save(path, vol, _affine(4))
    geom = volumes.geom_from_header(nifti.read_header(path), path)
    jgeom = jax_volumes.geom_from_header(jax_nifti.read_header(path), path)
    assert geom.shape == jgeom.shape == shape[:3]
    np.testing.assert_array_equal(geom.affine, jgeom.affine)
    for g, jg, identity in ((geom, jgeom, False), (geom, jgeom, True), (None, None, False)):
        arr, aff = volumes.restore_geometry(padded, g, identity)
        jarr, jaff = jax_volumes.restore_geometry(padded, jg, identity)
        np.testing.assert_array_equal(arr, jarr)
        assert (aff is None) == (jaff is None)
        if aff is not None:
            np.testing.assert_array_equal(aff, jaff)
            np.testing.assert_array_equal(arr, vol.reshape(shape[:3]))
            assert arr.flags.c_contiguous


def test_geometry_rejects_what_jax_rejects():
    for bad, size in ((np.zeros((4, 4, 4, 2)), None), (np.zeros((4, 4)), None),
                      (np.zeros((5, 4, 4)), 4)):
        with pytest.raises(ValueError):
            jax_volumes.pad_to_cube(bad, size)
        with pytest.raises(ValueError):
            volumes.pad_to_cube(bad, size)
    with pytest.raises(ValueError, match="3-D"):
        volumes.geom_from_header(nifti.NiftiHeader(dim=(4, 3, 3, 3, 2, 1, 1, 1)), "x.nii")
