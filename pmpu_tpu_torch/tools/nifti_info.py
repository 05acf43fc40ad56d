"""NIfTI header/orientation quick-look of the port (counterpart of the JAX
package's ``tools/nifti_info.py``; reference ``Utils/nifti.py``). It uses
no device: numpy, matplotlib and ``pmpu_tpu_torch.data.nifti``.

Prints header fields (dims, spacing, datatype, range, scl, qform/sform)
plus the reference's first-axis L/R orientation decode
(``Utils/nifti.py:66-84``), and optionally writes the reference's
4-panel figure (``Utils/nifti.py:88-212``): rot90'd coronal / sagittal /
axial mid-slices with pixdim aspect ratios and mid-point crosshairs, and
a text panel with dims / spacing / volumes / dtype / range and the
rounded sform+qform matrices. NaN voxels display as 0 and 4-D files show
their first volume, as in the reference (``Utils/nifti.py:30-40``).
Deliberate divergence (docs/DESIGN.md): non-interactive — writes a PNG
instead of opening a plt.show() window.

    python -m pmpu_tpu_torch.tools.nifti_info vol.nii [--fig out.png]
"""

from __future__ import annotations

import argparse

import numpy as np

from pmpu_tpu_torch.data import nifti

_DT_NAMES = {2: "uint8", 4: "int16", 8: "int32", 16: "float32", 64: "float64",
             256: "int8", 512: "uint16", 768: "uint32", 1024: "int64", 1280: "uint64"}


def _orientation(hdr) -> tuple[str, str]:
    """First-axis handedness decode (reference ``Utils/nifti.py:66-84``):
    negative X scaling in whichever of qform/sform is set → left side of
    the image is the subject's Right. Neither set → unknown."""
    sfx = float(hdr.srow[0, 0]) if hdr.sform_code > 0 else 0.0
    qfx = float(hdr.qform_affine[0, 0]) if hdr.qform_code > 0 else 0.0
    if (qfx < 0 and sfx <= 0) or (sfx < 0 and qfx <= 0):
        return "R", "L"
    if (qfx > 0 and sfx >= 0) or (sfx > 0 and qfx >= 0):
        return "L", "R"
    return "?", "?"


def _info_text(hdr, data) -> str:
    """The reference's text panel (``Utils/nifti.py:149-194``)."""
    sp = tuple(round(float(p), 2) for p in hdr.pixdim[1:4])
    nvol = hdr.shape[3] if len(hdr.shape) > 3 else 1
    mat = np.round(np.asarray(hdr.affine, np.float64), 2)
    lines = [
        "Dimensions: " + " x ".join(str(s) for s in data.shape),
        f"Spacing: {sp[0]} x {sp[1]} x {sp[2]} mm",
        f"Volumes: {nvol}",
        f"Data type: {_DT_NAMES.get(hdr.datatype, hdr.datatype)}",
        f"Range: {round(float(data.min()), 2)} - {round(float(data.max()), 2)}",
        "",
        f"sform code: {hdr.sform_code}",
        np.array2string(mat, precision=2, suppress_small=True),
        "",
        f"qform code: {hdr.qform_code}",
        np.array2string(
            np.round(np.asarray(hdr.qform_affine, np.float64), 2),
            precision=2, suppress_small=True,
        ),
    ]
    return "\n".join(lines)


def _figure(path, hdr, out):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.asarray(nifti.load(path))
    if data.ndim == 4:  # 4-D: first volume (Utils/nifti.py:33-35)
        data = data[:, :, :, 0]
    data = np.nan_to_num(data, nan=0.0)  # Utils/nifti.py:40

    sx, sy, sz = (float(p) or 1.0 for p in hdr.pixdim[1:4])
    lx, ly, lz = data.shape
    mx, my, mz = lx // 2, ly // 2, lz // 2
    ol, _orr = _orientation(hdr)

    plt.style.use("dark_background")
    fig = plt.figure(facecolor="black", figsize=(5, 4), dpi=200)

    # coronal / sagittal / axial mid-slices, rot90 + spacing aspect,
    # dotted mid-point crosshairs (Utils/nifti.py:104-143)
    panels = [
        (data[:, my, :], sz / sx, (lz / 2.0, lx, lx / 2.0, lz)),
        (data[mx, :, :], sz / sy, (lz / 2.0, ly, ly / 2.0, lz)),
        (data[:, :, mz], sy / sx, (ly / 2.0, lx, lx / 2.0, ly)),
    ]
    for i, (sl, aspect, (hy, hxmax, vx, vymax)) in enumerate(panels):
        ax = fig.add_subplot(2, 2, i + 1)
        ax.imshow(np.rot90(sl), aspect=aspect, cmap="gray")
        ax.hlines(hy, 0, hxmax, colors="red", linestyles="dotted", linewidth=0.5)
        ax.vlines(vx, 0, vymax, colors="red", linestyles="dotted", linewidth=0.5)
        ax.axis("off")
        if i == 2:  # label rides the AXIAL panel (Utils/nifti.py:143-145)
            ax.text(-10, my + 5, ol, fontsize=9, color="red", clip_on=False)

    ax4 = fig.add_subplot(2, 2, 4)
    ax4.text(0.15, 0.95, _info_text(hdr, data), ha="left", va="top",
             size=6, color="white")
    ax4.axis("off")
    fig.subplots_adjust(left=0, bottom=0, right=1, top=1, wspace=0, hspace=0)
    fig.savefig(out, dpi=200, facecolor="black")
    plt.close(fig)
    print(f"wrote {out}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--fig", default=None, help="write the 4-panel figure")
    a = ap.parse_args()

    hdr = nifti.read_header(a.path)
    ol, orr = _orientation(hdr)
    print(f"file        : {a.path}")
    print(f"shape       : {hdr.shape}")
    print(f"datatype    : {hdr.datatype} ({_DT_NAMES.get(hdr.datatype, '?')}), bitpix {hdr.bitpix}")
    print(f"pixdim      : {tuple(round(p, 4) for p in hdr.pixdim[1:4])}")
    print(f"vox_offset  : {hdr.vox_offset}")
    print(f"scl slope/in: {hdr.scl_slope} / {hdr.scl_inter}")
    print(f"qform/sform : {hdr.qform_code} / {hdr.sform_code}")
    print(f"orientation : image-left={ol} image-right={orr} (first-axis sign)")
    print("affine      :")
    for row in hdr.affine:
        print("   ", np.array2string(row, precision=3))

    if a.fig:
        _figure(a.path, hdr, a.fig)


if __name__ == "__main__":
    main()
