"""Volume slice viewer of the port (counterpart of the JAX package's
``tools/slicer.py``; reference ``Utils/slicer.py``). It uses no device:
numpy, matplotlib and ``pmpu_tpu_torch.data.nifti``.

Two modes:
* ``--dump`` (default): write axial.png / coronal.png / sagittal.png
  center-slice panels for a prediction (and optional truth side-by-side) —
  the reference's PNG dump (``Utils/slicer.py:107-134``).
* ``--interactive``: j/k-keyed 2-pane pred-vs-truth browser
  (``Utils/slicer.py:80-105``) when a display is available.

    python -m pmpu_tpu_torch.tools.slicer pred.nii [truth.nii] [--slice N]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pmpu_tpu_torch.data import nifti

VIEWS = [("axial", 0), ("coronal", 1), ("sagittal", 2)]


def center_slice(vol: np.ndarray, axis: int, idx: int | None = None) -> np.ndarray:
    idx = vol.shape[axis] // 2 if idx is None else idx
    return np.take(vol, idx, axis=axis)


def dump_panels(pred: np.ndarray, truth: np.ndarray | None, idx: int | None, outdir: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for name, axis in VIEWS:
        cols = 2 if truth is not None else 1
        fig, ax = plt.subplots(1, cols, figsize=(5 * cols, 5))
        axes = np.atleast_1d(ax)
        axes[0].imshow(center_slice(pred, axis, idx), cmap="viridis")
        axes[0].set_title(f"prediction ({name})")
        if truth is not None:
            axes[1].imshow(center_slice(truth, axis, idx), cmap="viridis")
            axes[1].set_title(f"truth ({name})")
        for a in axes:
            a.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, f"{name}.png"), dpi=120)
        plt.close(fig)
        print(f"wrote {os.path.join(outdir, name + '.png')}")


def interactive(pred: np.ndarray, truth: np.ndarray | None):
    """j/k slice browser — reference ``multi_slice_viewer`` semantics."""
    import matplotlib.pyplot as plt

    state = {"idx": pred.shape[0] // 2}
    cols = 2 if truth is not None else 1
    fig, ax = plt.subplots(1, cols)
    axes = np.atleast_1d(ax)

    def redraw():
        axes[0].images[0].set_array(pred[state["idx"]])
        if truth is not None:
            axes[1].images[0].set_array(truth[state["idx"]])
        fig.suptitle(f"slice {state['idx']}")
        fig.canvas.draw()

    axes[0].imshow(pred[state["idx"]], cmap="viridis")
    if truth is not None:
        axes[1].imshow(truth[state["idx"]], cmap="viridis")

    def on_key(event):
        if event.key == "j":
            state["idx"] = (state["idx"] - 1) % pred.shape[0]
        elif event.key == "k":
            state["idx"] = (state["idx"] + 1) % pred.shape[0]
        redraw()

    fig.canvas.mpl_connect("key_press_event", on_key)
    plt.show()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("pred")
    ap.add_argument("truth", nargs="?", default=None)
    ap.add_argument("--slice", type=int, default=None)
    ap.add_argument("--out", default=".")
    ap.add_argument("--interactive", action="store_true")
    a = ap.parse_args()
    pred = nifti.load(a.pred)
    truth = nifti.load(a.truth) if a.truth else None
    if a.interactive:
        interactive(pred, truth)
    else:
        dump_panels(pred, truth, a.slice, a.out)
