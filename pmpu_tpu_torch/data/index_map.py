"""Flat (scan, view, slice) index map with empty-slice filtering: the port's
copy of ``pmpu_tpu/data/index_map.py`` (plain numpy, the same arrays).

Triples come scan-major, then view, then slice (the reference's
``mri_dataset.py:37-49``); with ``filter`` a slice is kept iff its label
plane has foreground (``max > 0``).
"""

from __future__ import annotations

import numpy as np

NUM_VIEWS = 3


def nonempty_table(labels: np.ndarray) -> np.ndarray:
    """(N, 3, S) bool: does (scan, view, slice) contain any foreground?"""
    n, s = labels.shape[0], labels.shape[1]
    table = np.empty((n, NUM_VIEWS, s), dtype=bool)
    table[:, 0] = labels.max(axis=(2, 3)) > 0
    table[:, 1] = labels.max(axis=(1, 3)) > 0
    table[:, 2] = labels.max(axis=(1, 2)) > 0
    return table


def build_index_map_from_table(table: np.ndarray, filter: bool = True) -> np.ndarray:
    """(N,V,S) nonempty table → (M,3) int32 (scan, view, slice) triples."""
    n, v, s = table.shape
    scans, views, slices = np.meshgrid(
        np.arange(n), np.arange(v), np.arange(s), indexing="ij"
    )
    triples = np.stack([scans.ravel(), views.ravel(), slices.ravel()], axis=1).astype(np.int32)
    if filter:
        triples = triples[table.ravel()]
    return triples


def build_index_map(labels: np.ndarray, filter: bool = True) -> np.ndarray:
    """(M, 3) int32 (scan, view, slice) triples of an (N,S,S,S) label stack."""
    if not filter:
        shape = (labels.shape[0], NUM_VIEWS, labels.shape[1])
        return build_index_map_from_table(np.empty(shape, dtype=bool), filter=False)
    return build_index_map_from_table(nonempty_table(labels), filter=True)
