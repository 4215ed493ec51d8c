"""Euroc-MAV Jacobian text files (port of
``mixedprecisionblockqr_tpu/utils/euroc.py``).

File format (``read_euroc_jacobian``; the original CUDA code's
``Cuda/qr.cu:696-776``): a first line ``"<rows> <cols>"``, then one sparse
triplet ``"<row> <col> <value>"`` a line; entries not mentioned are zero.
The original dataset is a git-LFS archive that this checkout holds only as
a pointer, so ``write_euroc_jacobian`` / ``synthesize_dataset`` write files
of the same format from the synthetic SLAM-Jacobian generator.  The parser
is numpy's (the reference's always-correct path); it needs no native
library.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from mixedprecisionblockqr_tpu_torch.utils.datagen import slam_jacobian


def read_dims(path: str) -> Tuple[int, int]:
    """``(rows, cols)`` from a file's first line."""
    with open(path) as f:
        first = f.readline().split()
    return int(first[0]), int(first[1])


def read_euroc_jacobian(path: str) -> Tuple[int, int, np.ndarray]:
    """Parse one Jacobian file into a dense fp32 array: ``(rows, cols,
    matrix)``; values are read in float64 and rounded to fp32 once."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        first = f.readline().split()
        rows, cols = int(first[0]), int(first[1])
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    a = np.zeros((rows, cols), np.float32)
    if data.size:
        r = data[:, 0].astype(np.int64)
        c = data[:, 1].astype(np.int64)
        a[r, c] = data[:, 2].astype(np.float32)
    return rows, cols, a


def write_euroc_jacobian(path: str, a: np.ndarray) -> None:
    """Write a matrix in the sparse-triplet text format (its nonzeros)."""
    rows, cols = a.shape
    r, c = np.nonzero(a)
    with open(path, "w") as f:
        f.write(f"{rows} {cols}\n")
        for ri, ci in zip(r, c):
            f.write(f"{ri} {ci} {a[ri, ci]:.9g}\n")


def synthesize_dataset(
    out_dir: str,
    sizes=((256, 128), (512, 256), (1024, 512), (2000, 1000)),
    start_index: int = 100,
) -> list:
    """Write one ``slam_jacobian(m, n, seed=i)`` file per size into
    ``out_dir``, named ``A_%09d.txt`` from ``start_index`` in steps of 100
    (the dataset's enumeration pattern, ``Cuda/qr.cu:1725-1728``); returns
    the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    idx = start_index
    for i, (m, n) in enumerate(sizes):
        path = os.path.join(out_dir, f"A_{idx:09d}.txt")
        write_euroc_jacobian(path, slam_jacobian(m, n, seed=i))
        paths.append(path)
        idx += 100
    return paths
