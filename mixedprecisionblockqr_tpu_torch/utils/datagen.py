"""Test/benchmark matrix generation (port of the JAX package's generators).

``random_matrix`` draws from an explicit ``torch.Generator`` on the device
it is given; it does not reproduce ``jax.random``'s numbers, so tests that
compare the two packages build their inputs with numpy and hand the same
array to both.  The other generators are numpy-only copies of the JAX
package's and return the same arrays for the same seeds.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch


def random_matrix(
    generator: torch.Generator,
    m: int,
    n: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Uniform [0, 1) random matrix (``h_generate_random_matrix``,
    ``Cuda/mmult.cuh:38-68``) on ``device`` (default: the generator's)."""
    device = generator.device if device is None else device
    return torch.rand((m, n), generator=generator, dtype=torch.float32,
                      device=device).to(dtype)


def conditioned_matrix(
    n: int, condition_number: float = 100.0, seed: int = 0
) -> np.ndarray:
    """Random SPD matrix with cond(P) == condition_number exactly
    (Bierlaire, Toint & Tuyttens 1991; ``python/utils.py:13-24``)."""
    rng = np.random.default_rng(seed)
    cond_p = float(condition_number)
    log_cond = np.log(cond_p)
    exp_vec = np.arange(
        -log_cond / 4.0,
        log_cond * (n + 1) / (4.0 * (n - 1)),
        log_cond / (2.0 * (n - 1)),
    )[:n]
    s = np.exp(exp_vec)
    u, _ = np.linalg.qr((rng.random((n, n)) - 5.0) * 200.0)
    v, _ = np.linalg.qr((rng.random((n, n)) - 5.0) * 200.0)
    p = u @ np.diag(s) @ v.T
    return (p @ p.T).astype(np.float64)


def general_fixtures() -> List[np.ndarray]:
    """The reference's general test matrices (``python/test_data.py:4-36``)."""
    rng = np.random.default_rng(0)
    return [
        np.array([[1, 2, 3], [4, 5, 6], [7, 8, 7], [4, 2, 3], [4, 2, 2]],
                 float),
        np.array([[0, 3, 1], [0, 4, -2], [2, 1, 1]], float),
        np.array([[12, -51, 4], [6, 167, -68], [-4, 24, -41]], float),
        np.array(
            [
                [10, 20, 30, 40, 50, 60],
                [32, 32, 44, 55, 66, 35],
                [23, 66, 74, 64, 45, 65],
                [67, 28, 46, 26, 46, 42],
                [95, 95, 52, 88, 65, 11],
                [75, 53, 96, 47, 32, 32],
            ],
            float,
        ),
        rng.random((10, 10)),
        rng.random((100, 100)),
        rng.random((200, 100)),
        rng.random((300, 100)),
        conditioned_matrix(100, 100.0),
    ]


def strange_fixtures() -> List[np.ndarray]:
    """Edge cases: rank-deficient, diagonal, zero rows
    (``python/test_data.py:38-57``)."""
    return [
        np.array([[1, 2, 3], [1, 2, 3], [1, 2, 3]], float),
        np.array([[1, 0, 0], [0, 2, 0], [0, 0, 3]], float),
        np.array([[1, 2, 3], [0, 0, 0], [0, 0, 0]], float),
    ]


# The reference's static QR problem-size table: (m, n, block_size)
# (``test_qr_by_random_matrix``, ``Cuda/qr.cu:1762-1787``).
STATIC_QR_SIZES: List[Tuple[int, int, int]] = [
    (6, 4, 2), (6, 4, 1), (6, 4, 3), (12, 8, 4), (12, 8, 5), (12, 8, 6),
    (12, 8, 2), (12, 8, 8), (12, 8, 3), (24, 16, 8), (24, 16, 12),
    (60, 40, 8), (60, 40, 16), (80, 80, 16), (97, 90, 16), (100, 80, 16),
    (128, 80, 16), (129, 80, 16), (240, 160, 16), (600, 400, 16),
]


def slam_jacobian(
    m: int, n: int, seed: int = 0, density: float = 0.05
) -> np.ndarray:
    """Synthetic bundle-adjustment-style Jacobian: a block-sparse tall
    matrix with a dense column strip (camera poses) and scattered landmark
    entries."""
    rng = np.random.default_rng(seed)
    a = np.zeros((m, n), np.float32)
    pose_cols = max(1, n // 8)
    a[:, :pose_cols] = rng.standard_normal((m, pose_cols)).astype(np.float32)
    nnz_per_row = max(1, int(density * (n - pose_cols)))
    for i in range(m):
        cols = rng.choice(n - pose_cols, size=nnz_per_row,
                          replace=False) + pose_cols
        a[i, cols] = rng.standard_normal(nnz_per_row).astype(np.float32)
    return a


def gauge_deficient_system(
    m: int, n: int, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """A rank-deficient least-squares system ``(J, b)``, as an undamped
    bundle adjustment gives one: ``slam_jacobian(m, n, seed=0)`` with its
    last k columns replaced by combinations of its first k (drawn with
    ``default_rng(1)``), rank n - k, and b from ``default_rng(2)``."""
    J = slam_jacobian(m, n, seed=0)
    C = np.random.default_rng(1).standard_normal((k, k)).astype(np.float32)
    J[:, -k:] = J[:, :k] @ C
    b = np.random.default_rng(2).standard_normal(m).astype(np.float32)
    return J, b


def size_sweep(start: int = 64, stop: int = 2048,
               factor: int = 2) -> Iterator[int]:
    """Geometric size sweep (the reference sweeps sizes in its test
    iterators, ``Cuda/qr.cu:1910-1959``)."""
    s = start
    while s <= stop:
        yield s
        s *= factor
