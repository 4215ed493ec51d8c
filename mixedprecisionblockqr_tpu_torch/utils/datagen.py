"""Test/benchmark matrix generation (port of the JAX package's generators).

``random_matrix`` draws from an explicit ``torch.Generator`` on the device
it is given; it does not reproduce ``jax.random``'s numbers, so tests that
compare the two packages build their inputs with numpy and hand the same
array to both.
"""

from __future__ import annotations

from typing import Optional

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
