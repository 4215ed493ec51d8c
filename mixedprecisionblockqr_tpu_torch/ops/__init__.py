"""Factorization routines, dtype policies, metrics and kernels (the CUDA
kernels and their plain versions in ``ops.kernels``)."""

from mixedprecisionblockqr_tpu_torch.ops import (
    blockqr,
    givens,
    householder,
    metrics,
    policy,
    wy,
)

__all__ = ["householder", "wy", "blockqr", "givens", "metrics", "policy"]
