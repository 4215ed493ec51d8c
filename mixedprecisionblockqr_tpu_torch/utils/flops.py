"""Analytic FLOP model for Householder QR.

Same model the reference uses for its GFLOP/s reporting
(``h_qr_flops_per_second``, ``Cuda/qr.cu:102-113``; derivation in
``python/flops.py`` and ``LaTeX/QR_Decomposition.tex`` §FLOPS):

    flops(m, n) = 4 m^2 n - m n^2 + n^3 / 3
"""

from __future__ import annotations


def qr_flops(m: int, n: int) -> float:
    return 4.0 * m * m * n - m * n * n + (n ** 3) / 3.0


def qr_flops_per_second(seconds: float, m: int, n: int) -> float:
    """FLOP/s given wall time (the reference takes milliseconds,
    ``Cuda/qr.cu:102``; we take seconds)."""
    return qr_flops(m, n) / seconds


def tsqr_flops(m: int, n: int) -> float:
    """Tall-skinny QR flops ~ 2 m n^2 (leaf QRs dominate; tree is O(n^3 log))."""
    return 2.0 * m * n * n
