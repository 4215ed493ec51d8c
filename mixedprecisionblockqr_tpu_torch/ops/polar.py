"""Newton-Schulz iteration budgets (port of the budget part of
``mixedprecisionblockqr_tpu/ops/polar.py``).

The calibration is copied exactly: the blocked factorizations' panels see the
trailing corner's conditioning, and at aspect 8 a 6-iteration chain once
under-converged and poisoned silently, hence one extra iteration per halved
aspect below 16.
"""

from __future__ import annotations


def tri_iters_for_aspect(aspect: float) -> int:
    """Iteration count of a triangular-NS chain by panel aspect (m/r):
    6 at aspect >= 16, 7 at >= 8, 8 at >= 4, else 9."""
    if aspect >= 16:
        return 6
    if aspect >= 8:
        return 7
    if aspect >= 4:
        return 8
    return 9


def tri_head_iters(iters: int) -> int:
    """Chain budget of a factorization's FIRST panel: ``iters + 6``.  The head
    panel factors raw data, whose correlated columns give its Jacobi-scaled
    Gram an outlier spectrum (cond ~1e3 for uniform [0, 1) data); every
    later panel has been projected first."""
    return iters + 6


def ns_omega_iters(iters: int) -> int:
    """How many early iterations run over-relaxed (omega = 1.5):
    ``min(4, max(0, iters - 4))``.  omega = 2 would be neutrally stable at
    the fixed point, so it stays at 1.5 and the final iterations are
    plain."""
    return min(4, max(0, iters - 4))
