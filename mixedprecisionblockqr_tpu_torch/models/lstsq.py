"""QR-based linear least squares (port of
``mixedprecisionblockqr_tpu/models/lstsq.py``).

``lstsq`` factors with ``block_qr_qtb`` (b rides through the panel
updates, Q is never formed), checks R's diagonal for decay and, on a
rank-deficient system, reroutes to ``lstsq_pivoted``: the min-norm
solution through a pivoted QR (RQRCP at n >= 512) and a complete
orthogonal decomposition.  Not ported yet: ``method='tsqr'`` and
``refine_steps > 0`` (ROADMAP Queue 1 item 11, ``parallel/``),
``lstsq_batched`` and the recursive-least-squares functions (items 9-10),
``lstsq_autodiff`` (item 9).
"""

from __future__ import annotations

from typing import Optional

import torch

from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
    DEFAULT_BLOCK_SIZE,
    block_qr_qtb,
    qr,
)
from mixedprecisionblockqr_tpu_torch.ops.pivoted import (
    numerical_rank,
    pivoted_qr_qtb,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import (
    DTypePolicy,
    POLICY_FP32,
    mm_f32,
)
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

_EPS = torch.finfo(torch.float32).eps
_PARALLEL_ITEM = "ROADMAP Queue 1 item 11 (parallel/: tsqr, caqr)"


def back_substitution(R, b, lower: bool = False, block_size: int = 64,
                      device=None):
    """Solve the triangular system ``R x = b`` (upper by default; ``lower``
    flips the problem to the upper case) in fp32: the diagonal r x r blocks
    by a triangular solve, the eliminations between blocks by products.
    ``device`` as in ``utils/device.py``."""
    R = as_device_tensor(R, device)
    b = torch.as_tensor(b, device=R.device)
    if lower:
        x = _back_substitution(R.flip(0, 1), b.flip(0), block_size)
        return x.flip(0)
    return _back_substitution(R, b, block_size)


def _back_substitution(R: torch.Tensor, b: torch.Tensor, block_size: int):
    n = R.shape[0]
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    R = R.float()
    b = b.float()
    r = min(block_size, n)
    x = torch.zeros_like(b)
    for lo in reversed(range(0, n, r)):
        hi = min(lo + r, n)
        rhs = b[lo:hi]
        if hi < n:
            rhs = rhs - mm_f32(R[lo:hi, hi:], x[hi:])
        x[lo:hi] = torch.linalg.solve_triangular(R[lo:hi, lo:hi], rhs,
                                                 upper=True)
    return x[:, 0] if squeeze else x


def lstsq_pivoted(A, b, rcond: Optional[float] = None, device=None):
    """Rank-deficient least squares: the min-norm solution
    (``np.linalg.lstsq`` semantics) through a complete orthogonal
    decomposition.  ``A P = Q R`` reveals the rank k; ``R[:k, :]^T = Z T``
    (tall unpivoted Householder QR) gives ``y = Z T^{-T} (Q^T b)[:k]`` and
    ``x[perm] = y``.  ``device`` as in ``utils/device.py``."""
    A = as_device_tensor(A, device).float()
    b = torch.as_tensor(b, device=A.device).float()
    squeeze = b.dim() == 1
    bc = b[:, None] if squeeze else b
    m, n = A.shape
    R, qtb, perm = pivoted_qr_qtb(A, bc)
    k = numerical_rank(R, rcond=rcond, m=m)
    if k == 0:
        return A.new_zeros((n,) if squeeze else (n, bc.shape[1]))
    Z, T = qr(R[:k, :].T, mode="reduced", panel_method="householder")
    w = back_substitution(T.T, qtb[:k, :], lower=True)
    y = mm_f32(Z, w)
    x = torch.zeros_like(y)
    x[perm] = y
    return x[:, 0] if squeeze else x


def lstsq(
    A,
    b,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    method: str = "blocked",
    refine_steps: int = 0,
    panel_method: str = "householder",
    rcond: Optional[float] = None,
    quality: Optional[str] = None,
    device=None,
):
    """Minimize ``||A x - b||_2`` via QR, on the device of ``A`` (a
    non-tensor ``A`` runs on CUDA unless ``device='cpu'``).

    ``method='blocked'`` factors with ``block_qr_qtb(check='sync')``;
    ``'pivoted'`` (and any m < n) goes to ``lstsq_pivoted``.  ``rcond`` is
    the rank tripwire: when R's diagonal decays to ``rcond * max|diag|``
    or below (default ``eps_f32 * max(m, n)``) the system is solved by
    ``lstsq_pivoted`` instead; ``rcond=0`` disables it.  ``panel_method``
    and ``quality`` are forwarded to the blocked driver.
    """
    A = as_device_tensor(A, device).float()
    b = torch.as_tensor(b, device=A.device).float()
    m, n = A.shape
    if method == "pivoted" or m < n:
        return lstsq_pivoted(A, b, rcond=rcond)
    if method == "tsqr" or refine_steps > 0:
        raise NotImplementedError(
            f"lstsq(method={method!r}, refine_steps={refine_steps}) is not "
            f"ported to mixedprecisionblockqr_tpu_torch yet ({_PARALLEL_ITEM})"
        )
    R, qtb = block_qr_qtb(A, b, block_size=block_size, policy=policy,
                          panel_method=panel_method, quality=quality,
                          check="sync")
    Rn = R[:n, :]
    if rcond is None or rcond > 0:
        # Plain QR puts at least one tiny pivot on a rank-deficient R's
        # diagonal (no guarantee where): the solve must reroute.
        d = torch.diagonal(Rn).abs()
        tol = _EPS * max(m, n) if rcond is None else rcond
        if float(d.min()) <= tol * float(d.max()):
            return lstsq_pivoted(A, b, rcond=rcond)
    return back_substitution(Rn, qtb[:n])
