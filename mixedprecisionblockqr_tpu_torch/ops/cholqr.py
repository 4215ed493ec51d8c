"""CholeskyQR panel factorization and the Yamamoto block reflector (port of
``mixedprecisionblockqr_tpu/ops/cholqr.py``).

    G = P^T P;  R = chol(G)^T;  Q = P R^-1      (repeated for CholeskyQR2)

and the basis-kernel identity ``H = I - Y S^-1 Y^T`` with ``Y = Q_red - E1``
and ``S = I - Q1^T`` that turns a reduced panel Q into one block reflector.

Two differences of PyTorch are absorbed here so that the drivers keep the
JAX package's semantics without a host synchronization:
  * ``jnp.linalg.cholesky`` returns NaN on a Gram that is not SPD (the
    drivers' NaN canary depends on it), while ``torch.linalg.cholesky``
    raises.  ``torch.linalg.cholesky_ex`` is used and a nonzero ``info``
    becomes NaN on the device; ``torch.linalg.inv_ex`` likewise for the LU
    inverse.
  * ``newton_inv(check=True)`` is a ``lax.cond`` in JAX; here it is a
    device-side ``torch.where`` on the residual (both branches computed).
Every product is full precision in the input's dtype (fp32 with TF32 off),
so a float64 panel stays float64.  Every function also takes a stack
(B, ., .) with a leading batch axis, as ``torch.linalg`` does, and computes
each member as it computes one matrix (the JAX package ``vmap``s them):
the NaN of a failed factorization, the shift's trace and ``newton_inv``'s
LU fallback are each member's own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.householder import _mm


def _nan_where(info: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """X, or all NaN in each member whose factorization's ``info`` is
    nonzero."""
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def _chol_and_inv(G: torch.Tensor, shift=None):
    """``(R, R^-1)`` with ``R^T R = G (+ shift * I)``; NaN (never a raise)
    when the matrix is not positive definite.  ``shift`` is a tensor of one
    value a member (0-d for one matrix)."""
    r = G.shape[-1]
    eye = torch.eye(r, dtype=G.dtype, device=G.device)
    if shift is not None:
        G = G + shift[..., None, None] * eye
    L, info = torch.linalg.cholesky_ex(G)
    R = _nan_where(info, L).mT
    Rinv = torch.linalg.solve_triangular(R, eye, upper=True)
    return R, Rinv


def cholesky_qr2(P: torch.Tensor, shifted: bool = False, passes: int = 2
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR of a tall panel P (m x r) by (shifted) CholeskyQR.

    ``passes=2`` (CholeskyQR2) reaches machine orthogonality, ``passes=1``
    gives ~ cond(P)^2 eps.  ``shifted`` adds ``1e-3 trace(G)`` to the first
    Gram and one extra pass.  Returns (Q (m x r), R (r x r) upper), of
    each member for a stack."""
    G = _mm(P.mT, P)
    # 1e-3 of each member's trace (its diagonal's sum)
    shift = (1e-3 * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
             if shifted else None)
    R1, R1inv = _chol_and_inv(G, shift)
    Q = _mm(P, R1inv)
    R = R1
    for _ in range((1 if shifted else 0) + max(passes - 1, 0)):
        R2, R2inv = _chol_and_inv(_mm(Q.mT, Q))
        Q = _mm(Q, R2inv)
        R = _mm(R2, R)
    return Q, R


def lu_inv(S: torch.Tensor) -> torch.Tensor:
    """LU inverse of S, all NaN when S is singular (no raise, no sync)."""
    X, info = torch.linalg.inv_ex(S)
    return _nan_where(info, X)


def newton_inv(S: torch.Tensor, iters: int = 6, check: bool = False
               ) -> torch.Tensor:
    """Inverse of the Yamamoto S by Newton-Schulz from X0 = (2/3) I: the
    sign convention pins S's spectrum to the disk |z - 1| <= 1, where
    4 iterations reach ~2e-8 and 5 fp32 roundoff.  ``check`` falls back
    to the LU inverse when ``max|I - S X| < 1e-3`` fails (or is NaN),
    on the device, for each member of a stack on its own residual."""
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    X = (2.0 / 3.0) * eye
    for _ in range(iters):
        X = _mm(X, 2.0 * eye - _mm(S, X))
    if check:
        resid = (eye - _mm(S, X)).abs().amax(dim=(-2, -1))
        X = torch.where((resid < 1e-3)[..., None, None], X, lu_inv(S))
    return X


def newton_iters_for_aspect(aspect: float) -> int:
    """Newton iteration count for the Yamamoto S by panel aspect (m/r): 5 at
    aspect >= 8, 8 at >= 4, else 12.  sigma_min(S) shrinks as the panel
    gets squarer (measured 0.236 on an aspect-2 corner panel, where 5
    iterations left 8e-5)."""
    if aspect >= 8:
        return 5
    if aspect >= 4:
        return 8
    return 12


def _sign_fix(Q1: torch.Tensor) -> torch.Tensor:
    """The Yamamoto column convention for the top r x r block Q1 of a
    panel's Q: D = -1 where diag(Q1) > 0, else 1 (in Q1's dtype).  Columns
    scaled by D give diag(Q1 D) <= 0, so cond(S) ~ 2."""
    diag = torch.diagonal(Q1, dim1=-2, dim2=-1)
    return torch.where(diag > 0, -1.0, 1.0).to(Q1.dtype)


def yamamoto_reflector(
    Q_red: torch.Tensor,
    R: torch.Tensor,
    inv_method: str = "lu",
    newton_iters: Optional[int] = None,
    check: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block reflector ``(Y, Sinv)`` with ``H = I - Y Sinv Y^T`` orthogonal
    and ``H[:, :r] = Q_red``, plus the sign-fixed R.  Columns flip so that
    diag(Q1) <= 0 (``_sign_fix``); R's rows flip with them.  Then ``H^T
    panel = [R; 0]``.  ``inv_method='newton'`` runs ``newton_iters``
    iterations, by default ``newton_iters_for_aspect(m / r)``."""
    m, r = Q_red.shape[-2:]
    D = _sign_fix(Q_red[..., :r, :])
    Qs = Q_red * D[..., None, :]
    R = R * D[..., :, None]
    Y = Qs - torch.eye(m, r, dtype=Qs.dtype, device=Qs.device)
    S = torch.eye(r, dtype=Qs.dtype, device=Qs.device) - Qs[..., :r, :].mT
    if inv_method == "newton":
        iters = (newton_iters if newton_iters is not None
                 else newton_iters_for_aspect(m / r))
        Sinv = newton_inv(S, iters=iters, check=check)
    else:
        Sinv = lu_inv(S)
    return Y, Sinv, R
