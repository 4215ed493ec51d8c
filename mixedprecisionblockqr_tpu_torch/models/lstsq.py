"""QR-based linear least squares (port of
``mixedprecisionblockqr_tpu/models/lstsq.py``).

``lstsq`` factors with ``block_qr_qtb`` (b rides through the panel
updates, Q is never formed), checks R's diagonal for decay and, on a
rank-deficient system, reroutes to ``lstsq_pivoted``: the min-norm
solution through a pivoted QR (RQRCP at n >= 512) and a complete
orthogonal decomposition.  ``method='tsqr'`` solves through TSQR's
reduced Q; ``refine_steps > 0`` factors once by stored-factor CAQR and
replays its Q^T per refinement sweep.  ``lstsq_batched`` solves a stack of
systems, ``lstsq_autodiff`` is differentiable in A and b.  The recursive
least-squares functions (``RLSState``, ``rls_init``, ``rls_update``,
``rls_solve``) keep ``(R, Q^T b)`` of everything observed and fold new
observation rows into it by the Givens row fold (G1 on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mixedprecisionblockqr_tpu_torch.ops.autodiff import qr_autodiff
from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
    DEFAULT_BLOCK_SIZE,
    _driver_batched,
    block_qr_qtb,
    qr,
)
from mixedprecisionblockqr_tpu_torch.ops.givens import (
    abort_flag_for,
    check_abort,
)
from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import givens_fold_rows
from mixedprecisionblockqr_tpu_torch.ops.pivoted import (
    numerical_rank,
    pivoted_qr_qtb,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import (
    DTypePolicy,
    POLICY_FP32,
    mm_f32,
)
from mixedprecisionblockqr_tpu_torch.parallel.caqr import apply_qt, caqr_factor
from mixedprecisionblockqr_tpu_torch.parallel.tsqr import tsqr
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

_EPS = torch.finfo(torch.float32).eps


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
    """Upper ``R x = b`` by blocks of ``block_size`` rows.  R (n, n) with b
    (n,) or (n, k), or a stack R (B, n, n) with b (B, n) or (B, n, k): one
    triangular solve and one product a block for all members."""
    n = R.shape[-1]
    squeeze = b.dim() == R.dim() - 1
    if squeeze:
        b = b[..., None]
    R = R.float()
    b = b.float()
    r = min(block_size, n)
    x = torch.zeros_like(b)
    for lo in reversed(range(0, n, r)):
        hi = min(lo + r, n)
        rhs = b[..., lo:hi, :]
        if hi < n:
            rhs = rhs - mm_f32(R[..., lo:hi, hi:], x[..., hi:, :])
        x[..., lo:hi, :] = torch.linalg.solve_triangular(
            R[..., lo:hi, lo:hi], rhs, upper=True)
    return x[..., 0] if squeeze else x


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
    ``'tsqr'`` through ``tsqr(A)``'s reduced Q (for very tall A);
    ``'pivoted'`` (and any m < n) goes to ``lstsq_pivoted``.
    ``refine_steps`` sweeps of iterative refinement (solve A dx = r on the
    same factorization, x += dx): with ``'tsqr'`` on its Q and R, otherwise
    on a stored-factor CAQR (``caqr_factor`` at ``min(block_size, n // 2)``
    columns a panel, its Q^T replayed by ``apply_qt``), which takes no
    ``quality=``.  ``rcond`` is the rank tripwire of the blocked and the
    CAQR path: when R's diagonal decays to ``rcond * max|diag|`` or below
    (default ``eps_f32 * max(m, n)``) the system is solved by
    ``lstsq_pivoted`` instead; ``rcond=0`` disables it.  ``panel_method``
    and ``quality`` are forwarded to the blocked driver.
    """
    A = as_device_tensor(A, device).float()
    b = torch.as_tensor(b, device=A.device).float()
    m, n = A.shape
    if method == "pivoted" or m < n:
        return lstsq_pivoted(A, b, rcond=rcond)
    if method == "tsqr":
        Q, R = tsqr(A)
        x = back_substitution(R, mm_f32(Q.T, b))
        for _ in range(refine_steps):
            r = b - mm_f32(A, x)
            x = x + back_substitution(R, mm_f32(Q.T, r))
        return x
    if refine_steps > 0:
        # Refinement needs a reusable implicit Q: stored-factor CAQR, whose
        # apply_qt replays the factors per sweep.  quality= selects
        # blocked-driver tiers and does not apply here.
        if quality is not None:
            raise ValueError(
                "refine_steps uses the stored-factor CAQR path; the "
                "quality ladder applies to the blocked driver only - "
                "drop quality= or refine_steps="
            )
        factors, Rc = caqr_factor(A, block_size=min(block_size,
                                                    max(n // 2, 1)))
        if _rank_deficient(Rc, m, n, rcond):
            return lstsq_pivoted(A, b, rcond=rcond)
        squeeze = b.dim() == 1
        bc = b[:, None] if squeeze else b
        x = back_substitution(Rc, apply_qt(factors, bc)[:n, :])
        for _ in range(refine_steps):
            r = bc - mm_f32(A, x)
            x = x + back_substitution(Rc, apply_qt(factors, r)[:n, :])
        return x[:, 0] if squeeze else x
    R, qtb = block_qr_qtb(A, b, block_size=block_size, policy=policy,
                          panel_method=panel_method, quality=quality,
                          check="sync")
    Rn = R[:n, :]
    if _rank_deficient(Rn, m, n, rcond):
        return lstsq_pivoted(A, b, rcond=rcond)
    return back_substitution(Rn, qtb[:n])


def _rank_deficient(Rn: torch.Tensor, m: int, n: int,
                    rcond: Optional[float]) -> bool:
    """The rank tripwire: R's diagonal decays to ``rcond * max|diag|`` or
    below (default ``eps_f32 * max(m, n)``; ``rcond=0`` disables it).
    Plain QR puts at least one tiny pivot on a rank-deficient R's diagonal
    (no guarantee where): the solve must reroute."""
    if rcond is not None and rcond <= 0:
        return False
    d = torch.diagonal(Rn).abs()
    tol = _EPS * max(m, n) if rcond is None else rcond
    return float(d.min()) <= tol * float(d.max())


def lstsq_batched(
    A_batch,
    b_batch,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    device=None,
):
    """Least squares of each system of a (batch, m, n) stack: the
    Householder driver with b threaded through, then back substitution
    (the JAX package ``vmap``s the same), both on the whole stack: one K6
    launch over the batch a panel step on the card, one triangular solve
    a block of rows for all systems.  ``b_batch`` (batch, m) gives x
    (batch, n); (batch, m, k) gives (batch, n, k).  ``device`` as in
    ``utils/device.py``."""
    A_batch = as_device_tensor(A_batch, device).float()
    b_batch = torch.as_tensor(b_batch, device=A_batch.device).float()
    squeeze = b_batch.dim() == 2
    if squeeze:
        b_batch = b_batch[:, :, None]
    n = A_batch.shape[2]
    R_full, _, qtb = _driver_batched(A_batch, block_size, policy, False,
                                     b_batch.to(policy.panel), "householder")
    x = _back_substitution(R_full[:, :n, :], qtb[:, :n, :].float(), 64)
    return x[:, :, 0] if squeeze else x


# -- Recursive least squares (incremental solve for streaming rows) --------

class RLSState(NamedTuple):
    """Recursive-least-squares state: the (n, n) upper triangular factor
    and the rotated right-hand side ``Q^T b`` ((n,) or (n, k)) of everything
    observed so far."""

    R: torch.Tensor
    qtb: torch.Tensor


def rls_init(
    A,
    b,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    panel_method: str = "householder",
    device=None,
) -> RLSState:
    """Factor the initial system once (``block_qr_qtb``, b threaded, no Q
    formed; ``'householder'`` panels of fp32 run K6 on the card) and
    return the streaming state.  Each later observation row then costs
    O(n^2) rotations instead of an O(m n^2) refactorization (the
    square-root-information-filter form of incremental least squares).
    ``device`` as in ``utils/device.py``."""
    A = as_device_tensor(A, device).float()
    n = A.shape[1]
    if A.shape[0] < n:
        raise ValueError(
            f"rls_init needs an overdetermined initial system (m >= n), "
            f"got {tuple(A.shape)}: a square information factor R does not "
            "exist yet - accumulate at least n rows first (or pad with a "
            "prior)"
        )
    R, qtb = block_qr_qtb(A, torch.as_tensor(b, device=A.device).float(),
                          block_size=block_size, policy=policy,
                          panel_method=panel_method, check="sync")
    return RLSState(torch.triu(R[:n, :n]),
                    qtb[:n] if qtb.dim() == 1 else qtb[:n, :])


def rls_update(state: RLSState, rows, betas) -> RLSState:
    """Fold new observation rows into the state: ``rows`` is (n,) or (k,
    n); ``betas`` the matching rhs entries (scalar / (k,) for a vector rhs;
    (k, nb) for a multi-rhs state).  One launch of the row fold (G1) on
    the card for all k rows, n pivot rotations each: O(k n^2), no Q;
    ``RuntimeError`` if one of its coefficient waits timed out."""
    R = state.R.float()
    n = R.shape[0]
    rows = torch.as_tensor(rows, device=R.device).float()
    if rows.dim() == 1:
        rows = rows[None, :]
    k = rows.shape[0]
    qtb = torch.as_tensor(state.qtb, device=R.device).float()
    squeeze = qtb.dim() == 1
    qtb2 = qtb[:, None] if squeeze else qtb
    betas = torch.as_tensor(betas, device=R.device).float().reshape(k, -1)
    betas = torch.broadcast_to(betas, (k, qtb2.shape[1]))
    Raug = torch.cat([R, qtb2], dim=1).contiguous()
    flag = abort_flag_for(Raug)
    givens_fold_rows(Raug, torch.cat([rows, betas], dim=1).contiguous(),
                     flag)
    qtb_p = Raug[:, n:]
    out = RLSState(torch.triu(Raug[:, :n]),
                   qtb_p[:, 0] if squeeze else qtb_p)
    check_abort(flag, "rls_update")
    return out


def rls_solve(state: RLSState, block_size: int = 64) -> torch.Tensor:
    """The least-squares solution of everything folded in so far."""
    return back_substitution(state.R, state.qtb, block_size=block_size)


def lstsq_autodiff(
    A,
    b,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
):
    """Differentiable least squares ``x = argmin ||A x - b||`` with
    gradients in A and b: ``qr_autodiff`` (any blocked driver, closed-form
    adjoint; ``ops/autodiff.py``), ``Q^T b`` and a triangular solve, all of
    which autograd differentiates.  Needs full column rank; for
    rank-deficient systems use ``lstsq_pivoted`` (forward only).  Unlike
    ``lstsq`` it forms the reduced Q (m x n)."""
    Q, R = qr_autodiff(A, block_size=block_size, policy=policy,
                       panel_method="auto")
    b = torch.as_tensor(b, device=Q.device)
    qtb = mm_f32(Q.T, b)
    rhs = qtb[:, None] if qtb.dim() == 1 else qtb
    x = torch.linalg.solve_triangular(R.float(), rhs, upper=True)
    return x[:, 0] if qtb.dim() == 1 else x
