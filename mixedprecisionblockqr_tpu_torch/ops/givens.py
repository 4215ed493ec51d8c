"""Givens-rotation QR and the streaming QR updates (port of
``mixedprecisionblockqr_tpu/ops/givens.py``).

* ``givens_rotation(a, b)``: the reference's ``(c, s)``, ``c = a / r``,
  ``s = -b / r``, ``r = hypot(a, b)``, ``(1, 0)`` when ``r = 0``; every
  sign of Q and R below follows from it.
* ``givens_qr(A)``: QR by a log-depth pairwise rotation tree per column,
  each level one gather / rotate / scatter of disjoint row pairs of
  ``[A | I]`` (vectorized PyTorch; no kernel).
* The O(mn) updates of complete-mode factors (``qr_rank1_update``,
  ``qr_insert_col``, ``qr_delete_col``, ``qr_delete_row``) and the O(n^2)
  row fold ``qr_append_row``: each of the reference's rotation loops is
  one launch of a kernel of ``ops/kernels/givens.py`` on the card (G1 the
  row fold, G2 a bottom-up chain driven by a vector, G3 the top-down
  Hessenberg chain), its plain version on the CPU.  A call that runs G1
  or G3 on the card reads their abort flag at its end (one wait for the
  device) and raises ``RuntimeError`` if a coefficient wait timed out.

Every function computes in fp32, as the reference does.  The updates
rotate rows of Q^T (a copy; the inputs are never changed) and return its
transpose, as the reference returns ``Qt.T``.  Entry points run on the
device of their tensors; numpy inputs go to ``device=`` or ``cuda``
(``utils/device.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import (
    abort_flag,
    givens_chain,
    givens_fold_rows,
    givens_hessenberg,
    givens_rotation,
    raise_on_abort,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

__all__ = ["givens_rotation", "givens_qr", "qr_rank1_update",
           "qr_append_row", "qr_delete_col", "qr_insert_col",
           "qr_delete_row"]


def _f32(x, device=None) -> torch.Tensor:
    return as_device_tensor(x, device).float()


def _on(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).float()


def _transposed_copy(Q: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous Q^T (the kernels rotate it in place)."""
    return Q.T.clone(memory_format=torch.contiguous_format)


def _eliminate_column(X: torch.Tensor, k: int) -> None:
    """Zero ``X[k+1:, k]`` by a log-depth pairwise rotation tree, in place.
    At stride s each surviving row ``lo = k + 2 s i`` eliminates ``lo + s``:
    the pairs are disjoint, so one level is one vectorized two-row
    rotation of whole rows."""
    m = X.shape[0]
    s = 1
    while k + s < m:
        lo = torch.arange(k, m - s, 2 * s, device=X.device)
        hi = lo + s
        c, sn = givens_rotation(X[lo, k], X[hi, k])
        c, sn = c[:, None], sn[:, None]
        Xlo, Xhi = X[lo], X[hi]
        X[lo] = c * Xlo - sn * Xhi
        X[hi] = sn * Xlo + c * Xhi
        s *= 2


def givens_qr(A, mode: str = "reduced", loop_mode: str = "auto",
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """QR by vectorized Givens elimination trees, one per column.

    Returns ``(Q, R)`` like ``householder_qr``: reduced -> (m x k, k x n),
    complete -> (m x m, m x n), k = min(m, n).  ``loop_mode`` is checked as
    the reference checks it ('auto' is 'unroll' for m, k <= 512, else
    'scan'); the reference's two programs apply the same rotations (the
    scan form adds identity-masked pairs only), so both run the same
    levels here.  ``device`` as in ``utils/device.py``.
    """
    A = _f32(A, device)
    m, n = A.shape
    k = min(m, n)
    if loop_mode == "auto":
        loop_mode = "unroll" if m <= 512 and k <= 512 else "scan"
    if loop_mode not in ("unroll", "scan"):
        raise ValueError(f"unknown loop_mode {loop_mode!r}")
    if mode not in ("reduced", "complete"):
        raise ValueError(f"unknown mode {mode!r}")
    # Rotating the rows of [A | I] carries Q^T in the right block.
    X = torch.cat([A, torch.eye(m, dtype=torch.float32, device=A.device)],
                  dim=1)
    for kk in range(k if m > k else k - 1):
        _eliminate_column(X, kk)
    Q, R = X[:, n:].T, torch.triu(X[:, :n])
    if mode == "reduced":
        return Q[:, :k], R[:k, :]
    return Q, R


def abort_flag_for(like: torch.Tensor):
    """The abort flag of one call's G1 / G3 launches on the card (read once,
    at the call's end, by :func:`check_abort`); None on the CPU."""
    return abort_flag(like.device) if like.is_cuda else None


def check_abort(flag, name: str) -> None:
    """Raise if a G1 / G3 launch of the call ``name`` set ``flag``."""
    if flag is not None:
        raise_on_abort(flag, name)


def _complete_factors(Q, R, message: str, device=None):
    """Q and R as fp32 on R's device; ``ValueError`` (``message`` with the
    two shapes) unless Q is m x m."""
    R = _f32(R, device)
    Q = _on(Q, R)
    m = R.shape[0]
    if Q.shape != (m, m):
        raise ValueError(message.format(tuple(Q.shape), tuple(R.shape)))
    return Q, R


def qr_rank1_update(Q, R, u, v, device=None):
    """Rank-1 QR update: given complete-mode ``A = Q R``, return ``(Q',
    R')`` with ``A + u v^T = Q' R'`` in O(mn) work (GVL 12.5.1).  Downdate
    by passing ``-u``.

    With ``w = Q^T u``, a bottom-up chain of m-1 adjacent-row rotations
    (G2) maps w to ``||w|| e_0`` and leaves R upper Hessenberg; the update
    lands in row 0 (``w_0 v^T``); a top-down chain of min(m-1, n) rotations
    (G3) re-triangularizes.  Q (m x m), R (m x n), u (m,), v (n,); the
    outputs have the same shapes, R' exactly upper triangular.
    """
    Q, R = _complete_factors(
        Q, R, "qr_rank1_update needs the complete-mode factors: Q {} vs R {} "
        "(use mode='complete')", device)
    u = _on(u, R).reshape(-1)
    v = _on(v, R).reshape(-1)
    w = mm_f32(Q.T, u[:, None])[:, 0].contiguous()
    H = R.clone(memory_format=torch.contiguous_format)
    Qt = _transposed_copy(Q)
    w0 = givens_chain(w, H, Qt, 0)
    H[0, :] += w0 * v
    flag = abort_flag_for(H)
    givens_hessenberg(H, Qt, flag)
    out = Qt.T, torch.triu(H)
    check_abort(flag, "qr_rank1_update")
    return out


def qr_append_row(R, a, qtb=None, beta=None, device=None):
    """Append an observation row: given the R of ``A = Q R`` (n x n upper)
    return the R' of ``[A; a^T]`` in O(n^2), by n rotations that fold the
    row into R one pivot at a time (G1); with ``qtb`` ((n,) or (n, k)) and
    ``beta`` (the new rhs entry, scalar or (k,)) the same rotations keep
    ``Q^T b`` current and ``(R', qtb')`` is returned, both of the input
    shapes (the appended row's residual component drops out)."""
    R = _f32(R, device)
    a = _on(a, R).reshape(-1)
    n = R.shape[0]
    if R.shape != (n, n) or a.shape != (n,):
        raise ValueError(f"qr_append_row: R {tuple(R.shape)} must be square "
                         f"and match a {tuple(a.shape)}")
    flag = abort_flag_for(R)
    if qtb is None:
        Raug = R.clone(memory_format=torch.contiguous_format)
        givens_fold_rows(Raug, a[None, :], flag)
        out = torch.triu(Raug)
        check_abort(flag, "qr_append_row")
        return out
    qtb = _on(qtb, R)
    squeeze = qtb.dim() == 1
    qtb2 = qtb[:, None] if squeeze else qtb
    brow = torch.broadcast_to(_on(beta, R).reshape(-1), (qtb2.shape[1],))
    Raug = torch.cat([R, qtb2], dim=1).contiguous()
    givens_fold_rows(Raug, torch.cat([a, brow])[None, :], flag)
    qtb_p = Raug[:, n:]
    out = torch.triu(Raug[:, :n]), (qtb_p[:, 0] if squeeze else qtb_p)
    check_abort(flag, "qr_append_row")
    return out


def qr_delete_col(Q, R, k: int, device=None):
    """Delete column ``k``: given complete-mode ``A = Q R``, return ``(Q',
    R')`` factoring A without its column k, in O((n-k) m) (scipy
    ``qr_delete(..., which='col')``).  Removing R's column k leaves the
    columns from k on upper Hessenberg; the top-down chain (G3) over the
    whole factor re-triangularizes it, as the reference's full-length
    chain does (below k it meets H[i+1, i] = 0).  Q (m x m), R (m x n), k in
    [0, n); returns Q' (m x m), R' (m x n-1)."""
    Q, R = _complete_factors(
        Q, R, "qr_delete_col needs complete-mode factors: Q {} vs R {}",
        device)
    n = R.shape[1]
    idx = torch.arange(n - 1, device=R.device)
    H = R[:, torch.where(idx < k, idx, idx + 1)].contiguous()
    Qt = _transposed_copy(Q)
    flag = abort_flag_for(H)
    givens_hessenberg(H, Qt, flag)
    out = Qt.T, torch.triu(H)
    check_abort(flag, "qr_delete_col")
    return out


def qr_insert_col(Q, R, k: int, u, device=None):
    """Insert column ``u`` before column ``k``: given complete-mode ``A =
    Q R``, return ``(Q', R')`` factoring A with u spliced in, in O(m (m -
    k)) (scipy ``qr_insert(..., which='col')``).  ``w = Q^T u`` becomes the
    new column; the bottom-up chain (G2) driven by it zeroes w below row k,
    rows above k untouched.  Q (m x m), R (m x n) with n < m (the new
    column needs a free row), k in [0, n], u (m,); returns Q' (m x m), R'
    (m x n+1)."""
    R = _f32(R, device)
    Q = _on(Q, R)
    u = _on(u, R).reshape(-1)
    m, n = R.shape
    if Q.shape != (m, m) or u.shape != (m,):
        raise ValueError(
            f"qr_insert_col needs complete-mode factors and u (m,): "
            f"Q {tuple(Q.shape)}, R {tuple(R.shape)}, u {tuple(u.shape)}"
        )
    if n >= m:
        raise ValueError(
            f"qr_insert_col: inserting into a full-rank-square factor "
            f"(m={m}, n={n}) has no free row for the new diagonal"
        )
    w = mm_f32(Q.T, u[:, None])
    idx = torch.arange(n + 1, device=R.device)
    src = torch.clamp(torch.where(idx < k, idx, idx - 1), 0, n - 1)
    Rx = torch.where((idx == k)[None, :], w, R[:, src]).contiguous()
    Qt = _transposed_copy(Q)
    givens_chain(Rx[:, k].contiguous(), Rx, Qt, k)
    return Qt.T, torch.triu(Rx)


def qr_delete_row(Q, R, k: int, device=None):
    """Delete row ``k``: given complete-mode ``A = Q R``, return ``(Q',
    R')`` factoring A without its row k, in O(m (m + n)) (scipy
    ``qr_delete(..., which='row')``; the observation-removal half of the
    recursive least-squares pair).  The bottom-up chain (G2) driven by row
    k of Q maps it to +-e_0: applied to R it leaves H upper Hessenberg,
    applied to Q it makes column 0 +-e_k; dropping row k and column 0 of
    the rotated Q and row 0 of H gives the factorization, by plane
    rotations only.  Q (m x m), R (m x n), k in [0, m); returns Q' (m-1 x
    m-1), R' (m-1 x n)."""
    Q, R = _complete_factors(
        Q, R, "qr_delete_row needs complete-mode factors: Q {} vs R {}",
        device)
    m = R.shape[0]
    if m < 2:
        raise ValueError("qr_delete_row: m must be >= 2")
    H = R.clone(memory_format=torch.contiguous_format)
    Qt = _transposed_copy(Q)
    givens_chain(Q[k, :].contiguous(), H, Qt, 0)
    ridx = torch.arange(m - 1, device=R.device)
    rows = torch.where(ridx < k, ridx, ridx + 1)
    return Qt.T[rows][:, 1:], torch.triu(H[1:, :])
