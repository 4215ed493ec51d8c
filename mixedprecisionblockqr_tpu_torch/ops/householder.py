"""Householder reflectors, unblocked Householder QR and the panel factor
of the robust tier (port of ``mixedprecisionblockqr_tpu/ops/householder.py``).

The conventions are the JAX package's:
  * the GVL sign choice ``rkk = -sign(x_k) ||x||`` (``sign(0) = +1``);
  * the zero-column skip: a column whose live norm is at most
    ``_tiny(dtype)`` gets ``beta = 0``, ``w = 0`` and ``rkk = x_k``, which
    the exact pivoted tier and rank-deficient inputs rely on;
  * unit-norm reflectors, ``beta = 2`` for every live column;
  * ``_num_reflectors``: a square matrix skips its last column.

The JAX package masks full-length vectors to keep XLA's shapes static; this
port updates slices of the live rows (and columns) instead.  The entries
it leaves out are exact zeros there, so the results agree to rounding.
Every step is a few tensor operations on the input's device, with no host
synchronization.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

_EPS_BY_DTYPE = {
    torch.float64: 1e-300,
    torch.float32: 1e-30,
    torch.bfloat16: 1e-30,
    torch.float16: 1e-6,
}


def _tiny(dtype: torch.dtype) -> float:
    return _EPS_BY_DTYPE.get(dtype, 1e-30)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision product in the operands' dtype (fp32 with TF32 off)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return mm_f32(a, b)
    return torch.matmul(a, b)


def _reflector(x: torch.Tensor):
    """Reflector of the live part ``x`` (rows k: of a column):
    ``(w, beta, rkk)`` with ``(I - beta w w^T) x = rkk e_0``."""
    dtype = x.dtype
    one = torch.ones((), dtype=dtype, device=x.device)
    sigma = torch.sqrt((x * x).sum())
    alpha = x[0]
    sign = torch.where(alpha >= 0, one, -one)
    u = x.clone()
    u[0] = u[0] + sign * sigma
    unorm = torch.sqrt((u * u).sum())
    live = sigma > _tiny(dtype)
    w = torch.where(live, u / torch.where(live, unorm, one),
                    torch.zeros_like(u))
    beta = torch.where(live, 2 * one, 0 * one)
    rkk = torch.where(live, -sign * sigma, alpha)
    return w, beta, rkk


def householder_reflector(x: torch.Tensor, k: int):
    """Unit-norm reflector annihilating ``x[k+1:]``: ``(w, beta, rkk)``
    with ``H = I - beta w w^T``, ``w`` zero in rows < k and ``H x = rkk
    e_k`` on rows >= k.  For ``x = [0, 0, 2]`` (k = 0) it maps x to
    ``[-2, 0, 0]``."""
    wl, beta, rkk = _reflector(x[k:])
    w = torch.zeros_like(x)
    w[k:] = wl
    return w, beta, rkk


def _num_reflectors(m: int, n: int) -> int:
    # A square matrix skips its last column (a trivial sign flip).
    return min(m - 1, n) if m > 1 else 0


def _householder_qr_impl(A: torch.Tensor):
    """Returns ``(R_full before triu, V, beta)``; ``A`` is not modified."""
    m, n = A.shape
    K = _num_reflectors(m, n)
    A = A.clone()
    V = torch.zeros((m, max(K, 1)), dtype=A.dtype, device=A.device)
    beta = torch.zeros((max(K, 1),), dtype=A.dtype, device=A.device)
    for k in range(K):
        w, b, _ = _reflector(A[k:, k])
        blk = A[k:, k:]
        blk -= b * torch.outer(w, _mm(w, blk))
        V[k:, k] = w
        beta[k] = b
    return A, V, beta


def q_backward_accumulation(V: torch.Tensor,
                            beta: torch.Tensor) -> torch.Tensor:
    """Full Q = H_0 ... H_{K-1} from stored reflectors, right to left (GVL
    Alg. 5.1.5).  Step k touches only the trailing block ``Q[k:, k:]``:
    the product of the later reflectors is the identity elsewhere."""
    m, K = V.shape
    Q = torch.eye(m, dtype=V.dtype, device=V.device)
    for k in reversed(range(K)):
        w = V[k:, k]
        blk = Q[k:, k:]
        blk -= beta[k] * torch.outer(w, _mm(w, blk))
    return Q


def householder_qr(A, mode: str = "reduced",
                   dtype: torch.dtype = torch.float32, device=None):
    """Unblocked Householder QR.  ``'reduced'`` -> (Q[:, :n], R[:n, :]),
    ``'complete'`` -> (Q (m x m), R (m x n)), ``'raw'`` -> (V, beta) with
    Q = H_0 ... H_{K-1}, H_k = I - beta_k v_k v_k^T.  ``device`` as in
    ``utils/device.py``."""
    A = as_device_tensor(A, device).to(dtype)
    n = A.shape[1]
    R_full, V, beta = _householder_qr_impl(A)
    if mode == "raw":
        return V, beta
    R_full = torch.triu(R_full)
    Q = q_backward_accumulation(V, beta)
    if mode == "reduced":
        return Q[:, :n], R_full[:n, :]
    if mode == "complete":
        return Q, R_full
    raise ValueError(f"unknown mode {mode!r}")


def panel_factor(
    panel: torch.Tensor, num_cols: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factor an (h x r) panel: ``(V, T, R_panel)`` with ``Q_panel = I -
    V T V^T`` (compact WY, forward product) and ``R_panel = Q_panel^T
    panel``, upper triangular in its top r rows (below the diagonal it
    holds rounding residue, which the callers' ``triu`` removes).
    ``num_cols`` masks trailing panel columns: only the first ``num_cols``
    get a reflector (V and T stay zero beyond them); default the full
    width.  ``panel`` is not modified."""
    h, r = panel.shape
    ncols = r if num_cols is None else num_cols
    P = panel.clone()
    V = torch.zeros((h, r), dtype=P.dtype, device=P.device)
    T = torch.zeros((r, r), dtype=P.dtype, device=P.device)
    for j in range(min(ncols, h)):
        w, b, _ = _reflector(P[j:, j])
        blk = P[j:, j:]
        blk -= b * torch.outer(w, _mm(w, blk))
        # T[:, j] = -b T (V^T w); T[j, j] = b.  V is zero in columns >= j
        # and T outside its leading j x j block.
        if j:
            T[:j, j] = -b * _mm(T[:j, :j], _mm(V[j:, :j].T, w))
        T[j, j] = b
        V[j:, j] = w
    return V, T, P
