"""Column-pivoted (rank-revealing) QR (port of
``mixedprecisionblockqr_tpu/ops/pivoted.py``).

Two tiers, as in the JAX package:
  * ``'exact'`` -- Businger-Golub QP3 (``_pivoted_qr_impl``): at step k the
    remaining column of largest live-row norm is swapped to position k and
    eliminated by a Householder reflector.  Plain tensor code, with the
    norms recomputed each step and the updates restricted to the live rows
    and columns.
  * ``'rqrcp'`` -- randomized pivoting (Duersch & Gu 2017) in the
    Block-Gram-Schmidt frame (``_rqrcp_impl``): per r-wide panel, a fresh
    Gaussian sketch of the trailing columns, r pivots picked on the sketch
    by ``sketch_qrcp_ranks`` (kernel K7), a BCGS2 re-projection and the
    shifted three-pass panel factorization ``panel_qr_fused`` (kernel K3).
    Its worst panel residual rides the blocked drivers' poison
    convention; the public wrappers fall back to 'exact' when it trips
    (exactly rank-deficient panels).
  * ``'auto'`` -- 'rqrcp' when the shape qualifies (``_rqrcp_eligible``
    and n >= 512), else 'exact'.

The sketch matrices come from one ``torch.Generator`` per call, seeded
with ``seed`` on the input's device and drawn in panel order by
``_sketch_matrix``; they do not reproduce ``jax.random``'s numbers.  The
sketch product runs in fp32, as the JAX package computes it off the TPU.
The JAX package's in-jit branches (``traced``, ``_poison_outputs``) have
no counterpart in eager PyTorch and are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import panel_qr_fused
from mixedprecisionblockqr_tpu_torch.ops.kernels.sketch import (
    sketch_qrcp_ranks,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

_TINY = torch.finfo(torch.float32).tiny
_EPS = torch.finfo(torch.float32).eps
_RQRCP_TOL = 1e-4  # the blocked drivers' shared NS-residual poison tol


def _pivoted_qr_impl(A: torch.Tensor, B: Optional[torch.Tensor],
                     want_q: bool, with_b: bool):
    """Exact QP3: returns ``(R, Q or None, Q^T B or None, perm)``."""
    m, n = A.shape
    dev = A.device
    A = A.to(torch.float32, copy=True)
    Q = torch.eye(m, dtype=torch.float32, device=dev) if want_q else None
    Bc = B.to(torch.float32, copy=True) if with_b else None
    perm = torch.arange(n, device=dev)
    for k in range(min(m, n)):
        # pivot: the remaining column (>= k) of largest live-row norm
        colnorms = (A[k:, k:] ** 2).sum(dim=0)
        swap = torch.stack([torch.full_like(perm[0], k),
                            torch.argmax(colnorms) + k])
        A[:, swap] = A[:, swap.flip(0)]
        perm[swap] = perm[swap.flip(0)]
        # reflector on column k, rows >= k (GVL sign convention)
        v = A[k:, k].clone()
        sigma = torch.sqrt((v * v).sum())
        v[0] = v[0] + torch.where(v[0] >= 0, sigma, -sigma)
        vtv = (v * v).sum()
        beta = torch.where(vtv > _TINY, 2.0 / torch.clamp(vtv, min=_TINY),
                           0.0)
        blk = A[k:, k:]
        blk -= beta * torch.outer(v, mm_f32(v, blk))
        if with_b:
            Bb = Bc[k:]
            Bb -= beta * torch.outer(v, mm_f32(v, Bb))
        if want_q:
            Qb = Q[:, k:]
            Qb -= beta * torch.outer(mm_f32(Qb, v), v)
    return torch.triu(A), Q, Bc, perm


def _rqrcp_eligible(m: int, n: int, mode: str, block_size: int) -> bool:
    # The RQRCP tier lives in the BGS column-peel frame: reduced Q only,
    # r | n, and enough panels to amortize the sketch stages.
    return (
        m >= n
        and n % block_size == 0
        and n >= 4 * block_size
        and mode in ("r", "reduced")
    )


def _sketch_matrix(gen: torch.Generator, j: int, d: int, m: int
                   ) -> torch.Tensor:
    """Panel j's Gaussian sketch (d x m), the next draw of ``gen`` (panels
    are drawn in order; ``j`` names the panel for callers that substitute
    their own sketches)."""
    return torch.randn((d, m), generator=gen, dtype=torch.float32,
                       device=gen.device)


def _rqrcp_impl(A: torch.Tensor, B: Optional[torch.Tensor], want_q: bool,
                with_b: bool, r: int, oversample: int, seed: int):
    """Blocked randomized-pivoting QR.  Returns ``(R_full (m x n), Q or
    None, Q^T B or None, perm, worst)``; ``worst`` is the largest scaled
    panel residual (a 0-d tensor, not fetched here).

    Per r-wide panel: (1) sketch the projected trailing columns with a
    fresh (r + oversample) x m Gaussian; (2)-(3) pick r pivots on the
    sketch (K7) and gather them to the front, moving the rows of R already
    written with their columns; (4) re-project the panel against the
    previous Q (BCGS2, fp32); (5) factor it with the shifted three-pass
    chain (K3); (6) project the remaining columns once."""
    m, n = A.shape
    dev = A.device
    T = A.to(torch.float32)
    Bc = B.to(torch.float32) if with_b else None
    perm = torch.arange(n, device=dev)
    R = torch.zeros((n, n), dtype=torch.float32, device=dev)
    qcols, qtb = [], []
    worst = torch.zeros((), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = min(r + oversample, m)
    for j in range(n // r):
        k0 = j * r
        w = n - k0
        Bsk = mm_f32(_sketch_matrix(gen, j, d, m), T)
        order = torch.argsort(sketch_qrcp_ranks(Bsk, r), stable=True)
        T = T[:, order]
        perm[k0:] = perm[k0:][order]
        if j > 0:
            R[:k0, k0:] = R[:k0, k0:][:, order]
        P, C = T[:, :r], T[:, r:]
        if qcols:
            Qprev = torch.cat(qcols, dim=1)
            W2 = mm_f32(Qprev.T, P)
            P = P - mm_f32(Qprev, W2)
            R[:k0, k0:k0 + r] += W2
        Qk, t, rres = panel_qr_fused(P.contiguous(), robust=True)
        worst = torch.maximum(worst, 0.01 * rres)
        R[k0:k0 + r, k0:k0 + r] = t
        if w > r:
            G1 = mm_f32(Qk.T, C)
            C = C - mm_f32(Qk, G1)
            R[k0:k0 + r, k0 + r:] = G1
        if with_b:
            qtb.append(mm_f32(Qk.T, Bc))
        qcols.append(Qk)
        T = C
    R_full = torch.cat([R, R.new_zeros((m - n, n))]) if m > n else R
    Q = torch.cat(qcols, dim=1) if want_q else None
    QtB = torch.cat(qtb) if with_b else None
    return R_full, Q, QtB, perm, worst


def _resolve_method(method, m, n, mode, block_size):
    if method == "auto":
        return ("rqrcp" if n >= 512 and _rqrcp_eligible(m, n, mode,
                                                        block_size)
                else "exact")
    if method == "rqrcp" and not _rqrcp_eligible(m, n, mode, block_size):
        raise ValueError(
            "method='rqrcp' needs m >= n, block_size | n, n >= 4*block_size "
            f"and mode in ('r', 'reduced'); got {m}x{n} mode={mode!r} "
            f"block_size={block_size}"
        )
    if method not in ("rqrcp", "exact"):
        raise ValueError(f"unknown method {method!r}")
    return method


def pivoted_qr(
    A,
    mode: str = "reduced",
    method: str = "auto",
    block_size: int = 128,
    oversample: int = 8,
    seed: int = 0,
    device=None,
):
    """Column-pivoted QR: ``A[:, perm] = Q @ R`` with (sketch-)decaying
    ``|diag(R)|``.  Returns ``(Q, R, perm)`` -- reduced: Q (m, k), R (k,
    n); complete: Q (m, m), R (m, n) -- or ``(R (k, n), perm)`` for mode
    'r'.  ``method`` is 'exact', 'rqrcp' or 'auto' (module docstring); an
    'rqrcp' call whose panels poison is redone by 'exact' (one scalar
    fetch).  ``device`` as in ``utils/device.py``."""
    A = as_device_tensor(A, device)
    m, n = A.shape
    k = min(m, n)
    want_q = mode in ("reduced", "complete")
    method = _resolve_method(method, m, n, mode, block_size)
    if method == "rqrcp":
        R, Q, _, perm, worst = _rqrcp_impl(A, None, want_q, False,
                                           block_size, oversample, seed)
        if not bool(worst < _RQRCP_TOL):  # NaN-safe: poison retries
            return pivoted_qr(A, mode=mode, method="exact")
        if mode == "r":
            return R[:k, :], perm
        return Q[:, :k], R[:k, :], perm
    R, Q, _, perm = _pivoted_qr_impl(A, None, want_q, False)
    if mode == "r":
        return R[:k, :], perm
    if mode == "reduced":
        return Q[:, :k], R[:k, :], perm
    if mode == "complete":
        return Q, R, perm
    raise ValueError(f"unknown mode {mode!r}")


def pivoted_qr_qtb(
    A,
    B,
    method: str = "auto",
    block_size: int = 128,
    oversample: int = 8,
    seed: int = 0,
    device=None,
):
    """Pivoted factorization returning ``(R (k, n), Q^T B, perm)`` without
    materializing Q: the rank-deficient least-squares path.  ``method``
    and ``device`` as in :func:`pivoted_qr`."""
    A = as_device_tensor(A, device)
    B = torch.as_tensor(B, device=A.device)
    squeeze = B.dim() == 1
    if squeeze:
        B = B[:, None]
    m, n = A.shape
    k = min(m, n)
    method = _resolve_method(method, m, n, "r", block_size)
    if method == "rqrcp":
        R, _, QtB, perm, worst = _rqrcp_impl(A, B, False, True, block_size,
                                             oversample, seed)
        if not bool(worst < _RQRCP_TOL):
            return pivoted_qr_qtb(A, B[:, 0] if squeeze else B,
                                  method="exact")
    else:
        R, _, QtB, perm = _pivoted_qr_impl(A, B, False, True)
    return R[:k, :], QtB[:, 0] if squeeze else QtB, perm


def numerical_rank(R, rcond: Optional[float] = None,
                   m: Optional[int] = None, device=None) -> int:
    """Numerical rank from a pivoted R's diagonal: the count of
    ``|R[i, i]| > rcond * max|diag(R)|``.  The default rcond is
    ``eps_f32 * max(m, n)``; callers holding the trimmed (k, n) factor
    pass the original row count ``m``.  The cutoff keys on ``max|d|``, not
    ``d[0]``: RQRCP's sketch-greedy order can put d[0] below the max.
    ``device`` as in ``utils/device.py``."""
    R = as_device_tensor(R, device)
    d = torch.diagonal(R).abs()
    if rcond is None:
        rcond = _EPS * max(R.shape[1], m if m is not None else 0, R.shape[0])
    return int((d > rcond * (d.max() + _TINY)).sum())
