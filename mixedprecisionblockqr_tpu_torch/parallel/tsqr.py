"""TSQR: tall-skinny QR with a binary reduction tree (port of
``mixedprecisionblockqr_tpu/parallel/tsqr.py``), on one device and, as
``tsqr_sharded``, over the ranks of a mesh axis.

The rows split into a power-of-two number of leaves (zero-padded); each
leaf is one Householder panel, and each tree level factors the stacked
pairs of the level below: (2n x n) panels.  Q is rebuilt top-down from
(n x n) path factors.  The leaves, and the pairs of each tree level, are
factored together, as the JAX package's ``vmap`` factors them: one
``householder_panels`` call a level (``ops/blockqr.py::
_householder_panels``), on the card ONE K6 launch over the batch for fp32
panels (``panel_factor_fused_batched``; its wide route above 128 columns,
one launch a sub-panel), ``panel_factor``'s column loop member by member
otherwise (the CPU, float64).  ``tsqr_batched`` factors the leaves of all
its members in one call and each tree level across members in one call.
CholeskyQR2 leaves and tree levels ('cholqr2', 'cholqr2s') are one
stacked ``cholesky_qr2`` call each.

Rank caveat (the reference's): Q assumes nonsingular leaf R factors;
rank-deficient inputs still give a valid R and residual A = QR.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
    _householder_fused,
    _householder_panel,
    _householder_panels,
)
from mixedprecisionblockqr_tpu_torch.ops.cholqr import cholesky_qr2
from mixedprecisionblockqr_tpu_torch.ops.householder import _mm
from mixedprecisionblockqr_tpu_torch.ops.policy import DTypePolicy, POLICY_FP32
from mixedprecisionblockqr_tpu_torch.ops.wy import reduced_q_from_vt
from mixedprecisionblockqr_tpu_torch.parallel.mesh import (
    ROWS_AXIS,
    all_gather,
    axis_index,
    axis_size,
    mesh_device,
    shard_rows,
)
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

LEAF_METHODS = ("householder", "cholqr2", "cholqr2s")


def householder_panel(block: torch.Tensor,
                      policy: DTypePolicy = POLICY_FP32):
    """``(V, T, Rp)`` of one Householder panel, routed as the
    ``'householder'`` tier routes its panels: K6 on CUDA for fp32 of any
    width, else ``panel_factor``."""
    return _householder_panel(
        block, policy,
        fused=_householder_fused(block.device.type, block.dtype))


def householder_panels(blocks: torch.Tensor,
                       policy: DTypePolicy = POLICY_FP32):
    """``(V, T, Rp)`` of each panel of a (B, m, w) stack, stacked, routed
    as :func:`householder_panel` routes one: on CUDA for fp32 ONE batched
    K6 call (``panel_factor_fused_batched``), else ``panel_factor`` member
    by member."""
    return _householder_panels(
        blocks, policy,
        fused=_householder_fused(blocks.device.type, blocks.dtype))


def _leaf_qr(block: torch.Tensor, method: str = "householder"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR of one (h x n) leaf: ``(Q (h x n), R (n x n))``.
    'cholqr2' / 'cholqr2s' run (shifted) CholeskyQR2; 'householder' is
    the unconditionally robust default."""
    Q, R = _leaf_qrs(block[None], method)
    return Q[0], R[0]


def _leaf_qrs(blocks: torch.Tensor, method: str = "householder"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR of each (h x n) leaf of a (B, h, n) stack: ``(Q (B, h,
    n), R (B, n, n))``; Householder leaves in one ``householder_panels``
    call, CholeskyQR2 leaves in one stacked ``cholesky_qr2`` call."""
    n = blocks.shape[-1]
    if method in ("cholqr2", "cholqr2s"):
        return cholesky_qr2(blocks, shifted=method == "cholqr2s")
    V, T, Rf = householder_panels(blocks)
    return reduced_q_from_vt(V, T, n), torch.triu(Rf[:, :n, :])


def reduction_tree(Rs: torch.Tensor, method: str = "householder"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary-tree QR of L stacked (n x n) R factors.

    Given ``Rs`` of shape (L, n, n), L a power of two, returns ``(F, R)``
    with R the (n x n) triangular factor of the (L*n x n) stack and F the
    (L, n, n) path factors: ``vstack(Rs) = vstack(F) @ R`` with
    ``vstack(F)`` orthonormal.  Pairs factor by CholeskyQR2 when
    ``method == 'cholqr2'`` (one stacked call a level), else as
    Householder panels, one ``householder_panels`` call a level (as in
    the JAX package,
    'cholqr2s' trees are Householder).
    """
    F, R = _reduction_trees(Rs[None], method)
    return F[0], R[0]


def _reduction_trees(Rs: torch.Tensor, method: str = "householder"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`reduction_tree` of each of B stacks at once: ``Rs`` (B, L,
    n, n) -> ``(F (B, L, n, n), R (B, n, n))``, the Householder pairs of a
    level across all B trees in one ``householder_panels`` call."""
    B, L, n, _ = Rs.shape
    if L < 1 or L & (L - 1):
        raise ValueError(
            f"reduction_tree requires a power-of-two leaf count, got {L} "
            "(pad the R stack or pick n_leaves/mesh-axis sizes of 2^k)"
        )
    level_qs = []
    cur = Rs
    c = L
    while c > 1:
        pairs = cur.reshape(B * (c // 2), 2 * n, n)
        if method == "cholqr2":
            Qp, cur = cholesky_qr2(pairs)
        else:
            V, T, Rp = householder_panels(pairs)
            Qp = reduced_q_from_vt(V, T, n)
            cur = torch.triu(Rp[:, :n, :])
        level_qs.append(Qp.reshape(B, c // 2, 2 * n, n))
        cur = cur.reshape(B, c // 2, n, n)
        c //= 2
    R = cur[:, 0]
    # Top-down reconstruction of the per-leaf path factors.
    F = torch.eye(n, dtype=Rs.dtype, device=Rs.device).repeat(B, 1, 1, 1)
    for Qp in reversed(level_qs):
        top = _mm(Qp[..., :n, :], F)
        bot = _mm(Qp[..., n:, :], F)
        F = torch.stack([top, bot], dim=2).reshape(B, -1, n, n)
    return F, R


def _check_leaf_height(m: int, L: int, n: int, ctx: str) -> None:
    """Leaves must be at least n tall: a short leaf's QR has rank < n and
    the tree would propagate the defect silently."""
    h = -(-m // L)
    if h < n:
        raise ValueError(
            f"{ctx}: leaf height ceil({m}/{L}) = {h} is shorter than the "
            f"panel width n = {n}; use at most {max(m // n, 1)} leaves "
            "(short leaves are rank-deficient and the reduction tree "
            "propagates the defect silently)"
        )


def _pick_leaves(m: int, n: int, n_leaves: Optional[int]) -> int:
    """The leaf count: ``n_leaves`` if given, else the largest power of
    two up to 64 that keeps leaves at least ``max(4n, 32)`` tall."""
    if n_leaves is not None:
        return n_leaves
    L = 1
    while L * 2 <= 64 and (m + L * 2 - 1) // (L * 2) >= max(4 * n, 32):
        L *= 2
    return L


def _tsqr_impl(A: torch.Tensor, n_leaves: int, method: str = "householder"):
    """TSQR of A (m x n) over ``n_leaves`` leaves: ``(Q (m x n), R)``."""
    Q, R = _tsqr_batched_impl(A[None], n_leaves, method)
    return Q[0], R[0]


def _tsqr_batched_impl(A: torch.Tensor, n_leaves: int,
                       method: str = "householder"):
    """TSQR of each matrix of A (B, m, n) over ``n_leaves`` leaves: ``(Q
    (B, m, n), R (B, n, n))``, the B L leaves in one ``_leaf_qrs`` call and
    each tree level across the B trees in one call."""
    B, m, n = A.shape
    L = n_leaves
    h = -(-m // L)
    pad = L * h - m
    Ap = torch.cat([A, A.new_zeros((B, pad, n))], dim=1) if pad else A
    Qs, Rs = _leaf_qrs(Ap.reshape(B * L, h, n), method)
    F, R = _reduction_trees(Rs.reshape(B, L, n, n), method)
    Q = _mm(Qs.reshape(B, L, h, n), F).reshape(B, L * h, n)
    return Q[:, :m, :], R


def tsqr(A, n_leaves: Optional[int] = None, method: str = "householder",
         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR of a tall-skinny fp32 matrix A (m x n, m >> n) by TSQR:
    ``(Q (m x n), R (n x n))``.

    ``method``: 'householder' (robust), 'cholqr2' (all products) or
    'cholqr2s' (shifted CholeskyQR, safe to cond ~ 1/eps_f32).  With a
    cholqr method and no explicit leaf count the whole matrix is one leaf
    (no tree), as in the JAX package.  ``device`` as in
    ``utils/device.py``.
    """
    A = as_device_tensor(A, device).float()
    m, n = A.shape
    if m < n:
        raise ValueError(f"tsqr requires m >= n, got {tuple(A.shape)}")
    if method not in LEAF_METHODS:
        raise ValueError(
            f"unknown tsqr method {method!r}; options: {LEAF_METHODS}")
    if n_leaves is not None and (n_leaves < 1 or n_leaves & (n_leaves - 1)):
        raise ValueError(
            f"n_leaves must be a power of two, got {n_leaves} "
            "(the binary reduction tree pairs leaves level by level)"
        )
    if n_leaves is None and method.startswith("cholqr"):
        return _leaf_qr(A, method)
    L = _pick_leaves(m, n, n_leaves)
    if L == 1:
        return _leaf_qr(A, method)
    _check_leaf_height(m, L, n, "tsqr")
    return _tsqr_impl(A, L, method)


def tsqr_batched(A_batch, n_leaves: Optional[int] = None, device=None):
    """TSQR (Householder leaves) of each matrix of a (batch, m, n) stack:
    ``(Q (batch, m, n), R (batch, n, n))``.  The leaves of all members are
    factored in one call (on the card one batched K6 launch), then each
    tree level across members in one call.  ``device`` as in
    ``utils/device.py``."""
    A_batch = as_device_tensor(A_batch, device)
    if n_leaves is not None and (n_leaves < 1 or n_leaves & (n_leaves - 1)):
        raise ValueError(f"n_leaves must be a power of two, got {n_leaves}")
    _, m, n = A_batch.shape
    L = _pick_leaves(m, n, n_leaves)
    if L == 1:
        return _leaf_qrs(A_batch)
    _check_leaf_height(m, L, n, "tsqr_batched")
    return _tsqr_batched_impl(A_batch, L)


def tsqr_sharded(A, mesh, axis: str = ROWS_AXIS, local_leaves: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TSQR of the global fp32 A (m x n, the same on every rank) with its
    rows split over ``mesh[axis]``: returns ``(Q_loc, R)``, this rank's
    (m/d x n) row slab of Q and the replicated R (n x n).

    Each rank factors its own slab (``local_leaves`` Householder leaves,
    K6 on the card), then ONE all-gather of the (n x n) leaf R factors;
    every rank runs the small reduction tree itself (the same result on
    each) and fixes up its slab of Q with its own path factor.  Guards as
    in the JAX package: d divides m, d and ``local_leaves`` are powers of
    two, and leaves are at least n tall.
    """
    A = as_device_tensor(A, mesh_device(mesh)).float()
    m, n = A.shape
    d = axis_size(mesh, axis)
    if m % d != 0:
        raise ValueError(f"rows {m} must divide over mesh axis {axis} ({d})")
    if d & (d - 1):
        raise ValueError(
            f"tsqr_sharded needs a power-of-two mesh axis {axis!r}, got {d} "
            "(the replicated binary reduction tree pairs device R factors)"
        )
    if local_leaves < 1 or local_leaves & (local_leaves - 1):
        raise ValueError(
            f"local_leaves must be a power of two, got {local_leaves}")
    _check_leaf_height(m, d * local_leaves, n, "tsqr_sharded")
    A_loc = shard_rows(A, mesh, axis)
    if local_leaves > 1:
        Q_loc, R_loc = _tsqr_impl(A_loc, local_leaves)
    else:
        Q_loc, R_loc = _leaf_qr(A_loc)
    F, R = reduction_tree(all_gather(R_loc, mesh, axis))
    return _mm(Q_loc, F[axis_index(mesh, axis)]), R
