"""CAQR: tiled communication-avoiding QR with stored factors, on one
device (port of ``mixedprecisionblockqr_tpu/parallel/caqr.py``).

Column panels of width r; each panel's rows below the diagonal split into
a power-of-two number of row blocks (zero-padded), factored as a TSQR:
the leaves in one batched Householder call, then the stacked pairs of
each tree level in one, routed as the ``'householder'`` tier routes its
panels (``parallel/tsqr.py::householder_panels``: on the card ONE K6
launch over the batch for fp32 panels of any width, as the JAX package
``vmap``s them).  The trailing columns take the same reflectors, a level
at a time (``ops/wy.py::apply_block_reflector_left_t`` on the stacks): the
leaves' on whole row blocks, each tree level's on the top r rows of the
paired blocks.  The factors are kept (``CAQRFactors``), so ``apply_qt`` /
``apply_q`` replay them as linear operators and ``caqr`` rebuilds Q; a
replay runs as the JAX package's: ONE stacked application over a panel's
leaves and one over each tree level's pairs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.householder import _mm
from mixedprecisionblockqr_tpu_torch.ops.policy import DTypePolicy, POLICY_FP32
from mixedprecisionblockqr_tpu_torch.ops.wy import apply_block_reflector_left_t
from mixedprecisionblockqr_tpu_torch.parallel.tsqr import householder_panels
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor


@dataclasses.dataclass
class PanelFactors:
    """Factors of one column panel's TSQR: leaf (V, T) per row block plus
    (V, T) per tree level (level l pairs winners with stride 2^l).  Padded
    rows are zero in ``leaf_v``."""

    row_offset: int               # first row of the panel
    col_offset: int               # first column of the panel
    width: int                    # panel width r
    leaf_v: torch.Tensor          # (L, h, r)
    leaf_t: torch.Tensor          # (L, r, r)
    tree_v: List[torch.Tensor]    # level l: (L / 2^(l+1), 2r, r)
    tree_t: List[torch.Tensor]    # level l: (L / 2^(l+1), r, r)


@dataclasses.dataclass
class CAQRFactors:
    m: int
    n: int
    panels: List[PanelFactors]


def _pick_row_blocks(height: int, r: int, requested: Optional[int]) -> int:
    """Row blocks of a panel of ``height`` rows.  An explicit request is a
    per-panel upper bound, halved until leaves are at least r tall (panels
    shrink toward the trailing corner); the automatic rule takes up to 32
    blocks of at least ``max(2r, 8)`` rows."""
    if requested is not None:
        L = max(1, requested)
        while L > 1 and height // L < r:
            L //= 2
        return L
    L = 1
    while L * 2 <= 32 and height // (L * 2) >= max(2 * r, 8):
        L *= 2
    return L


def _apply_q_left(X: torch.Tensor, V: torch.Tensor, T: torch.Tensor):
    """``Q X = X - V (T (V^T X))`` at full precision (of each member, for
    stacks)."""
    return X - _mm(V, _mm(T, _mm(V.mT, X)))


def _tree_apply_left(blocks: torch.Tensor, tree_v, tree_t, r: int,
                     transpose: bool, policy: DTypePolicy) -> torch.Tensor:
    """Apply the tree's block reflectors in place to the top-r row strips
    of ``blocks`` (L, h, k): leaf to root with Q_l^T when ``transpose``,
    root to leaf with Q_l otherwise.  A level's pairs (blocks i0 and i1 =
    i0 + 2^l) are gathered, stacked and scattered back as
    ``_factor_panel`` gathers them: ONE stacked application a level."""
    nlev = len(tree_v)
    order = range(nlev) if transpose else reversed(range(nlev))
    for lev in order:
        s = 1 << lev
        V, T = tree_v[lev], tree_t[lev]
        i0 = torch.arange(0, 2 * s * V.shape[0], 2 * s,
                          device=blocks.device)
        i1 = i0 + s
        st = torch.cat([blocks[i0, :r], blocks[i1, :r]], dim=1)
        if transpose:
            st = apply_block_reflector_left_t(st, V, T, policy)
        else:
            st = _apply_q_left(st, V, T)
        blocks[i0, :r] = st[:, :r]
        blocks[i1, :r] = st[:, r:]
    return blocks


def _padded_blocks(X: torch.Tensor, L: int, h: int) -> torch.Tensor:
    """A copy of X (height x k) zero-padded to L * h rows, as (L, h, k)."""
    pad = L * h - X.shape[0]
    Xp = torch.cat([X, X.new_zeros((pad, X.shape[1]))]) if pad else X.clone()
    return Xp.reshape(L, h, X.shape[1])


def _factor_nodes(x: torch.Tensor, r: int, policy: DTypePolicy):
    """Householder-factor the first r columns of each member of ``x`` (B,
    h, k) in one batched call and apply each member's reflector to its
    other columns: ``(V, T, x updated)``, stacked."""
    V, T, Rp = householder_panels(x[..., :r], policy)
    if x.shape[-1] == r:
        return V, T, Rp
    rest = apply_block_reflector_left_t(x[..., r:], V, T, policy)
    return V, T, torch.cat([Rp, rest], dim=-1)


def _factor_panel(Asub: torch.Tensor, r: int, row_blocks: Optional[int],
                  policy: DTypePolicy) -> Tuple[PanelFactors, torch.Tensor]:
    """TSQR-factor the first r columns of ``Asub`` (the rows at and below
    the panel's diagonal) and apply the transposed tree to its trailing
    columns.  Rows are zero-padded to L uniform blocks: QR of [A; 0] has
    the same R, and the reflectors are zero on the zero rows.  Returns
    ``(factors, updated Asub)``; ``Asub`` is not modified."""
    height, ncols = Asub.shape
    L = _pick_row_blocks(height, r, row_blocks)
    if L < 1 or L & (L - 1):
        raise ValueError(f"row_blocks must be a power of two, got {L}")
    h = -(-height // L)
    if h < r:
        raise ValueError(
            f"row blocks of height {h} shorter than panel width {r}; "
            f"reduce row_blocks or block_size"
        )
    leaf_v, leaf_t, blocks = _factor_nodes(_padded_blocks(Asub, L, h), r,
                                           policy)
    tree_v, tree_t = [], []
    s = 1
    while s < L:
        i0 = torch.arange(0, L, 2 * s, device=blocks.device)
        i1 = i0 + s
        st = torch.cat([blocks[i0, :r], blocks[i1, :r]], dim=1)
        V, T, st = _factor_nodes(st, r, policy)
        blocks[i0, :r] = st[:, :r]
        blocks[i1, :r] = st[:, r:]
        tree_v.append(V)
        tree_t.append(T)
        s *= 2
    out = blocks.reshape(L * h, ncols)[:height]
    factors = PanelFactors(0, 0, r, leaf_v, leaf_t, tree_v, tree_t)
    return factors, out


def caqr_factor(
    A,
    block_size: int = 64,
    row_blocks: Optional[int] = None,
    policy: DTypePolicy = POLICY_FP32,
    device=None,
) -> Tuple[CAQRFactors, torch.Tensor]:
    """Tiled CAQR factorization: ``(factors, R (n x n))``.  ``A`` is not
    modified; ``device`` as in ``utils/device.py``."""
    A = as_device_tensor(A, device).to(policy.panel, copy=True)
    m, n = A.shape
    if m < n:
        raise ValueError(f"caqr requires m >= n, got {tuple(A.shape)}")
    r = min(block_size, n)
    panels: List[PanelFactors] = []
    for lam in range(0, n, r):
        w = min(r, n - lam)
        pf, Asub = _factor_panel(A[lam:, lam:], w, row_blocks, policy)
        A[lam:, lam:] = Asub
        pf.row_offset = pf.col_offset = lam
        panels.append(pf)
    R = torch.triu(A[:n, :])
    return CAQRFactors(m, n, panels), R


def _apply_panel(X: torch.Tensor, pf: PanelFactors, transpose: bool,
                 policy: DTypePolicy) -> torch.Tensor:
    """Apply one panel's Q (or Q^T) in place to the rows >= row_offset of
    X; the zero rows of the stored V keep the padding out of the data.
    The L leaves' reflectors are ONE stacked application over the (L, h,
    k) row blocks, the tree's one a level."""
    lam, r = pf.row_offset, pf.width
    L, h, _ = pf.leaf_v.shape
    height = X.shape[0] - lam
    blocks = _padded_blocks(X[lam:], L, h)
    if transpose:
        blocks = apply_block_reflector_left_t(blocks, pf.leaf_v, pf.leaf_t,
                                              policy)
        _tree_apply_left(blocks, pf.tree_v, pf.tree_t, r, True, policy)
    else:
        _tree_apply_left(blocks, pf.tree_v, pf.tree_t, r, False, policy)
        blocks = _apply_q_left(blocks, pf.leaf_v, pf.leaf_t)
    X[lam:] = blocks.reshape(L * h, -1)[:height]
    return X


def _operand(factors: CAQRFactors, X, policy: DTypePolicy) -> torch.Tensor:
    """A copy of X in the policy's panel dtype on the factors' device."""
    dev = factors.panels[0].leaf_v.device if factors.panels else None
    return torch.as_tensor(X, device=dev).to(policy.panel, copy=True)


def apply_qt(factors: CAQRFactors, X, policy: DTypePolicy = POLICY_FP32):
    """``Q^T X`` for the implicit Q of a CAQR factorization (X (m x k))."""
    X = _operand(factors, X, policy)
    for pf in factors.panels:
        X = _apply_panel(X, pf, True, policy)
    return X


def apply_q(factors: CAQRFactors, X, policy: DTypePolicy = POLICY_FP32):
    """``Q X`` (the panels replayed in reverse)."""
    X = _operand(factors, X, policy)
    for pf in reversed(factors.panels):
        X = _apply_panel(X, pf, False, policy)
    return X


def caqr(
    A,
    block_size: int = 64,
    row_blocks: Optional[int] = None,
    mode: str = "reduced",
    policy: DTypePolicy = POLICY_FP32,
    device=None,
):
    """CAQR with Q rebuilt by replaying the factors: ``(Q (m x n), R (n x
    n))`` in 'reduced' mode, ``(Q (m x m), R (m x n))`` otherwise.
    ``device`` as in ``utils/device.py``."""
    A = as_device_tensor(A, device).to(policy.panel)
    m, n = A.shape
    factors, R = caqr_factor(A, block_size, row_blocks, policy)
    ncols = n if mode == "reduced" else m
    Q = apply_q(factors,
                torch.eye(m, ncols, dtype=policy.panel, device=A.device),
                policy)
    if mode == "reduced":
        return Q, R
    return Q, torch.cat([R, R.new_zeros((m - n, n))])


def factors_from_numpy(m: int, n: int, panels, device=None) -> CAQRFactors:
    """``CAQRFactors`` from another implementation's factors given as numpy
    arrays (the JAX package's ``caqr_factor`` leaves, for example): each
    entry of ``panels`` a mapping with ``row_offset``, ``col_offset``,
    ``width``, ``leaf_v``, ``leaf_t`` and the lists ``tree_v`` and
    ``tree_t``.  ``device`` as in ``utils/device.py``."""

    def t(x):
        return as_device_tensor(x, device)

    return CAQRFactors(m, n, [
        PanelFactors(int(p["row_offset"]), int(p["col_offset"]),
                     int(p["width"]), t(p["leaf_v"]), t(p["leaf_t"]),
                     [t(v) for v in p["tree_v"]],
                     [t(x) for x in p["tree_t"]])
        for p in panels])
