"""Distributed blocked QR on a 2-D (rows x cols) mesh (port of
``mixedprecisionblockqr_tpu/parallel/dist_qr2d.py``).

A splits over both axes: the rank at mesh coordinates (i, j) holds the
(m / dr) x (n / dc) block of rows [i h, (i + 1) h) and columns
[j wc, (j + 1) wc).  The functions below the entry point are SPMD on that
block, as in ``parallel/dist_qr.py``: a ``psum`` over ``rows`` sums the
partial products of one column of ranks, a ``psum`` over ``cols`` carries
a block along one row of ranks.  Every branch depends only on shapes, on
the mesh coordinates and on replicated values, so the ranks of each group
reach its collectives together.

Two tiers, as in the JAX package:

  * The reflector tier ('householder', 'cholqr2', 'cholqr2s'): a panel
    lives on one column shard, whose ranks factor it by the row-split TSQR
    of ``dist_qr._panel_reflector_cols`` (K6 leaves and the K4 S-inverse on
    the card).  The other column shards skip the factorization (the panel
    column is the same for every rank, so a whole column of ranks skips
    together) and receive (Y, S^-1, R_panel) from the owners by one
    ``psum`` over ``cols`` of the owners' values and everyone else's zeros.
    Each rank then updates its own trailing columns, a suffix of its block,
    with one ``psum`` over ``rows``.  Q is accumulated transposed: each
    rank holds Q^T's (m / dr) x (m / dc) block.
  * Block Gram-Schmidt ('bgs1', 'bgs2', 'bgs'): the panel's h x r block
    goes to every column shard (one ``psum`` over ``cols``), its Gram is
    one ``psum`` over ``rows`` and the chain (``ns_chain``, K1 on the
    card) runs on every rank.  Q is written by concatenation into A's own
    block; R is replicated, the column shards' coefficient blocks folded
    in by one ``psum`` over ``cols`` a panel.
"""

from __future__ import annotations

import torch

from mixedprecisionblockqr_tpu_torch.ops.blockqr import _poison_if_unconverged
from mixedprecisionblockqr_tpu_torch.ops.householder import _mm
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import ns_chain
from mixedprecisionblockqr_tpu_torch.ops.polar import (
    tri_head_iters,
    tri_iters_for_aspect,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import (
    DTypePolicy,
    POLICY_FP32,
    mm_f32,
    q_matmul,
    trailing_matmul,
)
from mixedprecisionblockqr_tpu_torch.parallel.dist_qr import (
    _panel_reflector_cols,
    _robust_panel_dist,
)
from mixedprecisionblockqr_tpu_torch.parallel.mesh import (
    ROWS_AXIS,
    axis_index,
    axis_size,
    gather_cols,
    gather_rows,
    mesh_device,
    psum,
)
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

COLS_AXIS = "cols"

_BGS = ("bgs", "bgs1", "bgs2")


def _bcast_cols(xs, owner, mesh, cols_axis):
    """The owner column shard's tensors ``xs`` on every rank of its row of
    ranks: one ``psum`` over ``cols`` of the owners' values and the other
    ranks' zeros (adding zeros is exact), packed into one collective.
    Non-owners pass tensors of the right shapes; their values are
    ignored."""
    flat = torch.cat([x.reshape(-1) if owner else x.new_zeros(x.numel())
                      for x in xs])
    flat = psum(flat, mesh, cols_axis)
    out, k = [], 0
    for x in xs:
        out.append(flat[k:k + x.numel()].view(x.shape))
        k += x.numel()
    return out


def _clip(x: int, hi: int) -> int:
    return min(max(x, 0), hi)


def _dist2d_local(A_loc, B_loc, Qt_loc, *, m, n, block_size, mesh,
                  rows_axis, cols_axis, policy, panel_method,
                  loop_mode="unroll"):
    """The reflector tier's panel loop on this rank's blocks (the JAX
    package's ``_dist2d_local``).  ``Qt_loc`` holds this rank's block of
    Q^T.  Returns ``(A_loc, B_loc, Qt_loc)``: A's block of R (zero below
    the global diagonal), this rank's rows of Q^T B and its block of
    Q^T."""
    h, wc = A_loc.shape
    r = min(block_size, n)
    if wc % r != 0:
        raise ValueError(
            f"block_size {r} must divide per-device columns {wc}")
    my_col = axis_index(mesh, cols_axis)
    row0 = axis_index(mesh, rows_axis) * h  # first global row of the block
    col0 = my_col * wc                      # first global column
    mm_t, mm_q = trailing_matmul(policy), q_matmul(policy)
    A_loc = A_loc.clone()

    def panel(lam, w, pm, square_final=False):
        """(Y, Sinv, R_panel) of panel [lam, lam + w) on every rank; the
        owner column factors it, the others wait for its pieces."""
        j0, loc = divmod(lam, wc)
        owner = my_col == j0
        if owner:
            pieces = _panel_reflector_cols(
                A_loc[:, loc:loc + w], lam, w, h, mesh, rows_axis, pm,
                square_final)
        else:
            pieces = (A_loc.new_zeros((h, w)), A_loc.new_zeros((w, w)),
                      A_loc.new_zeros((w, w)))
        return _bcast_cols(pieces, owner, mesh, cols_axis), owner, loc

    def apply(Y, Sinv, c0):
        """H^T on A's local columns from c0, on B and on Q^T: one
        ``psum`` over ``rows`` each."""
        nonlocal A_loc, B_loc, Qt_loc
        if c0 < wc:
            C = A_loc[:, c0:]
            G = psum(mm_t(Y.T, C), mesh, rows_axis)
            A_loc[:, c0:] = (C - mm_t(Y, _mm(Sinv.T, G))).to(A_loc.dtype)
        if B_loc is not None:
            Gb = psum(mm_t(Y.T, B_loc), mesh, rows_axis)
            B_loc = B_loc - mm_t(Y, _mm(Sinv.T, Gb))
        if Qt_loc is not None:
            Gq = psum(mm_q(Y.T, Qt_loc), mesh, rows_axis)
            Qt_loc = Qt_loc - mm_q(Y, _mm(Sinv.T, Gq))

    def triu_global():
        glob_r = row0 + torch.arange(h, device=A_loc.device)[:, None]
        glob_c = col0 + torch.arange(wc, device=A_loc.device)[None, :]
        return torch.where(glob_c >= glob_r, A_loc, 0.0)

    if loop_mode == "scan":
        # Every panel but the last applies H^T to the block's full width
        # (finished columns are invariant, the panel becomes [R; 0]); the
        # last panel takes Householder leaves; a global triu ends it.
        if n % r != 0:
            raise ValueError(f"scan mode needs block_size | n ({r} vs {n})")
        for k in range(n // r - 1):
            (Y, Sinv, _), _, _ = panel(k * r, r, panel_method)
            apply(Y, Sinv, 0)
        lam = n - r
        (Y, Sinv, _), _, _ = panel(lam, r, "householder",
                                   square_final=(m - lam == r))
        apply(Y, Sinv, 0)
        return triu_global(), B_loc, Qt_loc

    for lam in range(0, n, r):
        w = min(r, n - lam)
        # Hybrid rule: a panel of global aspect < 2 takes Householder
        # leaves (CholeskyQR squares the condition number).
        pm = panel_method
        if pm in ("cholqr2", "cholqr2s") and (m - lam) < 2 * w:
            pm = "householder"
        (Y, Sinv, R_pan), owner, loc = panel(lam, w, pm,
                                             square_final=(m - lam == w))
        if owner:
            # Panel columns: rows in [lam, lam + w) <- R_pan, rows below
            # <- 0 (local rows [b0, b1) and [b1, h)).
            b0, b1 = (_clip(g - row0, h) for g in (lam, lam + w))
            pan = A_loc[:, loc:loc + w]
            pan[b1:] = 0
            pan[b0:b1] = R_pan[b0 + row0 - lam:b1 + row0 - lam].to(
                A_loc.dtype)
        # The trailing columns (global index >= lam + w) are a suffix of
        # every block: local columns from c0.
        c0 = _clip(lam + w - col0, wc) if lam + w < n else wc
        apply(Y, Sinv, c0)
    return triu_global(), B_loc, Qt_loc


def _dist2d_bgs_local(A_loc, B_loc, *, m, n, block_size, mesh, rows_axis,
                      cols_axis, policy, reorth=True):
    """2-D Block Gram-Schmidt (the JAX package's ``_dist2d_bgs_local``),
    unrolled.  Per panel: the owner column's h x r block goes to every
    column shard; on the reorth tiers ('bgs', 'bgs2') it is first scrubbed
    against the finished Q, each column shard projecting with its own
    finished columns and the corrections summed over ``cols`` (fp32 with
    TF32 off, whatever the policy); its Gram is summed over ``rows`` and
    the chain runs on every rank (budgets by the global aspect m / r, +6
    on the head panel, +4 on the last quarter).  The last ``max(2, nb //
    8)`` panels run the robust three-pass scheme; on the reorth tiers each
    is rescrubbed after it (a 4-iteration chain on the scrubbed Gram).  The
    owner's panel columns become Q_k; the trailing columns of every block
    are projected with one ``psum`` over ``rows``, and the coefficient
    blocks fold into the replicated R by one ``psum`` over ``cols``.
    Returns ``(Q_loc (h x wc) fp32, R (n x n), QtB (n x k))`` after the NaN
    canary of ``_poison_if_unconverged`` (no retry)."""
    h, wc = A_loc.shape
    r = block_size
    nb = n // r
    dev = A_loc.device
    my_col = axis_index(mesh, cols_axis)
    col0 = my_col * wc
    mm_t = trailing_matmul(policy)
    mm_p = mm_f32 if reorth else mm_t

    def psum_gram(X, Y):
        return psum(mm_f32(X.T, Y), mesh, rows_axis)

    def fold_rows(W, rows):
        """R's rows [0, rows) from each column shard's coefficient rows
        ``W`` (one row per finished local column): placed at this shard's
        global columns, summed over ``cols``."""
        full = W.new_zeros((rows, W.shape[1]))
        full[col0:col0 + W.shape[0]] = W
        return psum(full, mesh, cols_axis)

    base_iters = tri_iters_for_aspect(m / r)
    worst = torch.zeros((), dtype=torch.float32, device=dev)
    A_loc = A_loc.to(torch.float32, copy=True)
    R = torch.zeros((n, n), dtype=torch.float32, device=dev)
    kB = B_loc.shape[1] if B_loc is not None else 1
    QtB = torch.zeros((n, kB), dtype=torch.float32, device=dev)

    for j in range(nb):
        lam = j * r
        j0, loc = divmod(lam, wc)
        owner = my_col == j0
        (P_loc,) = _bcast_cols((A_loc[:, loc:loc + r],), owner, mesh,
                               cols_axis)
        # This block's finished columns (global index < lam): a prefix.
        Qfin = A_loc[:, :_clip(lam - col0, wc)]
        if reorth and lam > 0:
            W = psum_gram(Qfin, P_loc)                      # (f, r)
            P_loc = P_loc - psum(mm_f32(Qfin, W), mesh, cols_axis)
            R[:lam, lam:lam + r] += fold_rows(W, lam)
        if j >= nb - max(2, nb // 8):
            Qk, t, rresid = _robust_panel_dist(P_loc, psum_gram, r)
            worst = torch.maximum(worst, rresid)
            if reorth and lam > 0:
                # Rescrub (the reference's D9, both axes):
                # qk t = q2 (s t) + Qfin (W t).
                W = psum_gram(Qfin, Qk)
                q2 = Qk - psum(mm_f32(Qfin, W), mesh, cols_axis)
                X3, s, rs = ns_chain(psum_gram(q2, q2), iters=4,
                                     omega=False)
                q2 = mm_f32(q2, X3)
                worst = torch.maximum(worst, rs * rs)
                R[:lam, lam:lam + r] += fold_rows(mm_f32(W, t), lam)
                t = mm_f32(s, t)
                Qk = q2
        else:
            if j == 0:
                iters = tri_head_iters(base_iters)
            else:
                iters = base_iters if j < 0.75 * nb else base_iters + 4
            X, t, resid = ns_chain(psum_gram(P_loc, P_loc), iters=iters)
            Qk = mm_f32(P_loc, X)
            worst = torch.maximum(worst, resid * resid)
        R[lam:lam + r, lam:lam + r] = torch.triu(t)
        if owner:
            A_loc[:, loc:loc + r] = Qk
        if B_loc is not None:
            QtB[lam:lam + r] = psum(mm_t(Qk.T, B_loc), mesh, rows_axis)
        if lam + r < n:
            c0 = _clip(lam + r - col0, wc)
            C = A_loc[:, c0:]
            G1 = psum(mm_p(Qk.T, C), mesh, rows_axis)       # (r, wc - c0)
            if c0 < wc:
                A_loc[:, c0:] = (C - mm_p(Qk, G1)).to(A_loc.dtype)
            # Fold the trailing coefficient rows into R's columns from
            # lam + r: this block's part at its global columns.
            Rrow = G1.new_zeros((r, n - lam - r))
            if c0 < wc:
                Rrow[:, col0 + c0 - lam - r:col0 + wc - lam - r] = G1
            R[lam:lam + r, lam + r:] += psum(Rrow, mesh, cols_axis)

    R, A_loc, QtB = _poison_if_unconverged(
        worst, torch.triu(R), A_loc, QtB if B_loc is not None else None)
    return A_loc, R, QtB


def _eye_block(m, row0, h, col0, c, dtype, device):
    """Rows [row0, row0 + h) and columns [col0, col0 + c) of eye(m)."""
    out = torch.zeros((h, c), dtype=dtype, device=device)
    rows = torch.arange(h, device=device)
    cols = rows + row0 - col0
    keep = (cols >= 0) & (cols < c)
    out[rows[keep], cols[keep]] = 1
    return out


def dist_block_qr_2d(
    A,
    mesh,
    block_size: int = 128,
    policy: DTypePolicy = POLICY_FP32,
    rows_axis: str = ROWS_AXIS,
    cols_axis: str = COLS_AXIS,
    b=None,
    panel_method: str = "householder",
    mode: str = "r",
    loop_mode: str = "unroll",
):
    """Blocked QR of A split over both axes of a 2-D mesh.

    Every rank passes the same global A (m x n) and ``b``.  The reflector
    tier returns R (n x n, replicated) for ``mode='r'`` (and any mode but
    'complete'); ``mode='complete'`` returns ``(Qt_loc, R)``, where Qt_loc
    is this rank's (m / dr) x (m / dc) block of Q^T (the JAX package
    returns Q^T, sharded over both axes); with ``b``, Q^T b with all m
    rows, replicated, comes last.  ``loop_mode='scan'`` runs the
    full-width panel loop (requires block_size | n).

    ``panel_method`` in ('bgs', 'bgs1', 'bgs2') runs 2-D Block
    Gram-Schmidt (``loop_mode`` is ignored): ``mode='reduced'`` returns
    ``(Q_loc, R)``, Q_loc this rank's (m / dr) x (n / dc) block of the
    reduced Q; ``mode='r'`` returns R; 'complete' needs m == n; with ``b``,
    Q^T b (n rows, replicated) comes last.  Needs m >= n, block_size | n,
    and panels that do not straddle column shards.  An unconverged chain
    leaves a NaN in R[0, 0] (and in each rank's Q_loc[0, 0]); there is no
    retry.
    """
    dev = mesh_device(mesh)
    A = as_device_tensor(A, dev).to(policy.panel)
    m, n = A.shape
    dr, dc = axis_size(mesh, rows_axis), axis_size(mesh, cols_axis)
    r = min(block_size, n)
    if m % dr or n % dc:
        raise ValueError(
            f"shape {tuple(A.shape)} must divide over mesh ({dr},{dc})")
    is_bgs = panel_method in _BGS
    if not is_bgs and (m // dr) % r:
        raise ValueError(
            f"block_size {r} must divide per-device rows {m // dr} (panel "
            "diagonal blocks may not straddle row shards)")
    if mode == "complete" and m % dc:
        raise ValueError(
            f"mode='complete' shards Q^T (m x m) over both axes: m = {m} "
            f"must divide over {cols_axis} ({dc})")
    if panel_method.startswith("cholqr") and (m // dr) < 2 * r:
        raise ValueError(
            f"cholqr leaves need per-device aspect >= 2: {m // dr} "
            f"rows/device vs block_size {block_size}; use block_size <= "
            f"{m // dr // 2} or panel_method='householder'")
    h, wc = m // dr, n // dc
    i, j = axis_index(mesh, rows_axis), axis_index(mesh, cols_axis)
    A_loc = A[i * h:(i + 1) * h, j * wc:(j + 1) * wc].contiguous()
    B_loc = None
    if b is not None:
        B = as_device_tensor(b, dev).to(policy.accum).reshape(m, -1)
        B_loc = B[i * h:(i + 1) * h].contiguous()

    if is_bgs:
        if mode not in ("r", "reduced", "complete"):
            raise ValueError(f"unknown mode {mode!r}")
        if m < n:
            raise ValueError(f"BGS needs m >= n, got {tuple(A.shape)}")
        if n % r:
            raise ValueError(
                f"BGS needs block_size | n ({block_size} vs {n})")
        if wc % r:
            raise ValueError(
                f"block_size {r} must divide per-device columns {wc} "
                "(panels may not straddle column shards)")
        if mode == "complete" and m != n:
            raise ValueError(
                "2-D BGS materializes the reduced Q (concatenation); "
                "complete-Q for m > n needs the reflector tiers")
        Q_loc, R, QtB = _dist2d_bgs_local(
            A_loc, B_loc, m=m, n=n, block_size=r, mesh=mesh,
            rows_axis=rows_axis, cols_axis=cols_axis, policy=policy,
            reorth=panel_method in ("bgs", "bgs2"))
        outs = [R]
        if mode in ("reduced", "complete"):
            outs.insert(0, Q_loc)
        if b is not None:
            outs.append(QtB)
        return tuple(outs) if len(outs) > 1 else outs[0]

    want_q = mode == "complete"
    Qt_loc = (_eye_block(m, i * h, h, j * (m // dc), m // dc, policy.accum,
                         dev) if want_q else None)
    A_out, B_out, Qt_out = _dist2d_local(
        A_loc, B_loc, Qt_loc, m=m, n=n, block_size=block_size, mesh=mesh,
        rows_axis=rows_axis, cols_axis=cols_axis, policy=policy,
        panel_method=panel_method, loop_mode=loop_mode)
    top = gather_rows(A_out, mesh, rows_axis)[:n].contiguous()
    R = torch.triu(gather_cols(top, mesh, cols_axis))
    outs = [R]
    if want_q:
        outs.insert(0, Qt_out)
    if B_out is not None:
        outs.append(gather_rows(B_out, mesh, rows_axis))
    return tuple(outs) if len(outs) > 1 else outs[0]
