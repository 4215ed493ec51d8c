"""Distributed blocked QR over the row-split ranks of a mesh axis (port of
``mixedprecisionblockqr_tpu/parallel/dist_qr.py``).

Every function below the entry point is SPMD: each rank of ``mesh[axis]``
runs it on its own row slab (h = m / d rows), and the collectives of
``parallel/mesh.py`` stand where the JAX package's ``shard_map`` bodies
call ``psum`` and ``all_gather``.  Every branch depends only on shapes
and on replicated values, so all ranks reach every collective together.

Two tiers, as in the JAX package:

  * Block Gram-Schmidt (``'bgs1'``, ``'bgs2'``, ``'bgs'``; ``quality=``):
    every panel keeps full height across the ranks.  The panel Gram is one
    (r x r) all-reduce, the triangular Newton-Schulz chain runs on every
    rank (``ns_chain``, K1 on the card), ``Q_k = P X`` is local and Q is
    the concatenation of the panels, row-split like A.
  * The reflector tier (``'householder'``, ``'cholqr2'``, ``'cholqr2s'``):
    each panel is a TSQR over the ranks (leaf QR on every rank, K6 on the
    card for Householder leaves; one all-gather of the leaf R factors; the
    reduction tree on every rank), turned into ONE block reflector
    ``H = I - Y S^-1 Y^T`` by the Yamamoto identity (S-inverse by K4, the
    LU inverse where K4's residual says so).  A trailing update is one all-reduce of an
    (r x n_trail) block; Q is accumulated transposed, its rows split, so
    each rank returns a column slab of Q.

Returned values: R (and Q^T b) replicated on every rank; Q as this rank's
row slab (BGS tiers) or column slab (reflector tier).  The JAX package's
reflector tier returns a complete-mode R row-split; here R is replicated
in every mode.
"""

from __future__ import annotations

from typing import Optional

import torch

from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
    QUALITY_LEVELS,
    _QUALITY_BGS,
    _poison_if_unconverged,
    _rescrub_panel,
)
from mixedprecisionblockqr_tpu_torch.ops.cholqr import (
    cholesky_qr2,
    lu_inv,
    newton_inv,
)
from mixedprecisionblockqr_tpu_torch.ops.householder import _mm
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
    _norm2_est,
    ninv_chain,
    ns_chain,
)
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
from mixedprecisionblockqr_tpu_torch.ops.wy import reduced_q_from_vt
from mixedprecisionblockqr_tpu_torch.parallel.mesh import (
    ROWS_AXIS,
    all_gather,
    axis_index,
    axis_size,
    gather_rows,
    mesh_device,
    psum,
    shard_rows,
)
from mixedprecisionblockqr_tpu_torch.parallel.tsqr import (
    householder_panel,
    reduction_tree,
)
from mixedprecisionblockqr_tpu_torch.utils.checks import NonFiniteError
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor


def _s_inverse(S: torch.Tensor) -> torch.Tensor:
    """Inverse of a panel's Yamamoto S: 12 Newton iterations (K4 on the
    card; ``newton_inv`` for float64), and the LU inverse only where the
    Newton residual is not below 1e-3 (or is NaN).  The residual is read
    on the host, one wait per panel: on the card that costs less than
    running the LU inverse of every panel for a ``torch.where`` (PERF.md
    §6, PR 16).  S is replicated, so every rank takes the same branch."""
    if S.dtype == torch.float64:
        return newton_inv(S, iters=12, check=True)
    Xn, nresid = ninv_chain(S.float().contiguous(), iters=12)
    X = Xn if float(nresid) < 1e-3 else lu_inv(S.float())
    return X.to(S.dtype)


def _panel_reflector_cols(P_cols, lam, w, h, mesh, axis,
                          panel_method="householder", square_final=False):
    """Factor panel columns [lam, lam + w) across the ranks (``P_cols``
    already sliced).  Returns ``(Y_loc (h x w), Sinv (w x w), R_panel (w x
    w))``, Sinv and R_panel replicated, R_panel sign-fixed.

    Rows above the panel are zeroed, so a leaf is a full-height h x w
    slab.  'cholqr2' / 'cholqr2s' leaves run CholeskyQR2; a rank whose rows
    all lie above the panel factors a regularized Gram instead and its
    leaf factors are masked to zero.  ``square_final`` (m - lam == w):
    S = I - Q1^T could be singular, so the (w x w) band is gathered and
    factored exactly as one Householder panel, whose (V, T) go back
    through the (Y, Sinv) slots."""
    my = axis_index(mesh, axis)
    dev, dtype = P_cols.device, P_cols.dtype
    glob = my * h + torch.arange(h, device=dev)
    k0 = min(max(lam - my * h, 0), h)  # first local row at or below lam
    P_loc = P_cols.clone()
    P_loc[:k0] = 0

    if square_final:
        band = all_gather(P_loc, mesh, axis).reshape(-1, w)[lam:lam + w]
        V, T, Rf = householder_panel(band)
        R_pan = torch.triu(Rf[:w, :])
        V_loc = V.new_zeros((h, w))
        lo, hi = max(lam, my * h), min(lam + w, my * h + h)
        if lo < hi:
            V_loc[lo - my * h:hi - my * h] = V[lo - lam:hi - lam]
        return V_loc, T, R_pan

    if panel_method in ("cholqr2", "cholqr2s"):
        alive = 1.0 if k0 < h else 0.0
        P_reg = P_loc + (1.0 - alive) * torch.eye(h, w, dtype=dtype,
                                                  device=dev)
        Q_leaf, R_loc = cholesky_qr2(P_reg,
                                     shifted=panel_method == "cholqr2s")
        Q_leaf = Q_leaf * alive
        R_loc = torch.triu(R_loc) * alive
    else:
        V, T, Rf = householder_panel(P_loc)
        Q_leaf = reduced_q_from_vt(V, T, w)
        R_loc = torch.triu(Rf[:w, :])

    F, R_pan = reduction_tree(all_gather(R_loc, mesh, axis))
    Q_red = _mm(Q_leaf, F[my])

    # The top (w x w) block of the panel's Q lives on rank lam // h.
    i0, loc = lam // h, lam % h
    Q1 = Q_red[loc:loc + w] if my == i0 else Q_red.new_zeros((w, w))
    Q1 = psum(Q1.clone(), mesh, axis)

    # Column signs: diag(Q1) <= 0 keeps S = I - Q1^T well-conditioned.
    D = torch.where(torch.diagonal(Q1) > 0, -1.0, 1.0).to(Q1.dtype)
    Q_red = Q_red * D[None, :]
    Q1 = Q1 * D[None, :]
    R_pan = R_pan * D[:, None]

    e1 = (glob[:, None] - lam) == torch.arange(w, device=dev)[None, :]
    Y_loc = Q_red - e1.to(Q_red.dtype)
    S = torch.eye(w, dtype=Q1.dtype, device=dev) - Q1.T
    return Y_loc, _s_inverse(S), R_pan


def _robust_panel_dist(P_loc, psum_gram, r):
    """The shifted three-pass panel on summed Grams (three Gram
    all-reduces through ``psum_gram``; the chains, K1 on the card, run on
    every rank): ``(Qk_loc, t, 0.01 * resid)``, the robust tier's
    residual scaled to the canary's 1e-2 breakdown threshold."""
    G = psum_gram(P_loc, P_loc)
    eye = torch.eye(r, dtype=torch.float32, device=G.device)
    Gs = G + (1e-3 * _norm2_est(G)) * eye
    X1, _, _ = ns_chain(Gs, iters=14, omega=False)
    t1 = mm_f32(X1.T, Gs)
    Q1 = mm_f32(P_loc, X1)
    X2, t2, _ = ns_chain(psum_gram(Q1, Q1), iters=12, omega=False)
    Q2 = mm_f32(Q1, X2)
    X3, t3, resid = ns_chain(psum_gram(Q2, Q2), iters=4, refine=True)
    t = torch.triu(mm_f32(t3, mm_f32(t2, t1)))
    return mm_f32(Q2, X3), t, 0.01 * resid


def _bgs_products(policy, reorth, mesh, axis):
    """``(mm_t, mm_p, psum_gram)`` of the BGS drivers: the policy's
    trailing products, the projections (fp32 on the reorth tiers: a scrub
    at bf16 would pin orthogonality at ~0.1) and the summed fp32 Gram."""
    mm_t = trailing_matmul(policy)
    mm_p = mm_f32 if reorth else mm_t

    def psum_gram(X, Y):
        return psum(mm_f32(X.T, Y), mesh, axis)

    return mm_t, mm_p, psum_gram


def _dist_bgs_local(A_loc, B_loc, *, m, n, block_size, mesh, axis, policy,
                    group_panels=4, reorth=True):
    """Distributed Block Gram-Schmidt, unrolled (the JAX package's
    ``_dist_bgs_local``).  Per panel: one Gram all-reduce and the chain
    (budgets by the global aspect m / r, +6 on the head panel, +4 on the
    last quarter); the last ``max(2, nb // 8)`` panels run the robust
    three-pass scheme, rescrubbed against the previous Q on the reorth
    tiers.  In-group and per-group trailing projections are one
    all-reduce each; ``reorth`` re-projects each group against all
    previous Q first (BCGS2, fp32).  Returns ``(Qbuf_loc (h x n) fp32, R
    (n x n), QtB (n x k))`` after the NaN canary."""
    h = A_loc.shape[0]
    r = block_size
    nb = n // r
    dev = A_loc.device
    mm_t, mm_p, psum_gram = _bgs_products(policy, reorth, mesh, axis)
    base_iters = tri_iters_for_aspect(m / r)
    worst = torch.zeros((), dtype=torch.float32, device=dev)
    Qbuf = torch.zeros((h, n), dtype=torch.float32, device=dev)
    R = torch.zeros((n, n), dtype=torch.float32, device=dev)
    kB = B_loc.shape[1] if B_loc is not None else 1
    QtB = torch.zeros((n, kB), dtype=torch.float32, device=dev)
    A_loc = A_loc.to(policy.panel, copy=True)

    i = 0
    while i < nb:
        lam_g = i * r
        js = list(range(i, min(i + group_panels, nb)))
        g_end = (js[-1] + 1) * r
        if reorth and lam_g > 0:
            Cg = A_loc[:, lam_g:g_end].float()
            Qprev = Qbuf[:, :lam_g]
            C2 = psum(mm_f32(Qprev.T, Cg), mesh, axis)
            A_loc[:, lam_g:g_end] = (Cg - mm_f32(Qprev, C2)).to(A_loc.dtype)
            R[:lam_g, lam_g:g_end] += C2
        for j in js:
            lam = j * r
            P_loc = A_loc[:, lam:lam + r].float()
            if j >= nb - max(2, nb // 8):
                Qk, t, rresid = _robust_panel_dist(P_loc, psum_gram, r)
                worst = torch.maximum(worst, rresid)
                if reorth and lam > 0:
                    Qk, t, dW, rs = _rescrub_panel(
                        Qbuf[:, :lam], Qk, t,
                        reduce=lambda x: psum(x, mesh, axis))
                    R[:lam, lam:lam + r] += dW
                    worst = torch.maximum(worst, rs * rs)
            else:
                if j == 0:
                    iters = tri_head_iters(base_iters)
                else:
                    iters = base_iters if j < 0.75 * nb else base_iters + 4
                X, t, resid = ns_chain(psum_gram(P_loc, P_loc), iters=iters)
                Qk = mm_f32(P_loc, X)
                worst = torch.maximum(worst, resid * resid)
            R[lam:lam + r, lam:lam + r] = t
            Qbuf[:, lam:lam + r] = Qk
            if lam + r < g_end:
                C = A_loc[:, lam + r:g_end]
                G1 = psum(mm_p(Qk.T, C), mesh, axis)
                A_loc[:, lam + r:g_end] = (C - mm_p(Qk, G1)).to(A_loc.dtype)
                R[lam:lam + r, lam + r:g_end] = G1
            if B_loc is not None:
                QtB[lam:lam + r] = psum(mm_t(Qk.T, B_loc), mesh, axis)
        if g_end < n:
            Qg = Qbuf[:, lam_g:g_end]
            C = A_loc[:, g_end:]
            G1 = psum(mm_p(Qg.T, C), mesh, axis)
            A_loc[:, g_end:] = (C - mm_p(Qg, G1)).to(A_loc.dtype)
            R[lam_g:g_end, g_end:] = G1
        i = js[-1] + 1

    R, Qbuf, QtB = _poison_if_unconverged(
        worst, torch.triu(R), Qbuf, QtB if B_loc is not None else None)
    return Qbuf, R, QtB


def _dist_bgs_scan_local(A_loc, B_loc, *, m, n, block_size, mesh, axis,
                         policy, reorth=True, group_panels=1,
                         reorth_grouped=False):
    """Distributed Block Gram-Schmidt, one step per group of panels (the
    JAX package's ``_dist_bgs_scan_local``).  Each step projects its
    group's columns against the Q written so far (one all-reduced pass;
    two with ``reorth``), then factors each panel: pre-tail panels with
    one Gram all-reduce and the chain at the head panel's budget, the last
    ``max(2, nb // 8)`` with the robust three-pass scheme; the reorth
    tiers rescrub the panels of the last ``ceil(max(2, nb // 8) / g)``
    steps.  ``g = group_panels`` when it divides nb and the tier is bgs1
    or ``reorth_grouped`` ('bgs2'), else 1.  The JAX package projects
    against the whole zero-initialized Q buffer; here against its written
    prefix, the same values to summation order.  Returns ``(Qbuf_loc,
    R, QtB)`` after the NaN canary, Qbuf in fp32 on the reorth tiers and
    in the policy's storage dtype on bgs1."""
    h = A_loc.shape[0]
    r = block_size
    nb = n // r
    dev = A_loc.device
    mm_t, mm_p, psum_gram = _bgs_products(policy, reorth, mesh, axis)
    plain_iters = tri_head_iters(tri_iters_for_aspect(m / r))
    q_dtype = policy.q_store or policy.accum
    qbuf_dtype = torch.float32 if reorth else q_dtype
    A_loc = A_loc.to(policy.panel)
    Qbuf = torch.zeros((h, n), dtype=qbuf_dtype, device=dev)
    R = torch.zeros((n, n), dtype=torch.float32, device=dev)
    kB = B_loc.shape[1] if B_loc is not None else 1
    QtB = torch.zeros((n, kB), dtype=torch.float32, device=dev)
    worst = torch.zeros((), dtype=torch.float32, device=dev)

    g = (group_panels
         if group_panels > 1 and nb % group_panels == 0
         and (not reorth or reorth_grouped) else 1)
    gw = g * r
    n_robust = max(2, nb // 8)
    n_steps = nb // g
    rescrub_from = n_steps - min(n_steps, -(-n_robust // g))

    for k in range(n_steps):
        lam_g = k * gw
        Cg = A_loc[:, lam_g:lam_g + gw].to(torch.float32, copy=True)
        if lam_g > 0:
            Qpre = Qbuf[:, :lam_g]
            C = psum(mm_p(Qpre.T, Cg), mesh, axis)
            Cg = Cg - mm_p(Qpre, C)
            if reorth:
                C2 = psum(mm_p(Qpre.T, Cg), mesh, axis)
                Cg = Cg - mm_p(Qpre, C2)
                C = C + C2
            R[:lam_g, lam_g:lam_g + gw] = C
        for j in range(g):
            lam = lam_g + j * r
            P = Cg[:, j * r:(j + 1) * r]
            if k * g + j >= nb - n_robust:
                Qk, t, resid = _robust_panel_dist(P, psum_gram, r)
            else:
                X, t, resid = ns_chain(psum_gram(P, P), iters=plain_iters)
                Qk = mm_f32(P, X)
                resid = resid * resid
            worst = torch.maximum(worst, resid)
            if reorth and k >= rescrub_from:
                Qk, t, dW, rs = _rescrub_panel(
                    Qbuf[:, :lam], Qk, t,
                    reduce=lambda x: psum(x, mesh, axis))
                worst = torch.maximum(worst, rs * rs)
                R[:lam, lam:lam + r] += dW
            Qbuf[:, lam:lam + r] = Qk.to(qbuf_dtype)
            R[lam:lam + r, lam:lam + r] = t
            if j + 1 < g:
                Ct = Cg[:, (j + 1) * r:]
                G1 = psum(mm_p(Qk.T, Ct), mesh, axis)
                Cg[:, (j + 1) * r:] = Ct - mm_p(Qk, G1)
                R[lam:lam + r, lam + r:lam_g + gw] = G1
            if B_loc is not None:
                QtB[lam:lam + r] = psum(mm_t(Qk.T, B_loc), mesh, axis)

    R, Qbuf, QtB = _poison_if_unconverged(
        worst, torch.triu(R), Qbuf, QtB if B_loc is not None else None)
    return Qbuf, R, QtB


def _dist_qr_local(A_loc, Q_loc, B_loc, *, m, n, block_size, mesh, axis,
                   policy, panel_method="householder", loop_mode="unroll"):
    """The reflector tier's panel loop on this rank's slabs (the JAX
    package's ``_dist_qr_local``).  ``Q_loc`` (h x m) holds this rank's
    rows of Q^T.  Returns ``(A_loc, Q_loc, B_loc)`` after every panel:
    A_loc's rows of R (zero below the diagonal), Q^T's rows and Q^T B's
    rows."""
    h = A_loc.shape[0]
    r = min(block_size, n)
    if h % r != 0 and n > r:
        raise ValueError(
            f"block_size {r} must divide per-device rows {h} (m={m})")
    dev = A_loc.device
    row0 = axis_index(mesh, axis) * h  # this rank's first global row
    mm_t, mm_q = trailing_matmul(policy), q_matmul(policy)
    A_loc = A_loc.clone()

    def apply(A_loc, Q_loc, B_loc, Y, Sinv, col0):
        """``C <- C - Y Sinv^T (sum Y^T C)`` (H^T C) on A's columns from
        col0 and on B, and ``Q^T <- (Q H)^T``: one all-reduce each."""
        if col0 < n:
            C = A_loc[:, col0:]
            G = psum(mm_t(Y.T, C), mesh, axis)
            A_loc[:, col0:] = (C - mm_t(Y, _mm(Sinv.T, G))).to(A_loc.dtype)
        if B_loc is not None:
            Gb = psum(mm_t(Y.T, B_loc), mesh, axis)
            B_loc = B_loc - mm_t(Y, _mm(Sinv.T, Gb))
        if Q_loc is not None:
            QY = psum(mm_q(Q_loc.T, Y), mesh, axis)
            Q_loc = Q_loc - mm_q(Y, _mm(QY, Sinv).T)
        return A_loc, Q_loc, B_loc

    if loop_mode == "scan":
        # Every panel but the last applies H^T to A's full width: finished
        # columns are invariant and the panel becomes [R; 0].  The square-
        # hostile last panel takes Householder leaves.
        if n % r != 0:
            raise ValueError(f"scan mode needs block_size | n ({r} vs {n})")
        for k in range(n // r - 1):
            lam = k * r
            Y, Sinv, _ = _panel_reflector_cols(
                A_loc[:, lam:lam + r], lam, r, h, mesh, axis, panel_method)
            A_loc, Q_loc, B_loc = apply(A_loc, Q_loc, B_loc, Y, Sinv, 0)
        lam = n - r
        Y, Sinv, _ = _panel_reflector_cols(
            A_loc[:, lam:], lam, r, h, mesh, axis, "householder",
            square_final=(m - lam == r))
        A_loc, Q_loc, B_loc = apply(A_loc, Q_loc, B_loc, Y, Sinv, 0)
        glob = row0 + torch.arange(h, device=dev)
        cols = torch.arange(n, device=dev)[None, :]
        A_loc = torch.where(cols >= glob[:, None], A_loc, 0.0)
        return A_loc, Q_loc, B_loc

    for lam in range(0, n, r):
        w = min(r, n - lam)
        # Hybrid rule: CholeskyQR leaves square the condition number, so a
        # panel of global aspect < 2 takes Householder leaves.
        pm = panel_method
        if pm in ("cholqr2", "cholqr2s") and (m - lam) < 2 * w:
            pm = "householder"
        Y, Sinv, R_pan = _panel_reflector_cols(
            A_loc[:, lam:lam + w], lam, w, h, mesh, axis, pm,
            square_final=(m - lam == w))
        # Panel columns: rows in [lam, lam + w) <- R_pan, rows below <- 0
        # (local rows [b0, b1) and [b1, h): slices, no host wait).
        b0, b1 = (min(max(g - row0, 0), h) for g in (lam, lam + w))
        pan = A_loc[:, lam:lam + w]
        pan[b1:] = 0
        pan[b0:b1] = R_pan[b0 + row0 - lam:b1 + row0 - lam].to(A_loc.dtype)
        A_loc, Q_loc, B_loc = apply(A_loc, Q_loc, B_loc, Y, Sinv, lam + w)
    return A_loc, Q_loc, B_loc


def dist_block_qr(
    A,
    mesh,
    block_size: int = 128,
    policy: DTypePolicy = POLICY_FP32,
    axis: str = ROWS_AXIS,
    mode: str = "reduced",
    b=None,
    panel_method: str = "householder",
    loop_mode: str = "unroll",
    group_panels: int = 4,
    quality: Optional[str] = None,
):
    """Distributed blocked QR of A with its rows split over ``mesh[axis]``.

    Every rank passes the same global A (m x n) and, with ``mode='r'``,
    ``b``.  Returns ``(Q_loc, R)`` (``mode`` 'reduced' or 'complete'),
    ``(Q_loc, R, QtB)`` when ``b`` is given with a Q mode, or R / ``(R,
    QtB)`` for ``mode='r'``.  R and QtB are replicated; ``Q_loc`` is this
    rank's slab: rows [i h, (i + 1) h) of Q on the BGS tiers, columns [i
    c, (i + 1) c) of Q on the reflector tier (c = n / d reduced, h
    complete).  The reflector tier's R has m rows in 'complete' mode.

    ``quality`` is the ladder of ``qr(quality=...)``: 'fast' -> bgs1,
    'balanced' -> bgs2, 'high' -> bgs, 'robust' -> 'householder'; it
    overrides ``panel_method``, and an unrolled BGS tier of more than 32
    panels switches to ``loop_mode='scan'``.  ``group_panels`` groups the
    BGS projections.  A NaN canary in the BGS tiers' R (read on the host;
    R is the same on every rank, so all ranks take the same branch)
    reruns the factorization through 'householder', and raises
    ``NonFiniteError`` if that fails too.  On the card the NS kernels take
    any ``block_size`` up to ``ops/kernels/ns.py::MAX_WIDTH``.
    """
    if quality is not None:
        if quality not in QUALITY_LEVELS:
            raise ValueError(
                f"quality must be one of {QUALITY_LEVELS}, got {quality!r}")
        panel_method = _QUALITY_BGS.get(quality, "householder")
        n_ = A.shape[1]
        r_ = min(block_size, n_)
        if (panel_method.startswith("bgs") and loop_mode == "unroll"
                and n_ % r_ == 0 and n_ // r_ > 32):
            loop_mode = "scan"
    if mode not in ("reduced", "complete", "r"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = mesh_device(mesh)
    A = as_device_tensor(A, dev).to(policy.panel)
    m, n = A.shape
    d = axis_size(mesh, axis)
    if m % d:
        raise ValueError(f"rows {m} must divide across {d} devices")
    h = m // d
    B = (None if b is None else
         as_device_tensor(b, dev).to(policy.accum).reshape(m, -1))
    B_loc = None if B is None else shard_rows(B, mesh, axis)
    A_loc = shard_rows(A, mesh, axis)

    if panel_method in ("bgs", "bgs1", "bgs2"):
        if n % min(block_size, n) != 0 or n < 2 * block_size:
            raise ValueError(
                f"dist bgs needs block_size | n and n >= 2*block_size "
                f"(block_size {block_size}, n {n})")
        if mode == "complete" and m != n:
            raise ValueError(
                "dist bgs materializes the reduced Q (m x n); complete-Q "
                "for m > n needs the reflector tier "
                "(panel_method='cholqr2s' or 'householder')")
        reorth = panel_method in ("bgs", "bgs2")
        kw = dict(m=m, n=n, block_size=min(block_size, n), mesh=mesh,
                  axis=axis, policy=policy, group_panels=group_panels,
                  reorth=reorth)
        if loop_mode == "scan":
            Qbuf, R, QtB = _dist_bgs_scan_local(
                A_loc, B_loc, reorth_grouped=panel_method == "bgs2", **kw)
        else:
            Qbuf, R, QtB = _dist_bgs_local(A_loc, B_loc, **kw)
        if not bool(torch.isfinite(R[0, 0])):
            # NaN canary: retry through the robust reflector tier.
            out = dist_block_qr(A, mesh, block_size=block_size,
                                policy=policy, axis=axis, mode=mode, b=b,
                                panel_method="householder",
                                loop_mode=loop_mode)
            R_retry = out[1] if isinstance(out, tuple) and mode != "r" else (
                out[0] if isinstance(out, tuple) else out)
            if not bool(torch.isfinite(R_retry).all()):
                raise NonFiniteError(
                    "dist_block_qr: non-finite factorization even via "
                    "'householder' - the input likely contains NaN/Inf")
            return out
        if mode == "r":
            return (R, QtB) if b is not None else R
        # The reorth tiers return Q at accumulation precision.
        q_dtype = (policy.accum if reorth
                   else (policy.q_store or policy.accum))
        out = (Qbuf.to(q_dtype), R)
        return out + ((QtB,) if b is not None else ())

    if panel_method.startswith("cholqr") and h < 2 * min(block_size, n):
        raise ValueError(
            f"cholqr leaves need per-device aspect >= 2: {h} rows/device "
            f"vs block_size {block_size}; use block_size <= {h // 2} or "
            "panel_method='householder'")
    if mode == "reduced" and n % d:
        raise ValueError(
            f"the reduced Q's columns ({n}) must divide over mesh axis "
            f"{axis} ({d})")
    my = axis_index(mesh, axis)
    Q_loc = None
    if mode != "r":
        Q_loc = torch.zeros((h, m), dtype=policy.accum, device=dev)
        Q_loc[:, my * h:(my + 1) * h] = torch.eye(h, dtype=policy.accum,
                                                  device=dev)
    A_out, Qt_loc, B_out = _dist_qr_local(
        A_loc, Q_loc, B_loc, m=m, n=n, block_size=block_size, mesh=mesh,
        axis=axis, policy=policy, panel_method=panel_method,
        loop_mode=loop_mode)
    R_full = torch.triu(gather_rows(A_out, mesh, axis))
    QtB = None if B_out is None else gather_rows(B_out, mesh, axis)
    R = R_full if mode == "complete" else R_full[:n].contiguous()
    if mode == "r":
        return (R, QtB) if QtB is not None else R
    if mode == "reduced":
        c = n // d
        Qt_top = gather_rows(Qt_loc, mesh, axis)[my * c:(my + 1) * c]
        Q = Qt_top.T.contiguous()
    else:
        Q = Qt_loc.T.contiguous()
    return (Q, R, QtB) if QtB is not None else (Q, R)
