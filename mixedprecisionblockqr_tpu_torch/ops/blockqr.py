"""Blocked QR drivers (port of ``mixedprecisionblockqr_tpu/ops/blockqr.py``).

``block_qr``/``qr``/``block_qr_qtb`` dispatch through
``resolve_panel_config`` exactly as the JAX package does, to one of:
  * the right-looking Block Gram-Schmidt tiers ``bgs1`` (single pass, bf16
    projections), ``bgs2`` (BCGS2 re-projection at emulated HIGH
    precision) and ``bgs`` (re-projection at fp32): ``_block_qr_bgs``;
  * ``polar``: triangular-NS panels through ``ns_chain`` (K1), Yamamoto
    S-inverses through ``ninv_chain`` (K4) and group-merged W-form
    reflectors: ``_block_qr_grouped``;
  * the reflector tiers of ``_block_qr_traced``: ``householder``
    (``panel_factor``'s column loop; on CUDA, fp32 panels of any width
    through K6), ``householder_pallas`` (every panel
    through ``panel_factor_fused``, K6), ``cholqr1``/``cholqr2``/
    ``cholqr2s`` (CholeskyQR panels applied through the Yamamoto
    reflector, with K6 for panels of aspect < 2 on the GPU) and the paired
    ``cholqr1x2``;
  * the cholqr scan tier ``_block_qr_scan`` (``loop_mode='scan'``): K4
    with an on-device LU fallback per panel;
  * the BGS scan tier ``_block_qr_bgs_scan`` (``loop_mode='scan'`` with a
    BGS method, and every ``'auto'`` input with ``max(m, n) > 12288``):
    one step function over a preallocated Q buffer, every panel robust,
    through ``panel_qr_fused`` (K3) or the three-chain K1 composition;
    ``models/resumable.py`` checkpoints the same step.
A CUDA tensor takes the dispatch branch of the accelerator; a CPU tensor
with ``panel_method='auto'`` resolves to ``'householder'``, as in the JAX
package, and every kernel wrapper runs its plain version on the CPU.
``check='sync'`` retries a poisoned factorization as
``_sync_retry_method`` says.

Each BGS group of panels runs through ``bgs_group_fused`` (kernel K2) when
the group buffer passes the same size gate as the JAX package (with
``proj_entry``, every group after the first through
``bgs_group_fused_proj``, K5); otherwise
each panel runs ``ns_chain`` (kernel K1) between plain products.  On a
(B, m, n) stack (``block_qr_batched``) the same steps run once for all
members, through the batched entries of K2 and K1 (and, for ``polar``, of
K1 and K4).  A
float64 panel always takes ``panel_factor``: K6 is fp32, as the TPU kernel
is, and a POLICY_FP64 factorization stays float64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.cholqr import (
    _sign_fix,
    cholesky_qr2,
    lu_inv,
    newton_inv,
    newton_iters_for_aspect,
    yamamoto_reflector,
)
from mixedprecisionblockqr_tpu_torch.ops.householder import (
    householder_qr,
    panel_factor,
)
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
    bgs_group_fused,
    bgs_group_fused_batched,
    bgs_group_fused_proj,
    ninv_chain,
    ninv_chain_batched,
    ns_chain,
    ns_chain_batched,
    panel_qr_fused,
    tri_cholqr_fused,
    tri_cholqr_robust_fused,
)
from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
    panel_factor_fused,
    panel_factor_fused_batched,
)
from mixedprecisionblockqr_tpu_torch.ops.polar import (
    tri_head_iters,
    tri_iters_for_aspect,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import (
    DTypePolicy,
    POLICY_FP32,
    Precision,
    accum_matmul,
    matmul,
    mm_f32,
    q_matmul,
    trailing_matmul,
)
from mixedprecisionblockqr_tpu_torch.ops.wy import (
    apply_block_reflector_left_t,
    apply_block_reflector_right,
)
from mixedprecisionblockqr_tpu_torch.utils.checks import NonFiniteError
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

DEFAULT_BLOCK_SIZE = 128
DEFAULT_GROUP_PANELS = 4

_NS_TIERS = ("bgs", "bgs1", "bgs2", "polar")
_BGS_TIERS = ("bgs", "bgs1", "bgs2")
_CHOLQR_TIERS = ("cholqr1", "cholqr2", "cholqr2s")
QUALITY_LEVELS = ("fast", "balanced", "high", "robust")
_QUALITY_BGS = {"fast": "bgs1", "balanced": "bgs2", "high": "bgs"}

#: The group-kernel gate of the JAX package (``_group_kernel_fits``): a
#: group buffer m x g*r of at most 10 MiB fp32 and m <= 5120.  The numbers
#: were tuned for the TPU's scoped VMEM; they are kept so that dispatch
#: (group kernel vs per-panel chains) stays in step with the reference.
GROUP_KERNEL_MAX_BYTES = 10 * 2**20
GROUP_KERNEL_MAX_M = 5120

def check_policy_method(policy: DTypePolicy, panel_method: str) -> None:
    """Refuse fp64 on the fp32-chain Newton-Schulz tiers."""
    if policy.panel == torch.float64 and panel_method in _NS_TIERS:
        raise ValueError(
            f"panel_method {panel_method!r} runs fp32 NS chains and cannot "
            "honor POLICY_FP64; use 'householder' (or 'cholqr2', whose "
            "Cholesky path preserves the input dtype)"
        )


def resolve_panel_config(
    m: int,
    n: int,
    block_size: int,
    policy: DTypePolicy,
    panel_method: str,
    loop_mode: str,
    group_panels: int,
    mode: str = "reduced",
    on_gpu: Optional[bool] = None,
    quality: Optional[str] = None,
) -> Tuple[str, str, int]:
    """The dispatch table: resolve ``panel_method='auto'`` and apply the
    shape-fallback chain, returning ``(panel_method, loop_mode,
    group_panels)``.  Returns the JAX package's tuples for every shape,
    with ``on_gpu`` in the role of its ``on_tpu`` (default: whether CUDA
    is available).  The size thresholds (3072, 12288) were measured on the
    TPU and wait to be measured again on the H100."""
    if on_gpu is None:
        on_gpu = torch.cuda.is_available()
    if quality is not None:
        if quality not in QUALITY_LEVELS:
            raise ValueError(
                f"quality must be one of {QUALITY_LEVELS}, got {quality!r}"
            )
        if panel_method != "auto":
            raise ValueError(
                "quality= is the auto-dispatch ladder knob; it cannot be "
                f"combined with an explicit panel_method={panel_method!r}"
            )
    r = min(block_size, n)
    if panel_method == "auto":
        hostile = n % r != 0 or n < 2 * block_size or m < n
        if (
            not on_gpu
            or hostile
            or policy.panel == torch.float64
            or quality == "robust"
        ):
            panel_method = "householder"
        elif policy.trailing == torch.float32:
            panel_method = _QUALITY_BGS["high" if quality is None else quality]
            if max(m, n) > 12288:
                loop_mode = "scan"
        elif quality in ("balanced", "high"):
            panel_method = _QUALITY_BGS[quality]
            if max(m, n) > 12288:
                loop_mode, group_panels = "scan", 4
            else:
                group_panels = 8
        elif max(m, n) <= 12288:
            panel_method, group_panels = "bgs1", 8
        else:
            panel_method, loop_mode = "bgs1", "scan"
    else:
        check_policy_method(policy, panel_method)

    if panel_method in _BGS_TIERS and (
        n % r != 0
        or n < 2 * block_size
        or (mode == "complete" and m != n)
    ):
        panel_method = "polar"
    if panel_method == "polar" and (n % r != 0 or n < 2 * block_size):
        panel_method = "cholqr1"
    if loop_mode == "scan" and (
        n % r != 0
        or not (panel_method.startswith("cholqr")
                or panel_method in _BGS_TIERS)
        or n <= block_size
    ):
        loop_mode = "unroll"
    return panel_method, loop_mode, group_panels


def _group_kernel_fits(m0: int, r: int, group_panels: int) -> bool:
    """Whether a group goes through ``bgs_group_fused`` (see
    ``GROUP_KERNEL_MAX_BYTES``)."""
    return (m0 <= GROUP_KERNEL_MAX_M
            and m0 * r * group_panels * 4 <= GROUP_KERNEL_MAX_BYTES)


def _sync_retry_method(panel_method, loop_mode, policy, mode, m, n):
    """The robust retry target of ``check='sync'``, or None when the
    primary method already is it.  Unrolled: 'householder' (exact for any
    input, rank-deficient ones included).  Scan: the all-robust scan-BGS
    tier 'bgs', or 'cholqr2s' where BGS's contract does not hold (complete
    Q with m > n, fp64)."""
    if loop_mode == "scan":
        bgs_ok = (mode != "complete" or m == n) and (
            policy.panel != torch.float64)
        retry = "bgs" if bgs_ok else "cholqr2s"
    else:
        retry = "householder"
    return None if retry == panel_method else retry


def _poison_if_unconverged(worst_resid, R_full, Q, B, tol: float = 1e-4):
    """Write a NaN canary into R[0, 0] (and Q[0, 0], B[0, 0]) when the
    worst normalized NS residual is not below ``tol`` -- or is NaN.  For
    stacks ``worst_resid`` holds one residual a member, and only the
    members whose residual fails are poisoned (the JAX package's ``vmap``
    of the canary).  Stays on the device: no host synchronization."""
    bad = torch.where(worst_resid < tol, torch.zeros_like(worst_resid),
                      torch.full_like(worst_resid, float("nan")))
    for X in (R_full, Q, B):
        if X is not None:
            X[..., 0, 0] += bad.to(X.dtype)
    return R_full, Q, B


def _rescrub_panel(Qpre, qk, t, reduce=None):
    """The corner-leak rescrub of the reorth tiers' robust tail (D9): one
    fp32 projection of the finished panel against all previous Q plus a
    4-iteration refactorization, folded so that ``qk t = q2 (s t) +
    Qpre (W t)``.  Returns ``(q2, s @ t, W @ t, resid)``.  The distributed
    drivers pass ``reduce``, which sums a tensor over the ranks that hold
    the row slabs of ``Qpre`` and ``qk`` (both W and the Gram of q2).  On
    stacks (B, m, p) / (B, m, r) every member is rescrubbed, its chain one
    member of one ``ns_chain_batched`` call, and ``resid`` is one a
    member."""
    qf = qk.float()
    Qp = Qpre.float()
    W = mm_f32(Qp.mT, qf)
    if reduce is not None:
        W = reduce(W)
    q2 = qf - mm_f32(Qp, W)
    Gq = mm_f32(q2.mT, q2)
    if reduce is not None:
        Gq = reduce(Gq)
    X, s, rs = (ns_chain_batched if Gq.dim() == 3 else ns_chain)(Gq, iters=4)
    q2 = mm_f32(q2, X)
    t32 = t.float()
    return q2, mm_f32(s, t32), mm_f32(W, t32), rs


def _block_qr_bgs(
    A: torch.Tensor,
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    B: Optional[torch.Tensor] = None,
    group_panels: int = 4,
    reorth: bool = True,
    ns_impl: str = "group",
    mid_tier: bool = False,
    chain_mid: bool = False,
    proj_entry: bool = False,
):
    """Right-looking Block Gram-Schmidt QR; returns ``(R_full, Q, QtB)``.

    Panels keep full height, Q materializes by concatenation, R rows are
    written directly, and the trailing projection runs once per group.
    ``ns_impl='group'`` factors each group with ``bgs_group_fused`` while
    the group buffer passes ``_group_kernel_fits``; ``'panel'`` (the JAX
    package's ``'pallas'`` level) runs every panel's chain through
    ``ns_chain`` between plain products.  ``reorth`` re-projects each
    group against all previous Q (BCGS2) at emulated HIGH (``mid_tier``)
    or fp32.  The last ``n_robust`` panels run the shifted three-pass
    chain; chain budgets follow the JAX package's calibration (aspect
    budget, +6 on the head panel, +4 on the last quarter).  With ``B``
    (m x k), ``QtB = Q^T B`` is formed panel by panel and Q need not be
    kept.  ``proj_entry`` (effective only on the group route without
    ``reorth``; off in every public path, as in the JAX package) drops the
    trailing projection between groups: every group after the first goes
    raw into ``bgs_group_fused_proj``, which scrubs it against the Q
    written so far.  ``A`` is not modified.

    ``A`` may also be a stack (B, m, n), with ``B`` (B, m, k): the JAX
    package's ``vmap`` of this driver.  Every member takes the same steps:
    a group of all members is one ``bgs_group_fused_batched`` call, the
    per-panel route's and the robust tail's chains one ``ns_chain_batched``
    launch each, the products run on the stacks (batched products), and
    each member keeps its own canary.  A stack of one runs as one matrix,
    with the same kernel calls and results.  ``proj_entry`` takes one
    matrix (K5 has no batched entry).
    """
    if ns_impl not in ("group", "panel"):
        raise ValueError(f"ns_impl must be 'group' or 'panel', got {ns_impl!r}")
    if A.dim() == 3 and A.shape[0] == 1:
        outs = _block_qr_bgs(A[0], block_size, policy, want_q,
                             None if B is None else B[0], group_panels,
                             reorth, ns_impl, mid_tier, chain_mid,
                             proj_entry)
        return tuple(None if x is None else x[None] for x in outs)
    *batch, m, n = A.shape
    r = block_size
    if n % r != 0 or m < n or n < r:
        raise ValueError(f"BGS needs r | n and m >= n; got "
                         f"{tuple(A.shape)}, r={r}")
    if batch and proj_entry:
        raise ValueError("proj_entry takes one matrix: "
                         "bgs_group_fused_proj (K5) has no batched entry")
    nb = n // r
    # Min-two-groups shrink first, then the size gate on the effective width.
    if ns_impl == "group" and nb <= group_panels:
        group_panels = max(2, nb // 2)
    use_group = ns_impl == "group" and _group_kernel_fits(m, r, group_panels)
    proj_entry = proj_entry and use_group and not reorth

    base_iters = tri_iters_for_aspect(m / r)

    def _plain_iters(j: int) -> int:
        if j == 0:
            return tri_head_iters(base_iters)
        return base_iters if j < 0.75 * nb else base_iters + 4

    n_robust = max(1, nb // 12) if m / r >= 8 else max(2, nb // 8)

    dev = A.device
    T = A.to(policy.panel)
    worst = torch.zeros(batch, dtype=torch.float32, device=dev)
    mm_t = trailing_matmul(policy)
    mm_e = mm_f32 if reorth else mm_t
    gram_prec = (
        Precision.HIGHEST
        if policy.trailing == torch.float32 or mid_tier or reorth
        else Precision.HIGH
    )
    R = torch.zeros((*batch, n, n), dtype=torch.float32, device=dev)
    qcols = []
    qtb = []
    q_dtype = policy.accum if reorth else (policy.q_store or policy.accum)
    cast_early = (not reorth and q_dtype != policy.accum
                  and policy.trailing == q_dtype)
    # With proj_entry the buffer is K5's Qprev source, wanted or not.
    Qacc = (torch.zeros((*batch, m, n), dtype=q_dtype, device=dev)
            if (want_q or proj_entry) and not reorth else None)
    is_bf16 = policy.trailing == torch.bfloat16
    group_fused = bgs_group_fused_batched if batch else bgs_group_fused
    chain = ns_chain_batched if batch else ns_chain

    i = 0
    while i < nb:
        lam_g = i * r
        js = list(range(i, min(i + group_panels, nb)))
        g_end = (js[-1] + 1) * r
        gw = g_end - lam_g
        Pbuf, T = T[..., :gw], T[..., gw:]
        if reorth and lam_g > 0:
            Qprev = torch.cat(qcols, dim=-1)
            Cg = Pbuf.float()
            rp = Precision.HIGH if mid_tier else Precision.HIGHEST
            C2 = matmul(Qprev.mT, Cg, precision=rp)
            Pbuf = (Cg - matmul(Qprev, C2, precision=rp)).to(Pbuf.dtype)
            R[..., :lam_g, lam_g:g_end] += C2
        robust_js = tuple(j >= nb - n_robust for j in js)
        if use_group:
            iters_js = tuple(_plain_iters(j) for j in js)
            if proj_entry and lam_g > 0:
                Qg, Rprev, Rg, resid = bgs_group_fused_proj(
                    Pbuf.float().contiguous(), Qacc[:, :lam_g], r, iters_js,
                    robust_js, bf16_dots=is_bf16, bf16_gram=is_bf16,
                    chain_mid=chain_mid,
                )
                R[:lam_g, lam_g:g_end] = Rprev
            else:
                Qg, Rg, resid = group_fused(
                    Pbuf.float().contiguous(), r, iters_js, robust_js,
                    bf16_dots=is_bf16 and not reorth,
                    bf16_gram=is_bf16 and not reorth,
                    chain_mid=chain_mid,
                )
            worst = torch.maximum(worst, resid)
            R[..., lam_g:g_end, lam_g:g_end] = Rg
            if reorth and any(robust_js):
                k0 = robust_js.index(True) * r
                rob0 = lam_g + k0
                if rob0 > 0:
                    pre = ([torch.cat(qcols, dim=-1)] if qcols else []) + (
                        [Qg[..., :k0]] if k0 else [])
                    q2, t2, dW, rs = _rescrub_panel(
                        torch.cat(pre, dim=-1), Qg[..., k0:],
                        Rg[..., k0:, k0:])
                    worst = torch.maximum(worst, rs * rs)
                    R[..., :rob0, rob0:g_end] += dW
                    R[..., rob0:g_end, rob0:g_end] = t2
                    Qg = torch.cat([Qg[..., :k0], q2], dim=-1) if k0 else q2
            if cast_early:
                Qg = Qg.to(q_dtype)
            if B is not None:
                qtb.append(mm_t(Qg.mT, B))
            if Qacc is not None:
                Qacc[..., lam_g:g_end] = Qg.to(q_dtype)
            qcols.append(Qg)
            # proj_entry: the next group's kernel scrubs its own columns.
            if g_end < n and not proj_entry:
                G1 = mm_t(Qg.mT, T)
                T = (T - mm_t(Qg, G1)).to(T.dtype)
                R[..., lam_g:g_end, g_end:] = G1
            i = js[-1] + 1
            continue
        q_start = len(qcols)
        Pbuf = Pbuf.clone()  # updated in place below; never a view of A
        for j in js:
            lam = j * r
            c0 = lam - lam_g
            P = Pbuf[..., c0:c0 + r]
            if j >= nb - n_robust:
                Qk, t, _, rresid = tri_cholqr_robust_fused(
                    P, chain_mid=chain_mid)
                worst = torch.maximum(worst, 0.01 * rresid)
                if reorth and qcols:
                    Qk, t, dW, rs = _rescrub_panel(
                        torch.cat(qcols, dim=-1), Qk, t)
                    worst = torch.maximum(worst, rs * rs)
                    R[..., :lam, lam:lam + r] += dW
            else:
                G = matmul(P.mT, P, precision=gram_prec)
                X, t, resid = chain(G.contiguous(), iters=_plain_iters(j),
                                    chain_mid=chain_mid)
                Qk = matmul(P, X, precision=gram_prec)
                worst = torch.maximum(worst, resid * resid)
            R[..., lam:lam + r, lam:lam + r] = t
            if lam + r < g_end:
                C = Pbuf[..., c0 + r:]
                G1 = mm_e(Qk.mT, C)
                Pbuf[..., c0 + r:] = (C - mm_e(Qk, G1)).to(Pbuf.dtype)
                R[..., lam:lam + r, lam + r:g_end] = G1
            if cast_early:
                Qk = Qk.to(q_dtype)
            if B is not None:
                qtb.append(mm_t(Qk.mT, B))
            if Qacc is not None:
                Qacc[..., lam:lam + r] = Qk.to(q_dtype)
            qcols.append(Qk)
        if g_end < n:
            Qg = torch.cat(qcols[q_start:], dim=-1)
            G1 = mm_t(Qg.mT, T)
            T = (T - mm_t(Qg, G1)).to(T.dtype)
            R[..., lam_g:g_end, g_end:] = G1
        i = js[-1] + 1

    R_full = (torch.cat([R, R.new_zeros((*batch, m - n, n))], dim=-2)
              if m > n else R).to(policy.accum)
    if Qacc is not None:
        Q = Qacc if want_q else None
    else:
        Q = torch.cat(qcols, dim=-1).to(q_dtype) if want_q else None
    QtB = torch.cat(qtb, dim=-2) if B is not None else None
    return _poison_if_unconverged(worst, R_full, Q, QtB)


#: The scan tier's panel gate of the JAX package: five m x r fp32 residents
#: within 14 MiB choose the fused panel kernel (K3), anything taller the
#: three-chain composition over K1.  Sized for the TPU's VMEM; kept so that
#: dispatch stays in step with the reference.
SCAN_FUSED_PANEL_MAX_BYTES = 14 * 2**20


def _bgs_scan_machinery(
    A: torch.Tensor,
    B: Optional[torch.Tensor],
    block_size: int,
    policy: DTypePolicy,
    reorth: bool,
    group_panels: int,
    chain_mid: bool,
    reorth_grouped: bool = False,
):
    """The scan-BGS step, shared by the one-shot driver
    (``_block_qr_bgs_scan``) and the checkpointed one
    (``models/resumable.py``): the same step sequence on the same carry,
    so a resumed run is bit-identical to an uninterrupted one.  Returns
    ``(step, carry0, nsteps)``; ``step(k, carry)`` factors the k-th group
    of ``g`` panels and returns the carry ``(Qbuf, R, QtB, worst_resid)``,
    whose buffers it updates in place.

    Each step projects its group's columns against the written prefix of
    ``Qbuf`` (classical GS; twice with ``reorth``), then factors each panel
    with the shifted three-pass chain (K3 while the panel passes
    ``SCAN_FUSED_PANEL_MAX_BYTES``, else the K1 composition), its residual
    scaled by 0.01 as for every robust panel, and projects the group's
    later columns eagerly.  ``g`` is ``group_panels`` when that divides
    the panel count and the tier is single-pass or ``reorth_grouped``
    ('bgs2'), else 1.  The reorth tiers run fp32 projections on an fp32
    ``Qbuf``, and rescrub each panel of the last
    ``ceil(max(2, nb // 8) / g)`` steps against everything written before
    it, in-group panels included.
    """
    m, n = A.shape
    r = block_size
    if n % r != 0 or m < n:
        raise ValueError(f"scan BGS needs r | n and m >= n; got "
                         f"{tuple(A.shape)}, r={r}")
    nb = n // r
    dev = A.device
    A = A.to(policy.panel)
    mm_t = trailing_matmul(policy)
    mm_p = mm_f32 if reorth else mm_t
    qbuf_dtype = (torch.float32 if reorth
                  else (policy.q_store or policy.accum))
    fused_panel = m * r * 4 * 5 <= SCAN_FUSED_PANEL_MAX_BYTES

    def panel(P):
        if fused_panel:
            return panel_qr_fused(P.float().contiguous(), robust=True,
                                  chain_mid=chain_mid)
        Qk, t, _, resid = tri_cholqr_robust_fused(P, chain_mid=chain_mid)
        return Qk, t, resid

    g = (group_panels
         if group_panels > 1 and nb % group_panels == 0
         and (not reorth or reorth_grouped) else 1)
    gw = g * r
    nsteps = nb // g
    rescrub_from = nsteps - min(nsteps, -(-max(2, nb // 8) // g))

    def step(k, carry):
        Qbuf, R, QtB, wr = carry
        lam_g = k * gw
        # A copy where the eager in-group projection writes into it.
        Cg = A[:, lam_g:lam_g + gw].to(policy.accum, copy=g > 1)
        if lam_g > 0:
            Qpre = Qbuf[:, :lam_g]
            C = mm_p(Qpre.T, Cg)
            Cg = Cg - mm_p(Qpre, C)
            if reorth:
                C2 = mm_p(Qpre.T, Cg)
                Cg = Cg - mm_p(Qpre, C2)
                C = C + C2
            R[:lam_g, lam_g:lam_g + gw] = C
        for j in range(g):
            lam = lam_g + j * r
            Qk, t, resid = panel(Cg[:, j * r:(j + 1) * r])
            wr = torch.maximum(wr, 0.01 * resid)
            if reorth and k >= rescrub_from:
                Qk, t, dW, rs = _rescrub_panel(Qbuf[:, :lam], Qk, t)
                wr = torch.maximum(wr, rs * rs)
                R[:lam, lam:lam + r] += dW
            Qbuf[:, lam:lam + r] = Qk.to(qbuf_dtype)
            R[lam:lam + r, lam:lam + r] = t
            if j + 1 < g:
                Ct = Cg[:, (j + 1) * r:]
                G1 = mm_p(Qk.T, Ct)
                Cg[:, (j + 1) * r:] = Ct - mm_p(Qk, G1)
                R[lam:lam + r, lam + r:lam_g + gw] = G1
            if B is not None:
                QtB[lam:lam + r] = mm_t(Qk.T, B)
        return Qbuf, R, QtB, wr

    carry0 = (
        torch.zeros((m, n), dtype=qbuf_dtype, device=dev),
        torch.zeros((n, n), dtype=torch.float32, device=dev),
        torch.zeros((n, B.shape[1] if B is not None else 1),
                    dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.float32, device=dev),
    )
    return step, carry0, nsteps


def _bgs_scan_finalize(m, n, policy, want_q, with_b, Qbuf, R, QtB,
                       worst_resid, reorth=True):
    """Close a scan-BGS carry into ``(R_full, Q, QtB)``: R zero-padded to
    m rows and cut to its upper triangle, Q in fp32 on the reorth tiers
    (a bf16 Q would undo their scrub) and in the policy's storage dtype on
    bgs1, and the NaN canary."""
    R_full = (torch.cat([R, R.new_zeros((m - n, n))], dim=0)
              if m > n else R)
    R_full = torch.triu(R_full.to(policy.accum))
    q_dtype = policy.accum if reorth else (policy.q_store or policy.accum)
    Q = Qbuf.to(q_dtype) if want_q else None
    return _poison_if_unconverged(worst_resid, R_full, Q,
                                  QtB if with_b else None)


def _block_qr_bgs_scan(
    A: torch.Tensor,
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    B: Optional[torch.Tensor] = None,
    reorth: bool = True,
    group_panels: int = 1,
    chain_mid: bool = False,
    reorth_grouped: bool = False,
):
    """Scan-mode Block Gram-Schmidt (the JAX package's
    ``_block_qr_bgs_scan``): ``_bgs_scan_machinery``'s step over every
    group in turn, then ``_bgs_scan_finalize``.  Returns ``(R_full, Q,
    QtB)``.  The JAX tier compiles one full-width step and projects against
    the still-zero columns of its Q buffer too; here a Python loop projects
    against the written prefix only, the same values to summation order at
    half the projection work.  Requires r | n and m >= n."""
    step, carry, nsteps = _bgs_scan_machinery(
        A, B, block_size, policy, reorth=reorth, group_panels=group_panels,
        chain_mid=chain_mid, reorth_grouped=reorth_grouped)
    for k in range(nsteps):
        carry = step(k, carry)
    m, n = A.shape
    return _bgs_scan_finalize(m, n, policy, want_q, B is not None, *carry,
                              reorth=reorth)



def _householder_fused(device_type: str, dtype: torch.dtype) -> bool:
    """Whether a ``'householder'`` panel runs K6 (``panel_factor_fused``):
    on a CUDA device, for every fp32 panel, whatever its width (one launch
    up to 128 columns, K6's wide route beyond).  On the CPU, and for
    float64 panels, ``panel_factor``'s loop runs, as the reference's XLA
    loop does on the TPU; K6's results agree with that loop to fp32
    summation order."""
    return device_type == "cuda" and dtype == torch.float32


def _householder_panel(panel: torch.Tensor, policy: DTypePolicy,
                       fused: bool):
    """``(V, T, Rp)`` of one Householder panel of any width:
    ``panel_factor_fused`` (K6, fp32; its wide route above 128 columns)
    when ``fused``, else ``panel_factor``.  A float64 panel always takes
    ``panel_factor``: K6 is fp32, as the TPU kernel is, and a POLICY_FP64
    factorization must stay float64."""
    if fused and panel.dtype != torch.float64:
        V, T, Rp = panel_factor_fused(panel.float().contiguous())
        return (V.to(policy.panel), T.to(policy.panel), Rp.to(policy.panel))
    return panel_factor(panel)


def _householder_panels(blocks: torch.Tensor, policy: DTypePolicy,
                        fused: bool):
    """``(V, T, Rp)`` of each panel of a (B, m, w) stack, stacked (the
    JAX package's ``jax.vmap(panel_factor)``): ONE
    ``panel_factor_fused_batched`` call (K6 over the batch) when ``fused``
    and not float64, else ``panel_factor`` member by member, as
    :func:`_householder_panel` routes one panel."""
    if fused and blocks.dtype != torch.float64:
        V, T, Rp = panel_factor_fused_batched(blocks.float().contiguous())
        return (V.to(policy.panel), T.to(policy.panel), Rp.to(policy.panel))
    outs = [panel_factor(b) for b in blocks]
    return tuple(torch.stack(x) for x in zip(*outs))


def _block_qr_traced(
    A: torch.Tensor,
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    B: Optional[torch.Tensor] = None,
    panel_method: str = "householder",
):
    """The reflector tiers (the JAX package's ``_block_qr_traced``):
    returns ``(R_full (m x n), Q (m x m) or None, QtB or None)``.

    * ``'householder'``: each r-wide panel (the last may be narrower) by
      ``panel_factor``'s column loop, or by K6 where ``_householder_fused``
      says (every fp32 panel on CUDA; above 128 columns K6's wide route);
      ``'householder_pallas'``: by K6.
      Trailing columns, ``B`` and Q take its compact-WY block reflector.
    * ``'cholqr1'``/``'cholqr2'``/``'cholqr2s'``: a (1-pass / 2-pass /
      shifted) CholeskyQR panel applied through the Yamamoto reflector
      ``H = I - Y Sinv Y^T`` with a Newton-Schulz S-inverse (residual-
      checked LU fallback on panels of aspect < 4).  Hybrid rule: a panel
      of aspect < 2 (the square final panel) takes the Householder panel
      instead, K6 on the GPU.
    * ``'cholqr1x2'``: two adjacent cholqr1 panels merged into one 2r-wide
      reflector while the second stays tall (aspect >= 2).
    Non-finite panel output is funneled into the NaN canary as
    ``sum(X * 0)`` (0 for finite X, NaN otherwise), so a mid-matrix
    breakdown still reaches R[0, 0].  ``A`` and ``B`` are not modified.

    ``A`` may also be a stack (B, m, n), with ``B`` (B, m, k): the JAX
    package's ``vmap`` of this driver.  Every member takes the same steps;
    a step's Householder panels of all members are ONE
    ``_householder_panels`` call (one K6 launch over the batch on the
    card), the CholeskyQR helpers and the products run on the stacks
    (batched products), and each member keeps its own canary.  A stack of
    one runs as one matrix, with the same kernel calls and results.
    """
    if A.dim() == 3 and A.shape[0] == 1:
        outs = _block_qr_traced(A[0], block_size, policy, want_q,
                                None if B is None else B[0], panel_method)
        return tuple(None if x is None else x[None] for x in outs)
    *batch, m, n = A.shape
    r = min(block_size, n)
    dev = A.device
    on_gpu = A.is_cuda
    A = A.to(policy.panel, copy=True)
    q_dtype = policy.q_store or policy.accum
    Q = None
    if want_q:
        Q = torch.eye(m, dtype=q_dtype, device=dev)
        if batch:
            Q = Q.repeat(*batch, 1, 1)
    if B is not None:
        B = B.clone()
    mm_t, mm_q, hi = (trailing_matmul(policy), q_matmul(policy),
                      accum_matmul(policy))
    factor = _householder_panels if batch else _householder_panel

    def sub_reflector(cols):
        Q_red, Rp = cholesky_qr2(cols, passes=1)
        return yamamoto_reflector(Q_red, Rp, inv_method="newton")

    def nan_sum(*Xs):  # each member's 0, or NaN where one X is not finite
        return sum((X * 0).sum(dim=(-2, -1)) for X in Xs)

    worst = torch.zeros(batch, dtype=torch.float32, device=dev)
    pair_mode = panel_method == "cholqr1x2"
    base_method = "cholqr1" if pair_mode else panel_method
    lam = 0
    while lam < n:
        w = min(r, n - lam)
        if (pair_mode and w == r and lam + 2 * r <= n
                and (m - lam - r) >= 2 * r):
            # H1 H2 = I - Yc Sc Yc^T, Sc = [[S1, -S1 (Y1^T Y2) S2], [0, S2]]
            Y1, S1, R1 = sub_reflector(A[..., lam:, lam:lam + r])
            A[..., lam:, lam:lam + r] = 0
            A[..., lam:lam + r, lam:lam + r] = R1.to(A.dtype)
            C = A[..., lam:, lam + r:lam + 2 * r]
            C = C - mm_t(Y1, hi(S1.mT, mm_t(Y1.mT, C)))
            Y2b, S2, R2 = sub_reflector(C[..., r:, :])
            A[..., lam:, lam + r:lam + 2 * r] = 0
            A[..., lam:lam + r, lam + r:lam + 2 * r] = C[..., :r, :].to(
                A.dtype)
            A[..., lam + r:lam + 2 * r, lam + r:lam + 2 * r] = R2.to(A.dtype)
            zeros = Y2b.new_zeros((*batch, r, r))
            Y2 = torch.cat([zeros, Y2b], dim=-2)
            cross = hi(hi(S1, mm_t(Y1.mT, Y2)), S2)
            Yc = torch.cat([Y1, Y2], dim=-1)
            Sc = torch.cat([torch.cat([S1, -cross.to(S1.dtype)], dim=-1),
                            torch.cat([zeros.to(S2.dtype), S2], dim=-1)],
                           dim=-2)
            worst = torch.maximum(worst, nan_sum(Sc, R1, R2))
            if lam + 2 * r < n:
                C2 = A[..., lam:, lam + 2 * r:]
                A[..., lam:, lam + 2 * r:] = (
                    C2 - mm_t(Yc, hi(Sc.mT, mm_t(Yc.mT, C2)))).to(A.dtype)
            if B is not None:
                Bl = B[..., lam:, :]
                B[..., lam:, :] = (
                    Bl - mm_t(Yc, hi(Sc.mT, mm_t(Yc.mT, Bl)))).to(B.dtype)
            if want_q:
                Qc = Q[..., lam:]
                Q[..., lam:] = (Qc - mm_q(hi(mm_q(Qc, Yc), Sc), Yc.mT)).to(
                    q_dtype)
            lam += 2 * r
            continue

        panel = A[..., lam:, lam:lam + w]
        pm = base_method
        if pm in _CHOLQR_TIERS and (m - lam) < 2 * w:
            pm = "householder_pallas" if on_gpu else "householder"
        if pm in ("householder", "householder_pallas"):
            fused = pm == "householder_pallas" or _householder_fused(
                panel.device.type, panel.dtype)
            V, T, Rp = factor(panel, policy, fused)
            A[..., lam:, lam:lam + w] = Rp
            # Rp, not only T: an input NaN may leave V and T finite.
            worst = torch.maximum(worst, nan_sum(Rp, T))

            def left(X, V=V, T=T):
                return apply_block_reflector_left_t(X, V, T, policy)

            def right(X, V=V, T=T):
                return apply_block_reflector_right(X, V, T, policy)
        elif pm in _CHOLQR_TIERS:
            Q_red, Rp = cholesky_qr2(panel, shifted=pm == "cholqr2s",
                                     passes=1 if pm == "cholqr1" else 2)
            Y, Sinv, Rp = yamamoto_reflector(Q_red, Rp, inv_method="newton",
                                             check=(m - lam) < 4 * w)
            A[..., lam:, lam:lam + w] = 0
            A[..., lam:lam + w, lam:lam + w] = Rp.to(A.dtype)
            worst = torch.maximum(worst, nan_sum(Sinv, Rp))

            def left(X, Y=Y, Sinv=Sinv):  # H^T X = X - Y Sinv^T (Y^T X)
                return X - mm_t(Y, hi(Sinv.mT, mm_t(Y.mT, X)))

            def right(X, Y=Y, Sinv=Sinv):  # X H = X - ((X Y) Sinv) Y^T
                return X - mm_q(hi(mm_q(X, Y), Sinv), Y.mT)
        else:
            raise ValueError(f"unknown panel_method {pm!r}")
        if lam + w < n:
            A[..., lam:, lam + w:] = left(A[..., lam:, lam + w:]).to(A.dtype)
        if B is not None:
            B[..., lam:, :] = left(B[..., lam:, :]).to(B.dtype)
        if want_q:
            Q[..., lam:] = right(Q[..., lam:]).to(q_dtype)
        lam += w
    R_full = torch.triu(A.to(policy.accum))
    return _poison_if_unconverged(worst, R_full, Q, B)


def _block_qr_scan(
    A: torch.Tensor,
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    B: Optional[torch.Tensor] = None,
    panel_method: str = "cholqr1",
):
    """The cholqr scan tier (the JAX package's ``_block_qr_scan``): every
    panel but the last runs the same full-width step -- a CholeskyQR panel
    masked to rows >= lam and its Yamamoto reflector applied to all of A,
    B and Q (finished columns are invariant under it).  The S-inverse is
    sized for the squarest in-loop panel: 12 Newton iterations (K4, or
    ``newton_inv`` for a float64 S) with the residual-checked LU fallback
    on the device.
    The square final panel runs ``panel_factor``.  Requires r | n; like
    the JAX tier it writes no canary (a NaN spreads through the full-width
    updates)."""
    m, n = A.shape
    r = block_size
    if n % r != 0:
        raise ValueError(f"scan mode needs r | n; got n={n}, r={r}")
    dev = A.device
    A = A.to(policy.panel, copy=True)
    q_dtype = policy.q_store or policy.accum
    Q = torch.eye(m, dtype=q_dtype, device=dev) if want_q else None
    if B is not None:
        B = B.clone()
    mm_t, mm_q, hi = (trailing_matmul(policy), q_matmul(policy),
                      accum_matmul(policy))

    rows = torch.arange(m, device=dev)[:, None]
    cols = torch.arange(r, device=dev)[None, :]
    for k in range(n // r - 1):
        lam = k * r
        P = torch.where(rows >= lam, A[:, lam:lam + r], 0.0)
        Q_red, _ = cholesky_qr2(P, shifted=panel_method == "cholqr2s",
                                passes=1 if panel_method == "cholqr1" else 2)
        Q1 = Q_red[lam:lam + r, :]
        D = _sign_fix(Q1)
        Y = Q_red * D[None, :] - (rows - lam == cols).to(Q_red.dtype)
        S = torch.eye(r, dtype=Q_red.dtype, device=dev) - (Q1 * D).T
        if S.dtype == torch.float64:
            Sinv = newton_inv(S, iters=12, check=True)
        else:
            Xn, resid = ninv_chain(S.float().contiguous(), iters=12)
            Sinv = torch.where(resid < 1e-3, Xn, lu_inv(S.float()))
        A = (A - mm_t(Y, hi(Sinv.T, mm_t(Y.T, A)))).to(A.dtype)
        if B is not None:
            B = (B - mm_t(Y, hi(Sinv.T, mm_t(Y.T, B)))).to(B.dtype)
        if want_q:
            Q = (Q - mm_q(hi(mm_q(Q, Y), Sinv), Y.T)).to(q_dtype)
    lam = n - r
    V, T, Rp = panel_factor(A[lam:, lam:])
    A[lam:, lam:] = Rp
    if B is not None:
        B[lam:] = apply_block_reflector_left_t(B[lam:], V, T, policy).to(
            B.dtype)
    if want_q:
        Q[:, lam:] = apply_block_reflector_right(
            Q[:, lam:].to(policy.accum), V, T, policy).to(q_dtype)
    return torch.triu(A.to(policy.accum)), Q, B


def _block_qr_grouped(
    A: torch.Tensor,
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    B: Optional[torch.Tensor] = None,
    group_panels: int = 4,
):
    """The ``polar`` tier (the JAX package's ``_block_qr_grouped``):
    triangular-NS panels and group-merged W-form reflectors.

    Each panel is factored with no triangular library call: tall panels by
    ``tri_cholqr_fused`` (one K1 chain, aspect budget, +6 on the head
    panel), tail panels (aspect < 2) by the shifted three-pass
    ``tri_cholqr_robust_fused``, both sign-fixed.  Each reflector is folded
    to ``H = I - W Y^T`` with ``W = Y S^-1`` (S-inverse by K4 with
    ``newton_iters_for_aspect`` iterations; the LU fallback armed only at
    aspect < 4); the square final panel uses ``Y = I``, ``W = I - Qs``.
    Panels update their own group's columns eagerly; the trailing matrix,
    B and Q are each updated once per group by the merged
    ``H_g H_j = I - [Wg, Wj - Wg (Yg^T Wj)] [Yg, Yj]^T``.  Residuals enter
    the canary as the robust residual x 0.01 and the plain one squared.
    Requires r | n and m >= n.

    ``A`` may also be a stack (B, m, n), with ``B`` (B, m, k): the JAX
    package's ``vmap`` of this driver.  Every member takes the same steps:
    a panel of all members is one ``tri_cholqr_fused`` call (one batched K1
    launch; three on a robust tail panel) and one ``ninv_chain_batched``
    launch, the LU fallback is each member's own select, the products run
    on the stacks, and each member keeps its own canary.  A stack of one
    runs as one matrix, with the same kernel calls and results."""
    if A.dim() == 3 and A.shape[0] == 1:
        outs = _block_qr_grouped(A[0], block_size, policy, want_q,
                                 None if B is None else B[0], group_panels)
        return tuple(None if x is None else x[None] for x in outs)
    *batch, m, n = A.shape
    r = block_size
    if n % r != 0 or m < n:
        raise ValueError(f"polar needs r | n and m >= n; got "
                         f"{tuple(A.shape)}, r={r}")
    nb = n // r
    dev = A.device
    A = A.to(policy.panel, copy=True)
    q_dtype = policy.q_store or policy.accum
    Q = (torch.eye(m, dtype=q_dtype, device=dev).repeat(*batch, 1, 1)
         if want_q else None)
    if B is not None:
        B = B.clone()
    mm_t, mm_q = trailing_matmul(policy), q_matmul(policy)
    worst = torch.zeros(batch, dtype=torch.float32, device=dev)
    eye_r = torch.eye(r, dtype=torch.float32, device=dev)
    ninv = ninv_chain_batched if batch else ninv_chain
    i = 0
    while i < nb:
        lam_g = i * r
        js = list(range(i, min(i + group_panels, nb)))
        g_end = (js[-1] + 1) * r
        Yg = Wg = None
        for j in js:
            lam = j * r
            P = A[..., lam:, lam:lam + r]
            if (m - lam) < 2 * r:
                Qs, t, _, rresid = tri_cholqr_robust_fused(P, sign_fix=True)
                worst = torch.maximum(worst, 0.01 * rresid)
            else:
                iters = tri_iters_for_aspect((m - lam) / r)
                if lam == 0:
                    iters = tri_head_iters(iters)
                Qs, t, _, resid = tri_cholqr_fused(P, iters=iters)
                worst = torch.maximum(worst, resid * resid)
            if m - lam == r:  # square final panel: H = Qs, no inversion
                Y = eye_r.expand_as(Qs)
                W = eye_r - Qs
            else:
                Y = Qs - torch.eye(m - lam, r, dtype=Qs.dtype, device=dev)
                S = eye_r - Qs[..., :r, :].mT
                aspect = (m - lam) / r
                Xn, nresid = ninv(S.contiguous(),
                                  iters=newton_iters_for_aspect(aspect))
                Sinv = (torch.where((nresid < 1e-3)[..., None, None], Xn,
                                    lu_inv(S))
                        if aspect < 4 else Xn)
                W = mm_f32(Y, Sinv)
            A[..., lam:, lam:lam + r] = 0
            A[..., lam:lam + r, lam:lam + r] = t.to(A.dtype)
            if lam + r < g_end:  # eager update of the group's own columns
                C = A[..., lam:, lam + r:g_end]
                A[..., lam:, lam + r:g_end] = (
                    C - mm_t(Y, mm_t(W.mT, C))).to(A.dtype)
            pad = lam - lam_g
            if pad:
                z = W.new_zeros((*batch, pad, r))
                Yj = torch.cat([z, Y], dim=-2)
                Wj = torch.cat([z, W], dim=-2)
            else:
                Yj, Wj = Y, W
            if Yg is None:
                Yg, Wg = Yj, Wj
            else:
                Wj = Wj - mm_t(Wg, mm_t(Yg.mT, Wj))
                Yg = torch.cat([Yg, Yj], dim=-1)
                Wg = torch.cat([Wg, Wj], dim=-1)
        if g_end < n:
            C = A[..., lam_g:, g_end:]
            A[..., lam_g:, g_end:] = (
                C - mm_t(Yg, mm_t(Wg.mT, C))).to(A.dtype)
        if B is not None:
            Bl = B[..., lam_g:, :]
            B[..., lam_g:, :] = (Bl - mm_t(Yg, mm_t(Wg.mT, Bl))).to(B.dtype)
        if want_q:
            Qc = Q[..., lam_g:]
            Q[..., lam_g:] = (Qc - mm_q(mm_q(Qc, Wg), Yg.mT)).to(q_dtype)
        i = js[-1] + 1
    R_full = torch.triu(A.to(policy.accum))
    return _poison_if_unconverged(worst, R_full, Q, B)


def _driver(A, block_size, policy, want_q, B, panel_method, loop_mode,
            group_panels=DEFAULT_GROUP_PANELS):
    """Run one resolved tier: ``(R_full, Q, QtB)`` (the JAX package's
    ``_jitted_driver``)."""
    if panel_method in _BGS_TIERS:
        if loop_mode == "scan":
            # chain_mid stays off here, as in the JAX package.
            return _block_qr_bgs_scan(
                A, block_size, policy, want_q, B,
                reorth=panel_method in ("bgs", "bgs2"),
                group_panels=group_panels,
                reorth_grouped=panel_method == "bgs2",
            )
        return _block_qr_bgs(
            A, block_size, policy, want_q, B, group_panels=group_panels,
            reorth=panel_method in ("bgs", "bgs2"),
            mid_tier=panel_method == "bgs2",
            chain_mid=panel_method == "bgs1",
        )
    if panel_method == "polar":
        return _block_qr_grouped(A, block_size, policy, want_q, B,
                                 group_panels=group_panels)
    if loop_mode == "scan":
        return _block_qr_scan(A, block_size, policy, want_q, B, panel_method)
    return _block_qr_traced(A, block_size, policy, want_q, B, panel_method)


def block_qr(
    A,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    mode: str = "reduced",
    panel_method: str = "householder",
    loop_mode: str = "unroll",
    group_panels: int = DEFAULT_GROUP_PANELS,
    quality: Optional[str] = None,
    check: str = "defer",
    device=None,
):
    """Blocked QR: A = QR.

    Arguments as in the JAX package's ``block_qr``; ``device`` as in
    ``utils/device.py`` (a non-tensor input runs on CUDA unless
    ``device='cpu'``).  ``panel_method='auto'`` with ``quality='fast'``
    (the default rung under mixed policies) is the main path: ``bgs1``
    with groups of 8 panels; a complete Q of a tall matrix resolves to
    ``polar``.  ``check='defer'`` leaves a breakdown as a NaN canary in
    R[0, 0] / Q[0, 0]; ``check='sync'`` fetches the canary and reruns the
    factorization through ``_sync_retry_method``'s tier ('householder'
    when unrolled: exact for any input, rank-deficient ones included),
    raising ``NonFiniteError`` if that fails too.  Returns ``(Q, R)`` for
    'reduced'/'complete' and R for 'r'.
    """
    A = as_device_tensor(A, device)
    if A.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        A = A.to(policy.panel)
    if check not in ("defer", "sync", "off"):
        raise ValueError(f"check must be 'defer'|'sync'|'off', got {check!r}")
    if mode not in ("reduced", "complete", "r"):
        raise ValueError(f"unknown mode {mode!r}")
    m, n = A.shape
    if m < n:
        raise ValueError(f"block_qr requires m >= n, got {tuple(A.shape)}")
    want_q = mode in ("reduced", "complete")
    panel_method, loop_mode, group_panels = resolve_panel_config(
        m, n, block_size, policy, panel_method, loop_mode, group_panels,
        mode=mode, on_gpu=A.is_cuda, quality=quality,
    )
    R_full, Q, _ = _driver(A, block_size, policy, want_q, None,
                           panel_method, loop_mode, group_panels)
    if check == "sync" and not bool(torch.isfinite(R_full[0, 0])):
        retry_pm = _sync_retry_method(panel_method, loop_mode, policy, mode,
                                      m, n)
        if retry_pm is None:
            raise NonFiniteError(
                f"block_qr: non-finite factorization via {panel_method!r} "
                "- the input likely contains NaN/Inf"
            )
        R_full, Q, _ = _driver(A, block_size, policy, want_q, None,
                               retry_pm, loop_mode)
        if not bool(torch.isfinite(R_full[0, 0])):
            raise NonFiniteError(
                f"block_qr: non-finite factorization even via {retry_pm!r} "
                "- the input contains NaN/Inf, or is numerically "
                "rank-deficient (use panel_method='householder' with "
                "loop_mode='unroll', or pivoted_qr/lstsq for rank-revealing "
                "handling)"
            )
        if Q is not None and panel_method in ("bgs", "bgs2"):
            # The reorth tiers return an fp32 Q: the retry keeps that dtype.
            Q = Q.to(policy.accum)
    if mode == "r":
        return R_full[:n, :]
    if mode == "reduced":
        return Q[:, :n], R_full[:n, :]
    return Q, R_full


def block_qr_qtb(
    A,
    B,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    panel_method: str = "householder",
    quality: Optional[str] = None,
    check: str = "defer",
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor A and return ``(R (n x n), Q^T B)`` without materializing Q:
    the least-squares path.  ``B`` (m,) or (m, k) rides through the same
    panel updates.  ``check`` as in ``block_qr`` ('sync' retries a
    poisoned factorization through 'householder'); ``device`` as there."""
    A = as_device_tensor(A, device)
    B = torch.as_tensor(B, device=A.device)
    squeeze = B.dim() == 1
    if squeeze:
        B = B[:, None]
    if check not in ("defer", "sync", "off"):
        raise ValueError(f"check must be 'defer'|'sync'|'off', got {check!r}")
    m, n = A.shape
    panel_method, _, group_panels = resolve_panel_config(
        m, n, block_size, policy, panel_method, "unroll",
        DEFAULT_GROUP_PANELS, mode="qtb", on_gpu=A.is_cuda, quality=quality,
    )
    Bp = B.to(policy.panel)
    R_full, _, QtB = _driver(A, block_size, policy, False, Bp, panel_method,
                             "unroll", group_panels)
    if check == "sync" and not bool(torch.isfinite(R_full[0, 0])):
        if panel_method == "householder":
            raise NonFiniteError(
                "block_qr_qtb: non-finite factorization via 'householder' "
                "- the input likely contains NaN/Inf"
            )
        R_full, _, QtB = _driver(A, block_size, policy, False, Bp,
                                 "householder", "unroll")
        if not bool(torch.isfinite(R_full[0, 0])):
            raise NonFiniteError(
                "block_qr_qtb: non-finite factorization even via "
                "'householder' - the input likely contains NaN/Inf"
            )
    QtB = QtB.to(policy.accum)
    if squeeze:
        QtB = QtB[:, 0]
    return R_full[:n, :], QtB


def block_recursive_qr(A, mode: str = "reduced", min_block: int = 64,
                       device=None):
    """Recursive blocked QR on reduced factors (GVL Alg 5.2.4): the columns
    split in half recursively, leaves run the Householder tier at width
    ``min_block`` under POLICY_FP32, and each combine is two fp32 products.
    Only ``mode='reduced'``, as in the JAX package."""
    if mode != "reduced":
        raise ValueError("block_recursive_qr supports mode='reduced' only")
    A = as_device_tensor(A, device).float()

    def rec(A):
        m, n = A.shape
        if n <= min_block:
            R_full, Q, _ = _block_qr_traced(A, min_block, POLICY_FP32, True)
            return Q[:, :n], R_full[:n, :]
        n1 = n // 2
        Q1, R11 = rec(A[:, :n1])
        R12 = mm_f32(Q1.T, A[:, n1:])
        Q2, R22 = rec(A[:, n1:] - mm_f32(Q1, R12))
        top = torch.cat([R11, R12], dim=1)
        bot = torch.cat([R22.new_zeros((R22.shape[0], n1)), R22], dim=1)
        return torch.cat([Q1, Q2], dim=1), torch.cat([top, bot], dim=0)

    return rec(A)


def _driver_batched(A, block_size, policy, want_q, B, panel_method,
                    group_panels=DEFAULT_GROUP_PANELS):
    """The unrolled tier ``panel_method`` over a stack A (B, m, n), with
    ``B`` (B, m, k) or None: ``(R_full, Q, QtB)`` stacked (the JAX
    package's ``vmap`` of ``_jitted_driver``).  Every tier runs its driver
    once on the whole stack: the reflector tiers ``_block_qr_traced`` (one
    K6 launch over the batch a panel step on the card), the BGS tiers
    ``bgs`` / ``bgs1`` / ``bgs2`` ``_block_qr_bgs`` (one batched K2 entry a
    group, one batched K1 launch a chain of the per-panel route, the
    robust tail and the rescrub), ``polar`` ``_block_qr_grouped`` (one
    batched K1 launch a panel, three on a robust tail panel, and one
    batched K4 launch a panel)."""
    return _driver(A, block_size, policy, want_q, B, panel_method, "unroll",
                   group_panels)


def block_qr_batched(
    A_batch,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    mode: str = "reduced",
    panel_method: str = "householder",
    device=None,
):
    """Blocked QR over a leading batch axis: the unrolled driver of
    ``panel_method`` on the whole (batch, m, n) stack (the JAX package
    ``vmap``s it; ``_driver_batched``): every tier in one stacked call; on
    the card the reflector tiers launch K6 once over the batch a panel
    step, the BGS tiers one batched K2 entry a group (or one batched K1
    launch a chain), ``polar`` one batched K1 and one batched K4 launch a
    panel.
    ``panel_method`` is taken as given, as there; a NaN in one member
    poisons that member's canary only."""
    A_batch = as_device_tensor(A_batch, device)
    if A_batch.dim() != 3:
        raise ValueError(f"expected (batch, m, n), got {tuple(A_batch.shape)}")
    want_q = mode in ("reduced", "complete")
    R_full, Q, _ = _driver_batched(A_batch, block_size, policy, want_q, None,
                                   panel_method)
    n = A_batch.shape[2]
    if mode == "r":
        return R_full[:, :n, :]
    if mode == "reduced":
        return Q[:, :, :n], R_full[:, :n, :]
    return Q, R_full


def qr(
    A,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    mode: str = "reduced",
    panel_method: str = "auto",
    loop_mode: str = "unroll",
    group_panels: int = DEFAULT_GROUP_PANELS,
    quality: Optional[str] = None,
    check: str = "defer",
    device=None,
):
    """Main entry.  Narrow (n <= 8) and wide (m < n) problems take the
    unblocked Householder path (Q (m, k) / (m, m), R (k, n) / (m, n) with
    k = min(m, n)); the rest goes to ``block_qr``.  Under mixed/bf16
    policies ``quality=None`` means 'balanced' (``bgs2``), as in the JAX
    package; ``block_qr`` keeps 'fast'.  ``device`` as in ``block_qr``."""
    A = as_device_tensor(A, device)
    m, n = A.shape
    if n <= 8 or m < n:
        return householder_qr(A.to(policy.panel), mode=mode,
                              dtype=policy.panel)
    if (
        quality is None
        and panel_method == "auto"
        and policy.trailing == torch.bfloat16
    ):
        quality = "balanced"
    return block_qr(
        A, block_size=block_size, policy=policy, mode=mode,
        panel_method=panel_method, loop_mode=loop_mode,
        group_panels=group_panels, quality=quality, check=check,
    )
