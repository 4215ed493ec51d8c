"""Newton-Schulz chain kernels: ``ns_chain`` (K1), ``bgs_group_fused`` (K2),
``panel_qr_fused`` (K3), ``ninv_chain`` (K4) and ``bgs_group_fused_proj``
(K5), each beside its plain PyTorch version, the R-block combine
``tri_combine`` that closes K2's and K3's robust panels, on its own, and the
compositions ``tri_cholqr_fused`` and ``tri_cholqr_robust_fused`` over K1.
K1, K2 and K4 also take a stack of problems in one call
(``ns_chain_batched``, ``bgs_group_fused_batched``, ``ninv_chain_batched``:
the TPU kernels under ``jax.vmap``), and their plain versions and the two
compositions take the same stacks.

Port of ``mixedprecisionblockqr_tpu/ops/pallas/ns.py``.  The wrappers
launch the hand-written CUDA kernels of ``csrc/`` for CUDA tensors and
raise on anything those kernels do not take; they run the plain version
only for tensors on the CPU.  ``LAUNCHES`` counts kernel launches (never
plain-version calls), so a run can show which kernels it went through.

Chain semantics (``_tri_ns``): iterate an upper-triangular X toward
``X^T G X = I`` with ``E = I - X^T G X``, ``C = triu(E, 1) + diag(E)/2``,
``X <- X (I + om C)``, seeded by Jacobi scaling and a scale-safe
power-iteration norm guard.  ``t = triu(X^T G)`` is ``X^{-1}`` at
convergence, so the panel's R block needs no solve.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.cholqr import _sign_fix, newton_inv
from mixedprecisionblockqr_tpu_torch.ops.policy import mm_bf16, mm_f32, mm_high

#: Kernel launches per wrapper since the last ``reset_launches()`` (one
#: entry per kernel of the package, those of the other modules included).
LAUNCHES = {"ns_chain": 0, "bgs_group_fused": 0, "panel_qr_fused": 0,
            "ninv_chain": 0, "bgs_group_fused_proj": 0,
            "panel_factor_fused": 0, "sketch_qrcp_ranks": 0,
            "tiled_matmul": 0, "chol_rinv": 0, "givens_fold_rows": 0,
            "givens_chain": 0, "givens_hessenberg": 0}
#: ``tiled_matmul``'s launches by route (ops/kernels/gemm.py); both count
#: in ``LAUNCHES["tiled_matmul"]`` as well.
ROUTE_LAUNCHES = {"tma": 0, "predicated": 0}
#: Launches of a kernel piece through its own wrapper: the combine, which
#: otherwise runs inside K2's and K3's entries (counted there).
PIECE_LAUNCHES = {"tri_combine": 0}
#: The batched entries: K6's (ops/kernels/panel.py::
#: panel_factor_fused_batched: one launch a call, one a sub-panel above 128
#: columns), K1's (:func:`ns_chain_batched`, one launch a call), K2's
#: (:func:`bgs_group_fused_batched`, one C entry a call) and K4's
#: (:func:`ninv_chain_batched`, one launch a call).  Their launches count
#: in ``LAUNCHES`` under the same key as well; ``BATCH_MEMBERS`` counts the
#: panels, chains, groups or inverses they ran (B a call).
BATCH_LAUNCHES = {"panel_factor_fused": 0, "ns_chain": 0,
                  "bgs_group_fused": 0, "ninv_chain": 0}
BATCH_MEMBERS = {"panel_factor_fused": 0, "ns_chain": 0,
                 "bgs_group_fused": 0, "ninv_chain": 0}
#: K6's wide route (ops/kernels/panel.py, panels wider than 128): its calls
#: and the product launches between its sub-panels, whose K6 launches
#: count in ``LAUNCHES["panel_factor_fused"]``.
WIDE_LAUNCHES = {"calls": 0, "products": 0}
#: Panel widths the shared-memory route is instantiated for: a width r runs
#: on the smallest of them that holds it, with zeros beyond r.
KERNEL_WIDTHS = (32, 64, 128)
#: Widest r the kernels take (the L2 route's chain keeps three vectors of r
#: floats in shared memory; csrc/ns_chain.cuh::kMaxWidth).
MAX_WIDTH = 1024
#: Most CTAs of an L2-route cluster (a non-portable size, capped by the
#: card's largest cluster: ops/kernels/panel.py::max_cluster).
L2_MAX_CLUSTER = 16
#: The L2 route's products (csrc/ns_chain.cuh::l2_tprod), K1's and K4's:
#: a ring of L2_STAGES stages, each L2_DEPTH k-rows of A (256 rows, in
#: eight boxes of 32 rows) and of B (two tiles of 8 columns), after
#: L2_RING_SLACK_FLOATS (its mbarriers and the room to start it on 1024
#: bytes); the columns of a dealt tile.  The matrices of each kernel's
#: scratch: K1's G', G'^T, X, X^T, W, W^T (the last four twice) and C;
#: K4's S^T, X and X^T (twice each) and E; the combine's T1, T2, T3 (the
#: padded copies) and A = T2 T1.  K1's norm estimates' partial sums
#: (L2_NORM_SLOTS x L2_MAX_CLUSTER floats).
L2_STAGES = 3
L2_DEPTH = 64
L2_CHAIN_STAGE_FLOATS = L2_STAGES * L2_DEPTH * (256 + 2 * 8)
L2_RING_SLACK_FLOATS = 512
L2_CHAIN_MATRICES = 11
L2_NINV_MATRICES = 6
L2_COMBINE_MATRICES = 4
#: The L2 combine (csrc/panel.cuh::combine_l2_kernel): blocks of
#: COMBINE_ROWS rows x COMBINE_COLS columns, a CTA each; its ring of
#: L2_STAGES stages, each L2_DEPTH k of the first operand's rows and of
#: the second's two 8-column tiles.
COMBINE_ROWS = 32
COMBINE_COLS = 16
COMBINE_RING_FLOATS = L2_STAGES * L2_DEPTH * (COMBINE_ROWS + COMBINE_COLS)
L2_NORM_SLOTS = 3
L2_TILE = 8
#: Shared memory one CTA may use on an H100 (bytes).
SMEM_LIMIT = 232448
#: Columns of X (K4) and of the combine's T1 that one CTA owns.
STRIPE = 16
#: Chain schedule of a panel (the same constants as csrc/panel.cuh):
#: with ``chain_mid``, all but the final MID_FINAL iterations of a
#: non-refine chain run bf16-split products; robust panels run three passes
#: of ROBUST_ITERS iterations.
MID_FINAL = 2
ROBUST_ITERS = (14, 12, 4)
#: The panel products of K2, K3 and K5 (csrc/panel.cuh).  gemm_tn (the
#: Grams and G1 = Q^T C, K = m) computes TN_TILE x TN_TILE output tiles,
#: TN_STAGE rows of K at a time, its K split over the CTAs of one
#: thread-block cluster of at most TN_MAX_SPLIT.  gemm_nt (Q = P X and the
#: updates, K = r) takes column blocks of bn (the instantiation of r, 128
#: beyond) and NT_SMALL_BM[bn] rows per CTA (the r-wide products) or
#: NT_WIDE_BM (the wide ones).
TN_TILE = 32
TN_STAGE = 64
TN_MAX_SPLIT = 8
NT_SMALL_BM = {128: 16, 64: 16, 32: 32}
NT_WIDE_BM = 64
#: CTAs an r x r product aims at (the card has 132 SMs).
TARGET_CTAS = 128
#: The stack route of K2 over a batch (csrc/stack_gemm.cu): STACK_TILE x
#: STACK_TILE output tiles a CTA, one CTA an SM.  Its gemm_tn stops
#: splitting K before the members' tiles times the split pass STACK_CTAS,
#: the CTAs of the clusters of 8 that an H100 keeps resident at one CTA an
#: SM (15 x 8; utils/bounds.py::H100_RESIDENT), so that no launch takes two
#: waves; its gemm_nt gives a CTA whole STACK_TILE-row tiles, as many as
#: keep the members' tiles within SMS CTAs.  It takes the panel widths of
#: STACK_WIDTHS: whole tiles, so no product reads a neighbouring panel's
#: columns into a sum.
STACK_TILE = 128
STACK_CTAS = 120
STACK_SMS = 132
STACK_WIDTHS = (128, 256)
#: The product routes of a group layout, as the C entries number them.
PRODUCT_ROUTES = ("panel", "stack")
#: Most rows gemm_nt's grid covers (65,535 row blocks of NT_WIDE_BM).
MAX_ROWS = 65535 * NT_WIDE_BM
#: Most members of one batched launch (csrc/ns_chain.cuh::kMaxBatch: the
#: chain's grid y).
MAX_BATCH = 65535

_TINY = torch.finfo(torch.float32).tiny


class NsLayout(NamedTuple):
    """How a chain kernel (K1, K4, the combine) runs an r x r problem."""
    inst: int            # shared-memory route: R of the instantiation; 0
    route: str           # 'smem' (one CTA set, operands in shared memory)
    #                      or 'l2' (operands in an L2-resident scratch)
    ctas: int            # CTAs (one cluster for K1 and K4)
    scratch_floats: int  # floats of global scratch the wrapper allocates
    smem_bytes: int      # dynamic shared memory per CTA


class GroupLayout(NamedTuple):
    """How the panel products of K2, K3 and K5 run on an m x r panel, and
    the layout of the chain inside them."""
    split: int     # gemm_tn CTAs (one cluster) sharing a tile's K
    chunk: int     # rows of K each of them sums (whole TN_STAGEs)
    bm_panel: int  # gemm_nt rows per CTA: Q = P X, narrow projection
    bm_wide: int   # gemm_nt rows per CTA: wide projection, K5's scrub
    bn: int        # gemm_nt columns per CTA (the instantiation; 128 above)
    chain: NsLayout  # the chain's (ns_layout)
    #: 'panel': csrc/panel.cuh's gemm_tn / gemm_nt; 'stack' (a stack's
    #: layout only): csrc/stack_gemm.cu's, fed by TMA, bf16 on wgmma.
    product_route: str = "panel"

    def args(self) -> tuple:
        """The ten integers the group and panel entries take."""
        return (*self[:5], *_c_layout(self.chain))

    def batched_args(self) -> tuple:
        """The eleven integers the batched group entry takes: the
        products' five, the product route, the chain's five."""
        return (*self[:5], PRODUCT_ROUTES.index(self.product_route),
                *_c_layout(self.chain))


def tn_split(M: int, N: int, K: int, members: int = 1, tile: int = TN_TILE,
             most: int = 0) -> Tuple[int, int]:
    """``(split, chunk)`` of gemm_tn for an M x N output summed over K, in
    one launch for ``members`` such products: the split doubles, up to
    TN_MAX_SPLIT, while the members' output tiles (``tile`` x ``tile``)
    times the split fall short of TARGET_CTAS, each chunk keeps a whole
    TN_STAGE and, with ``most``, the doubled split's CTAs stay within
    ``most``; the chunk is ceil(K / split) rounded up to whole stages, and
    the split the number of chunks that cover K (none empty)."""
    if min(M, N, K, members) < 1:
        raise ValueError(f"tn_split takes a nonempty product; got "
                         f"{members} x {M} x {N} over {K}")
    tiles = members * -(-M // tile) * -(-N // tile)
    split = 1
    while (split < TN_MAX_SPLIT and tiles * split < TARGET_CTAS
           and K >= 2 * split * TN_STAGE
           and not (most and tiles * 2 * split > most)):
        split *= 2
    chunk = -(-(-(-K // split)) // TN_STAGE) * TN_STAGE
    return -(-K // chunk), chunk


def _inst(r: int) -> int:
    """The instantiation of the shared-memory route that holds width r
    (the smallest of ``KERNEL_WIDTHS``), or 0 beyond: the L2 route."""
    return next((R for R in KERNEL_WIDTHS if r <= R), 0)


def _check_width(r: int, what: str) -> None:
    if not 1 <= r <= MAX_WIDTH:
        raise ValueError(f"{what} takes 1 <= r <= MAX_WIDTH = {MAX_WIDTH}; "
                         f"got r={r}")


def _l2_ld(r: int) -> int:
    """Leading dimension of an r x r operand in the L2 scratch."""
    return -(-r // 4) * 4


def _l2_ctas(r: int, max_cluster: int) -> int:
    """CTAs of an L2-route cluster: one per STRIPE columns, at most
    ``L2_MAX_CLUSTER`` and the card's ``max_cluster``."""
    return max(1, min(L2_MAX_CLUSTER, max_cluster, -(-r // STRIPE)))


def _c_layout(lay: NsLayout) -> tuple:
    """The five integers a C entry takes for ``lay``."""
    return (lay.inst, int(lay.route == "l2"), lay.ctas, lay.scratch_floats,
            lay.smem_bytes)


@functools.lru_cache(maxsize=None)
def ns_layout(r: int, max_cluster: int = L2_MAX_CLUSTER) -> NsLayout:
    """K1's layout (csrc/ns_chain.cuh): up to 128 the cluster of R / STRIPE
    CTAs of the instantiation R = :func:`_inst` (r), each with ChainLayout<R>
    in shared memory (X^T and C^T replicated as fp32 or bf16 hi / lo with
    rows of R + 8, four 16-row stripes of R + 4 floats, 3 R + 64 floats of
    vectors) and no scratch; above, the L2 route: ``_l2_ctas`` CTAs, each
    with the products' ring of L2_CHAIN_STAGE_FLOATS, 3 r + 64 floats of
    vectors and the norm estimates' partial sums in shared memory, G',
    G'^T, X, X^T, W and W^T (the last four twice) and C (11 r x ceil(r /
    4) 4 floats) in global scratch.  A
    rule on shapes alone; ``max_cluster`` is the largest cluster the card
    places.  Raises ``ValueError`` for r outside [1, MAX_WIDTH]."""
    _check_width(r, "ns_chain")
    R = _inst(r)
    if R:
        smem = 2 * 4 * R * (R + 8) + 4 * STRIPE * (R + 4) * 4 + (3 * R + 64) * 4
        return NsLayout(R, "smem", R // STRIPE, 0, smem)
    return NsLayout(0, "l2", _l2_ctas(r, max_cluster),
                    L2_CHAIN_MATRICES * r * _l2_ld(r),
                    (L2_RING_SLACK_FLOATS + L2_CHAIN_STAGE_FLOATS + 3 * r
                     + 64 + L2_NORM_SLOTS * L2_MAX_CLUSTER) * 4)


@functools.lru_cache(maxsize=None)
def ninv_layout(r: int, max_cluster: int = L2_MAX_CLUSTER) -> NsLayout:
    """K4's layout (csrc/ninv_chain.cu): up to 128 one cluster of R /
    STRIPE CTAs (R = :func:`_inst` (r)), each holding S and two buffers of X
    whole, its own columns of X and E transposed (rows padded to R + 4
    floats), the product's 16 R partial sums and 64 floats of reductions;
    above, the L2 route: ``_l2_ctas`` CTAs, each with the products' ring
    (L2_RING_SLACK_FLOATS + L2_CHAIN_STAGE_FLOATS) and 64 floats of
    reductions in shared memory, S^T, X and X^T (twice each) and E in
    global scratch (L2_NINV_MATRICES r x ceil(r / 4) 4 floats).  Raises
    ``ValueError`` for r outside [1, MAX_WIDTH]."""
    _check_width(r, "ninv_chain")
    R = _inst(r)
    if R:
        floats = (3 * R + 2 * STRIPE) * (R + 4) + 16 * R + 64
        return NsLayout(R, "smem", R // STRIPE, 0, 4 * floats)
    return NsLayout(0, "l2", _l2_ctas(r, max_cluster),
                    L2_NINV_MATRICES * r * _l2_ld(r),
                    (L2_RING_SLACK_FLOATS + L2_CHAIN_STAGE_FLOATS + 64) * 4)


@functools.lru_cache(maxsize=None)
def combine_layout(r: int, max_cluster: int = L2_MAX_CLUSTER) -> NsLayout:
    """The R-block combine's layout (csrc/panel.cuh): up to 128 a plain
    grid (no exchange) of ceil(r / STRIPE) CTAs of STRIPE own columns, T2
    and T3 whole in shared memory on the instantiation R (rows of R + 4
    floats, the own columns of T1 and A, 16 R partial sums); above, the L2
    route: a CTA a block of COMBINE_ROWS x COMBINE_COLS, a cluster the row
    blocks of one column block, ``ctas`` = min(ceil(r / COMBINE_ROWS),
    ``max_cluster`` (the largest cluster the card places), L2_MAX_CLUSTER)
    CTAs a cluster and ceil(r / COMBINE_COLS) clusters; each CTA with its
    ring (L2_RING_SLACK_FLOATS + COMBINE_RING_FLOATS) in shared memory; T1,
    T2, T3 (copies with padded rows, when r is not a multiple of 4) and A
    = T2 T1 in global scratch (L2_COMBINE_MATRICES r x ceil(r / 4) 4
    floats).  Raises ``ValueError`` for r outside [1, MAX_WIDTH]."""
    _check_width(r, "tri_combine")
    R = _inst(r)
    if R:
        floats = 2 * R * (R + 4) + 2 * STRIPE * (R + 4) + 16 * R
        return NsLayout(R, "smem", -(-r // STRIPE), 0, 4 * floats)
    return NsLayout(0, "l2",
                    max(1, min(L2_MAX_CLUSTER, max_cluster,
                               -(-r // COMBINE_ROWS))),
                    L2_COMBINE_MATRICES * r * _l2_ld(r),
                    (L2_RING_SLACK_FLOATS + COMBINE_RING_FLOATS) * 4)


def _stack_rows(m: int, N: int, members: int) -> int:
    """Rows a CTA of the stack route's gemm_nt takes for an m x N output
    of ``members`` members: the members' column blocks of STACK_TILE
    share STACK_SMS CTAs, at least one a block, and each CTA of a block
    takes an equal run of whole STACK_TILE-row tiles."""
    blocks = members * -(-N // STACK_TILE)
    groups = max(1, STACK_SMS // blocks)
    return STACK_TILE * -(-(-(-m // STACK_TILE)) // groups)


def stack_route(m: int, r: int, members: int) -> bool:
    """Whether a stack of ``members`` groups of m x r panels takes the
    stack route: more than one member, a width of STACK_WIDTHS (whole
    output tiles; the TMA boxes start on 512-byte column offsets) and rows
    for one TN_STAGE at least.  A rule on shapes alone: widths such as 100
    or 125, whose panels start off 16 bytes, keep csrc/panel.cuh's
    products."""
    return members > 1 and r in STACK_WIDTHS and m >= TN_STAGE


def stack_fused_narrow(lay: GroupLayout, r: int) -> bool:
    """Whether the group entry runs each panel's narrow projection (G1 =
    P^T C, then C -= P G1 over the next panel's columns) as one launch,
    csrc/stack_gemm.cu::stack_proj: on the stack route at r = STACK_TILE,
    when the split's chunks are whole STACK_TILE-row tiles (a CTA updates
    the rows it summed)."""
    return (lay.product_route == "stack" and r == STACK_TILE
            and lay.chunk % STACK_TILE == 0)


@functools.lru_cache(maxsize=None)
def group_layout(m: int, r: int, max_cluster: int = L2_MAX_CLUSTER,
                 members: int = 1, g: int = 1) -> GroupLayout:
    """The layout of the panel products on an m x r panel, for one group or
    one launch over ``members`` groups of g panels: the r x r products'
    :func:`tn_split` of the members' tiles; gemm_nt's column tile bn, the
    instantiation of r (128 above, where an r-wide product spans several
    column blocks), and its small row tile unless even NT_WIDE_BM rows per
    CTA give the members TARGET_CTAS row blocks (``panel.py::_nt_tiles``);
    the chain's :func:`ns_layout`; and the product route.  At
    ``members=1`` (``g`` unused) it is the single group's layout, on
    csrc/panel.cuh's products.  A stack that :func:`stack_route` admits
    runs csrc/stack_gemm.cu's products instead: gemm_tn on STACK_TILE
    tiles split up to STACK_CTAS CTAs, gemm_nt rows per CTA from
    :func:`_stack_rows` (``bm_panel`` for the r-wide products, ``bm_wide``
    for the widest projection, g r - 2 r columns).  A rule on shapes alone:
    it needs no device.  Raises ``ValueError`` for r outside [1, MAX_WIDTH],
    m outside [1, MAX_ROWS] or members outside [1, MAX_BATCH]."""
    if not (1 <= r <= MAX_WIDTH and 1 <= m <= MAX_ROWS
            and 1 <= members <= MAX_BATCH and g >= 1):
        raise ValueError(f"the panel products take 1 <= r <= {MAX_WIDTH}, "
                         f"1 <= m <= {MAX_ROWS} and 1 <= members <= "
                         f"{MAX_BATCH}; got m={m}, r={r}, members={members}, "
                         f"g={g}")
    chain = ns_layout(r, max_cluster)
    wide = NT_WIDE_BM
    bn = _inst(r) or KERNEL_WIDTHS[-1]
    if stack_route(m, r, members):
        split, chunk = tn_split(r, r, m, members, STACK_TILE, STACK_CTAS)
        return GroupLayout(split, chunk, _stack_rows(m, r, members),
                           _stack_rows(m, max(r, (g - 2) * r), members), bn,
                           chain, "stack")
    split, chunk = tn_split(r, r, m, members)
    bm = (wide if members * -(-m // wide) >= TARGET_CTAS
          else NT_SMALL_BM[bn])
    return GroupLayout(split, chunk, bm, wide, bn, chain)


def layout_ok(m: int, r: int, lay: GroupLayout) -> bool:
    """Whether the group entries take ``lay`` for an m x r panel: the
    products' check of csrc/panel.cuh::product_layout_ok (the split's
    chunks cover m, none empty, a whole number of TN_STAGEs; bn the
    instantiation of r; on the 'panel' route row tiles gemm_nt is built
    for, on the 'stack' route r in STACK_WIDTHS, m >= TN_STAGE and whole
    STACK_TILE-row tiles a CTA; no other route)."""
    if not (1 <= r <= MAX_WIDTH and 1 <= lay.split <= TN_MAX_SPLIT
            and lay.chunk >= TN_STAGE and lay.chunk % TN_STAGE == 0
            and (lay.split - 1) * lay.chunk < m <= lay.split * lay.chunk
            and lay.bn == (_inst(r) or KERNEL_WIDTHS[-1])):
        return False
    if lay.product_route == "stack":
        return (r in STACK_WIDTHS and m >= TN_STAGE
                and all(bm >= STACK_TILE and bm % STACK_TILE == 0
                        for bm in (lay.bm_panel, lay.bm_wide)))
    tiles = {128: (16, 64), 64: (16, 64), 32: (32, 64)}[lay.bn]
    return (lay.product_route == "panel" and lay.bm_panel in tiles
            and lay.bm_wide in tiles)


def _card_cluster(t: torch.Tensor, r: int) -> int:
    """The largest cluster the card of ``t`` places, asked only for the
    L2 route (r > 128); the shared-memory route's layout does not use
    it."""
    if _inst(r):
        return L2_MAX_CLUSTER
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import max_cluster

    return max_cluster(t.device)


def _scratch(t: torch.Tensor, lay: NsLayout) -> torch.Tensor:
    """The global scratch of a launch with layout ``lay`` (empty on the
    shared-memory route)."""
    return torch.empty(lay.scratch_floats, dtype=torch.float32,
                       device=t.device)


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES, PIECE_LAUNCHES, WIDE_LAUNCHES,
                   BATCH_LAUNCHES, BATCH_MEMBERS):
        for k in counts:
            counts[k] = 0


# -- plain PyTorch versions ------------------------------------------------


def _norm2_est(M: torch.Tensor) -> torch.Tensor:
    """Upper estimate of ||M||_2: 1.05 x two power-iteration steps, computed
    scale-normalized so that ||M|| >~ 3e8 cannot overflow fp32.  For a
    stack (..., r, r), one estimate a member (shape (...))."""
    def total(x):
        return x.sum(dim=(-2, -1), keepdim=True)

    a = torch.maximum(M.abs().amax(dim=(-2, -1), keepdim=True),
                      M.new_tensor(_TINY))
    Ms = M * (1.0 / a)
    v0 = Ms.sum(dim=-1, keepdim=True)
    v1 = mm_f32(Ms, v0)
    n1 = torch.sqrt(total(v1 * v1))
    v2 = mm_f32(Ms, v1 * (1.0 / (n1 + 1e-30)))
    return ((1.05 * a) * torch.sqrt(total(v2 * v2)))[..., 0, 0]


def _correction(E: torch.Tensor) -> torch.Tensor:
    return torch.triu(E, 1) + torch.diag_embed(
        torch.diagonal(E, dim1=-2, dim2=-1)) * 0.5


def _max_abs(E: torch.Tensor) -> torch.Tensor:
    """max|E| of a matrix, or of each member of a stack."""
    return E.abs().amax(dim=(-2, -1))


def _tri_ns(G, iters, refine=False, mid_iters=0, omega=True, fuse_xw=True):
    """The chain on an SPD G; returns (X, E) with E the last correction
    (one step behind), or, for ``refine`` chains, the exact
    ``I - X^T G X``.
    The first ``mid_iters`` iterations use the bf16-split products; with
    ``fuse_xw`` all but the final two iterations carry W = G X by the
    stacked right-multiplication.  G may be a stack (..., r, r): every
    member runs its own chain."""
    r = G.shape[-1]
    eye = torch.eye(r, dtype=torch.float32, device=G.device)
    if refine:
        X, W = eye.expand_as(G), G
    else:
        d = torch.rsqrt(torch.maximum(torch.diagonal(G, dim1=-2, dim2=-1),
                                      G.new_tensor(_TINY)))
        M0 = G * d[..., :, None] * d[..., None, :]
        dr = d * torch.rsqrt(_norm2_est(M0))[..., None]
        X = torch.diag_embed(dr)
        W = G * dr[..., None, :]
    n_om = 0 if (refine or not omega) else min(4, max(0, iters - 4))
    n_fused = max(0, iters - 2) if fuse_xw else 0
    E = eye.expand_as(G)
    for it in range(iters):
        om = 1.5 if it < n_om else 1.0
        mm = mm_high if it < mid_iters else mm_f32
        if it < n_fused:
            E = eye - mm(X.mT, W)
            C = _correction(E)
            X, W = X + om * mm(X, C), W + om * mm(W, C)
        else:
            W = mm(G, X)
            E = eye - mm(X.mT, W)
            C = _correction(E)
            X = X + om * mm(X, C)
    if refine:
        E = eye - mm_f32(X.mT, mm_f32(G, X))
    return X, E


def ns_chain_plain(G, iters=10, shift=0.0, refine=False, chain_mid=False,
                   omega=True, fuse_xw=True):
    """Plain version of :func:`ns_chain` (``_ns_kernel`` transcription), and
    of :func:`ns_chain_batched` on a stack (..., r, r): one chain a member,
    one residual a member."""
    G = G.float()
    if shift:
        eye = torch.eye(G.shape[-1], dtype=torch.float32, device=G.device)
        G = G + (shift * _norm2_est(G))[..., None, None] * eye
    X, E = _tri_ns(G, iters, refine=refine,
                   mid_iters=max(0, iters - 2)
                   if chain_mid and not refine else 0,
                   omega=omega, fuse_xw=fuse_xw)
    t = torch.triu(mm_f32(X.mT, G))
    return X, t, _max_abs(E)


def _robust_passes(P, G, tall, mid):
    """The shifted three-pass chain of a robust panel with Gram ``G``:
    ``(Qk, (t1, t2, t3), E)``, the t's the full products X_k^T G_k."""
    i1, i2, i3 = ROBUST_ITERS
    eye = torch.eye(G.shape[-1], dtype=torch.float32, device=G.device)
    Gs = G + (1e-3 * _norm2_est(G))[..., None, None] * eye
    X1, _ = _tri_ns(Gs, i1, mid_iters=mid(i1), omega=False)
    t1 = mm_f32(X1.mT, Gs)
    Q1 = tall(P, X1)
    M1 = tall(Q1.mT, Q1)
    X2, _ = _tri_ns(M1, i2, mid_iters=mid(i2), omega=False)
    t2 = mm_f32(X2.mT, M1)
    Q2 = tall(Q1, X2)
    M2 = tall(Q2.mT, Q2)
    X3, E = _tri_ns(M2, i3, refine=True)
    t3 = mm_f32(X3.mT, M2)
    return tall(Q2, X3), (t1, t2, t3), E


def robust_products(P):
    """``(t1, t2, t3)`` of :func:`panel_qr_fused_plain`'s robust mode on
    ``P`` (fp32 throughout): the combine's inputs, for checking and timing
    :func:`tri_combine` at a robust panel's values."""
    P = P.float()
    return _robust_passes(P, mm_f32(P.mT, P), mm_f32, lambda it: 0)[1]


def _tri_ns_panel(P, iters, robust, bf16_gram, chain_mid):
    """One panel's factorization (``_tri_ns_panel``): (Qk, t, resid); on a
    stack (..., m, r) one of each a member."""
    tall = mm_bf16 if bf16_gram else mm_f32
    G = tall(P.mT, P)
    mid = (lambda it: max(0, it - MID_FINAL)) if chain_mid else (lambda it: 0)
    if robust:
        Qk, ts, E = _robust_passes(P, G, tall, mid)
        return Qk, tri_combine_plain(*ts), _max_abs(E)
    X, E = _tri_ns(G, iters, mid_iters=mid(iters))
    Qk = tall(P, X)
    t = torch.triu(mm_f32(X.mT, G))
    return Qk, t, _max_abs(E)


def tri_combine_plain(T1, T2, T3):
    """Plain version of :func:`tri_combine`: ``triu(T3 (T2 T1))`` in fp32,
    the robust R block of ``_tri_ns_panel`` (each member's, for stacks)."""
    return torch.triu(mm_f32(T3, mm_f32(T2, T1)))


def panel_qr_fused_plain(P, iters=10, robust=False, chain_mid=False):
    """Plain version of :func:`panel_qr_fused` (``_panel_qr_kernel``
    transcription: fp32 Gram and tall products, raw residual)."""
    return _tri_ns_panel(P.float(), iters, robust, False, chain_mid)


def bgs_group_fused_plain(Pg, r, iters, robust, bf16_dots=True,
                          bf16_gram=None, chain_mid=False):
    """Plain version of :func:`bgs_group_fused` (``_group_loop``
    transcription), and of :func:`bgs_group_fused_batched` on a stack
    (..., m, g*r): every member the same steps, one worst residual a
    member.  Works on a copy of ``Pg``."""
    if bf16_gram is None:
        bf16_gram = bf16_dots
    Q = Pg.float().clone()
    *batch, m, w = Q.shape
    g = w // r
    Rg = torch.zeros((*batch, w, w), dtype=torch.float32, device=Q.device)
    worst = torch.zeros(batch, dtype=torch.float32, device=Q.device)
    proj = mm_bf16 if bf16_dots else mm_f32
    for j in range(g):
        c0 = j * r
        Qk, t, resid = _tri_ns_panel(
            Q[..., c0:c0 + r], iters[j], robust[j], bf16_gram, chain_mid,
        )
        # Robust chains report the exact final residual (healthy up to
        # ~1e-2, so pre-scaled by 1e-2); plain chains the one-behind
        # correction, whose square estimates the true residual.
        worst = torch.maximum(worst,
                              resid * 0.01 if robust[j] else resid * resid)
        Q[..., c0:c0 + r] = Qk
        Rg[..., c0:c0 + r, c0:c0 + r] = t
        if j + 1 < g:
            C = Q[..., c0 + r:]
            G1 = proj(Qk.mT, C)
            Q[..., c0 + r:] = C - proj(Qk, G1)
            Rg[..., c0:c0 + r, c0 + r:] = G1
    return Q, Rg, worst


def bgs_group_fused_proj_plain(Pg, Qprev, r, iters, robust, bf16_dots=True,
                               bf16_gram=None, chain_mid=False):
    """Plain version of :func:`bgs_group_fused_proj`
    (``_bgs_group_proj_kernel`` transcription): the block-classical scrub
    of the raw columns against ``Qprev``, then the group body."""
    P = Pg.float()
    proj = mm_bf16 if bf16_dots else mm_f32
    C2 = proj(Qprev.T, P)
    Qg, Rg, worst = bgs_group_fused_plain(P - proj(Qprev, C2), r, iters,
                                          robust, bf16_dots, bf16_gram,
                                          chain_mid)
    return Qg, C2, Rg, worst


def ninv_chain_plain(S, iters=6):
    """Plain version of :func:`ninv_chain` (``_ninv_kernel`` transcription:
    ``newton_inv`` in fp32 and the final residual), and of
    :func:`ninv_chain_batched` on a stack (..., r, r): one inverse and one
    residual a member, so that one member's residual arms only its own
    fallback."""
    S = S.float()
    X = newton_inv(S, iters=iters)
    eye = torch.eye(S.shape[-1], dtype=torch.float32, device=S.device)
    return X, _max_abs(eye - mm_f32(S, X))


# -- kernel wrappers -------------------------------------------------------


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require_cuda_f32(x: torch.Tensor, name: str, dims: int = 2) -> None:
    """Refuse anything but a contiguous float32 CUDA tensor of ``dims``
    dimensions (3: a stack whose batch is 1 .. ``MAX_BATCH``)."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != dims or not x.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dims}-D float32 tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if dims == 3 and not 1 <= x.shape[0] <= MAX_BATCH:
        raise ValueError(f"{name} must hold 1 .. {MAX_BATCH} members, got "
                         f"{x.shape[0]}")


def ns_chain(
    G: torch.Tensor,
    iters: int = 10,
    shift: float = 0.0,
    refine: bool = False,
    chain_mid: bool = False,
    omega: bool = True,
    fuse_xw: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused triangular-NS inverse Cholesky of an SPD Gram ``G`` (r x r).

    Returns ``(X, t, resid)``: upper-triangular X with ``X^T G' X ~= I``
    (``G' = G + shift * ||G|| I`` when ``shift`` > 0), ``t = triu(X^T G')``
    and ``resid = max|I - X^T G' X|`` of the last iteration's correction.
    ``refine=True`` runs the identity-seeded variant for Grams near I and
    reports the exact final residual; ``chain_mid`` runs all but the final
    two iterations with bf16-split products; ``omega`` over-relaxes the
    early iterations; ``fuse_xw=False`` forces the classic 3-product
    iteration.  On CUDA, r may be any of 1 .. ``MAX_WIDTH``; the kernel runs
    as one thread-block cluster laid out by :func:`ns_layout`: up to 128
    with every operand in shared memory and no global scratch (its only
    allocations are the three outputs), above on the L2 route with its
    operands in a scratch of ``scratch_floats``.
    """
    if G.device.type == "cpu":
        return ns_chain_plain(G, iters, shift, refine, chain_mid, omega,
                              fuse_xw)
    _require_cuda_f32(G, "G")
    r = G.shape[0]
    if G.shape != (r, r):
        raise ValueError(f"ns_chain kernel takes r x r; got {tuple(G.shape)}")
    out = _launch_chain(G, iters, shift, refine, chain_mid, omega, fuse_xw)
    LAUNCHES["ns_chain"] += 1
    return out


def _launch_chain(G, iters, shift, refine, chain_mid, omega, fuse_xw,
                  lib=None, lay=None):
    """One launch of ``mpbqr_ns_chain`` (an (r, r) Gram) or
    ``mpbqr_ns_chain_batched`` (a (B, r, r) stack, one L2-route scratch a
    member) with :func:`ns_layout`'s layout on a checked CUDA tensor, from
    ``lib`` (by default the kernel library; a probe passes its clock build,
    ``utils/ns_variants.py`` a variant build with the layout ``lay`` that
    build checks); counts nothing.  Returns ``(X, t, resid)``."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    lib = library() if lib is None else lib

    *batch, r, _ = G.shape
    if lay is None:
        lay = ns_layout(r, _card_cluster(G, r))
    X = torch.empty_like(G)
    t = torch.empty_like(G)
    resid = torch.empty(batch, dtype=torch.float32, device=G.device)
    scratch = torch.empty((batch[0] if batch else 1) * lay.scratch_floats,
                          dtype=torch.float32, device=G.device)
    mid_iters = max(0, iters - 2) if chain_mid and not refine else 0
    ptrs = (G.data_ptr(), X.data_ptr(), t.data_ptr(), resid.data_ptr(),
            scratch.data_ptr())
    tail = (r, iters, float(shift), int(refine), mid_iters, int(omega),
            int(fuse_xw), *_c_layout(lay), _stream(G))
    if batch:
        code = lib.mpbqr_ns_chain_batched(*ptrs, batch[0], *tail)
    else:
        code = lib.mpbqr_ns_chain(*ptrs, *tail)
    check(code, "ns_chain")
    return X, t, resid


def ns_chain_batched(
    G: torch.Tensor,
    iters: int = 10,
    shift: float = 0.0,
    refine: bool = False,
    chain_mid: bool = False,
    omega: bool = True,
    fuse_xw: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`ns_chain` of each member of a stack ``G`` (B, r, r), the same
    options for all: the TPU kernel under ``jax.vmap``.

    Returns ``X (B, r, r)``, ``t (B, r, r)`` and ``resid (B,)``, member by
    member as :func:`ns_chain` gives them.  On the CPU it runs
    :func:`ns_chain_plain` on the stack.  On CUDA it is ONE launch of B
    clusters laid out by :func:`ns_layout` (the member the grid's y), with
    one L2-route scratch a member above 128; each member gets the bits of
    its single launch.  A stack that is not contiguous fp32, an r outside
    1 .. ``MAX_WIDTH`` or a B outside 1 .. ``MAX_BATCH`` raises
    ``ValueError``, with no loop of single launches in its place.  Counts
    in ``LAUNCHES`` and ``BATCH_LAUNCHES`` (one) and ``BATCH_MEMBERS``
    (B)."""
    if G.device.type == "cpu":
        return ns_chain_plain(G, iters, shift, refine, chain_mid, omega,
                              fuse_xw)
    _require_cuda_f32(G, "G", dims=3)
    B, r = G.shape[:2]
    if G.shape != (B, r, r):
        raise ValueError(f"ns_chain_batched takes (B, r, r); got "
                         f"{tuple(G.shape)}")
    out = _launch_chain(G, iters, shift, refine, chain_mid, omega, fuse_xw)
    LAUNCHES["ns_chain"] += 1
    BATCH_LAUNCHES["ns_chain"] += 1
    BATCH_MEMBERS["ns_chain"] += B
    return out


def ns_resident_clusters(device: torch.device, r: int) -> int:
    """How many K1 clusters of :func:`ns_layout` (r) the card of ``device``
    keeps resident at once (``cudaOccupancyMaxActiveClusters``): a batch of
    B chains runs in ``ceil(B / ns_resident_clusters)`` waves."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import max_cluster

    lay = ns_layout(r, max_cluster(device) if not _inst(r)
                    else L2_MAX_CLUSTER)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        check(library().mpbqr_ns_chain_resident(
            r, *_c_layout(lay), ctypes.byref(out)),
            "ns_chain resident clusters")
    return out.value


def _group_shape(Pg, r, iters, robust, dims=2):
    """``(m, w, g)`` of a CUDA group buffer the group kernels take: one
    (m, w) group, or with ``dims=3`` a (B, m, w) stack of them."""
    _require_cuda_f32(Pg, "Pg", dims)
    m, w = Pg.shape[-2:]
    g = w // max(r, 1)
    if (not 1 <= r <= MAX_WIDTH or w != g * r or len(iters) != g
            or len(robust) != g):
        raise ValueError(
            f"the group kernels take 1 <= r <= {MAX_WIDTH}, width g*r and "
            f"g entries of iters/robust; got r={r}, shape {tuple(Pg.shape)}, "
            f"{len(iters)} iters, {len(robust)} robust"
        )
    return m, w, g


def _group_buffers(lib, Pg, r, g, iters, robust):
    """Outputs ``Q``, ``Rg``, ``worst``, the scratch and the host arrays of
    one group-kernel launch (on a (B, m, w) stack: B of each output)."""
    *batch, m, w = Pg.shape
    f32 = dict(dtype=torch.float32, device=Pg.device)
    floats = (lib.mpbqr_bgs_group_batched_scratch_floats(batch[0], m, r, g)
              if batch else lib.mpbqr_bgs_group_scratch_floats(m, r, g))
    return (torch.empty_like(Pg), torch.empty((*batch, w, w), **f32),
            torch.empty(batch, **f32), torch.empty(floats, **f32),
            (ctypes.c_int * g)(*[int(i) for i in iters]),
            (ctypes.c_int * g)(*[int(bool(b)) for b in robust]))


def _launch_group(lib, Pg, r, iters, robust, bf16_dots, bf16_gram,
                  chain_mid, layout=None):
    """One call of ``mpbqr_bgs_group`` (an (m, w) group) or
    ``mpbqr_bgs_group_batched`` (a (B, m, w) stack) from the kernel library
    ``lib`` on a checked group buffer, with :func:`group_layout`'s layout
    for its B members, or ``layout`` when given (an (m, w) group at a
    stack's layout runs the batched entry at B = 1: only it takes the
    product route); counts nothing.  Returns ``(Q, Rg, worst)``."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check

    *batch, m, w = Pg.shape
    g = w // r
    if layout is None:
        layout = group_layout(m, r, _card_cluster(Pg, r),
                              batch[0] if batch else 1, g)
    elif not layout_ok(m, r, layout):
        raise ValueError(f"the group entries do not take {layout} for an "
                         f"{m} x {r} panel")
    if not batch and layout.product_route != "panel":
        Q, Rg, worst = _launch_group(lib, Pg[None], r, iters, robust,
                                     bf16_dots, bf16_gram, chain_mid, layout)
        return Q[0], Rg[0], worst[0]
    Q, Rg, worst, scratch, it_arr, rb_arr = _group_buffers(
        lib, Pg, r, g, iters, robust)
    ptrs = (Pg.data_ptr(), Q.data_ptr(), Rg.data_ptr(), worst.data_ptr(),
            scratch.data_ptr())
    head = (m, r, g, it_arr, rb_arr, int(bf16_dots), int(bf16_gram),
            int(chain_mid))
    if batch:
        code = lib.mpbqr_bgs_group_batched(*ptrs, batch[0], *head,
                                           *layout.batched_args(),
                                           _stream(Pg))
    else:
        code = lib.mpbqr_bgs_group(*ptrs, *head, *layout.args(),
                                   _stream(Pg))
    check(code, "bgs_group_fused")
    return Q, Rg, worst


def bgs_group_fused(
    Pg: torch.Tensor,
    r: int,
    iters: Sequence[int],
    robust: Sequence[bool],
    bf16_dots: bool = True,
    bf16_gram=None,
    chain_mid: bool = False,
    layout=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One whole BGS group: g sequential panel factorizations plus their
    in-group eager projections.

    ``Pg`` (m, g*r) holds the group's columns, already projected against
    previous groups; ``iters``/``robust`` give each panel's chain length and
    whether it runs the shifted three-pass chain.  ``bf16_dots`` rounds the
    projection operands to bf16, ``bf16_gram`` (default: ``bf16_dots``) the
    Gram and ``Q = P X`` operands; accumulation is fp32 throughout.
    ``chain_mid`` runs all but the final ``MID_FINAL`` iterations of each
    non-refine chain with bf16-split products.
    Returns ``(Qg (m, g*r), Rg (g*r, g*r) block-upper, worst residual)``.
    ``Pg`` is never modified: Qg is a new tensor.  On CUDA the products
    run with :func:`group_layout`'s layout, on the library's own critical
    and wide streams, which are joined into the current stream before the
    call returns; one host thread at a time may call the group kernels on
    a device.  ``layout`` (a probe's argument) runs the group at another
    :class:`GroupLayout`, e.g. a stack's: with it a member of a stack gets
    the bits it has in the batched call.
    """
    if bf16_gram is None:
        bf16_gram = bf16_dots
    if Pg.device.type == "cpu":
        return bgs_group_fused_plain(Pg, r, iters, robust, bf16_dots,
                                     bf16_gram, chain_mid)
    _group_shape(Pg, r, iters, robust)
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    out = _launch_group(library(), Pg, r, iters, robust, bf16_dots,
                        bf16_gram, chain_mid, layout)
    LAUNCHES["bgs_group_fused"] += 1
    return out


def bgs_group_fused_batched(
    Pg: torch.Tensor,
    r: int,
    iters: Sequence[int],
    robust: Sequence[bool],
    bf16_dots: bool = True,
    bf16_gram=None,
    chain_mid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`bgs_group_fused` of each member of a stack ``Pg`` (B, m,
    g*r), the same ``iters`` / ``robust`` / flags for all: the TPU kernel
    under ``jax.vmap``.

    Returns ``Qg (B, m, g*r)``, ``Rg (B, g*r, g*r)`` and ``worst (B,)``,
    member by member as :func:`bgs_group_fused` gives them.  On the CPU it
    runs :func:`bgs_group_fused_plain` on the stack.  On CUDA it is ONE C
    entry that issues the single group's sequence of launches, each over
    the B members, laid out by :func:`group_layout` for the B members
    (a stack that :func:`stack_route` admits runs csrc/stack_gemm.cu's
    products; each member gets the bits of :func:`bgs_group_fused` at the
    stack's layout) on the same two streams; a stack that is not
    contiguous fp32, a width the kernels do not take or a B outside 1 ..
    ``MAX_BATCH`` raises ``ValueError``, with no loop of single calls in
    its place.  Counts in ``LAUNCHES`` and ``BATCH_LAUNCHES`` (one) and
    ``BATCH_MEMBERS`` (B)."""
    if bf16_gram is None:
        bf16_gram = bf16_dots
    if Pg.device.type == "cpu":
        return bgs_group_fused_plain(Pg, r, iters, robust, bf16_dots,
                                     bf16_gram, chain_mid)
    _group_shape(Pg, r, iters, robust, dims=3)
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    out = _launch_group(library(), Pg, r, iters, robust, bf16_dots,
                        bf16_gram, chain_mid)
    LAUNCHES["bgs_group_fused"] += 1
    BATCH_LAUNCHES["bgs_group_fused"] += 1
    BATCH_MEMBERS["bgs_group_fused"] += Pg.shape[0]
    return out


def bgs_group_fused_proj(
    Pg: torch.Tensor,
    Qprev: torch.Tensor,
    r: int,
    iters: Sequence[int],
    robust: Sequence[bool],
    bf16_dots: bool = True,
    bf16_gram=None,
    chain_mid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`bgs_group_fused` with the inter-group projection on entry.

    ``Pg`` (m, g*r) holds the group's raw columns and ``Qprev`` (m, p) all
    previous groups' Q, fp32 or bf16: ``C2 = Qprev^T Pg`` and
    ``Pg - Qprev C2`` (operands rounded to bf16 with fp32 accumulation
    when ``bf16_dots``, true fp32 otherwise), then the group body.
    Returns ``(Qg (m, g*r), Rprev (p, g*r) = C2 unrounded, Rg, worst
    residual)``.  ``Pg`` is not modified.  On CUDA ``Qprev`` may be a
    column slice of a wider row-major buffer (unit column stride): the
    kernel reads it in place, bf16 included.
    """
    if bf16_gram is None:
        bf16_gram = bf16_dots
    if Pg.device.type == "cpu":
        return bgs_group_fused_proj_plain(Pg, Qprev, r, iters, robust,
                                          bf16_dots, bf16_gram, chain_mid)
    m, w, g = _group_shape(Pg, r, iters, robust)
    if (Qprev.device != Pg.device or Qprev.dim() != 2
            or Qprev.dtype not in (torch.float32, torch.bfloat16)
            or Qprev.shape[0] != m or Qprev.shape[1] < 1
            or Qprev.stride(1) != 1 or Qprev.stride(0) < Qprev.shape[1]):
        raise ValueError(
            "Qprev must be a float32 or bfloat16 (m, p >= 1) tensor on "
            "Pg's device with unit column stride; got "
            f"{Qprev.dtype} {tuple(Qprev.shape)} strides {Qprev.stride()} "
            f"on {Qprev.device}"
        )
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    lib = library()
    p = Qprev.shape[1]
    Q, Rg, worst, scratch, it_arr, rb_arr = _group_buffers(
        lib, Pg, r, g, iters, robust)
    Rprev = torch.empty((p, w), dtype=torch.float32, device=Pg.device)
    code = lib.mpbqr_bgs_group_proj(
        Pg.data_ptr(), Qprev.data_ptr(), Qprev.stride(0),
        int(Qprev.dtype == torch.bfloat16), p, Q.data_ptr(),
        Rprev.data_ptr(), Rg.data_ptr(), worst.data_ptr(),
        scratch.data_ptr(), m, r, g, it_arr, rb_arr, int(bf16_dots),
        int(bf16_gram), int(chain_mid),
        *group_layout(m, r, _card_cluster(Pg, r)).args(),
        *tn_split(p, w, m), _stream(Pg),
    )
    check(code, "bgs_group_fused_proj")
    LAUNCHES["bgs_group_fused_proj"] += 1
    return Q, Rprev, Rg, worst


def panel_qr_fused(
    P: torch.Tensor,
    iters: int = 10,
    robust: bool = False,
    chain_mid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One whole panel factorization: the fp32 Gram, the chain(s),
    ``Q = P X`` and the R block.

    Returns ``(Q (m, r), t (r, r), resid)``.  Plain mode runs one chain of
    ``iters`` iterations: ``t = triu(X^T G)`` and ``resid`` is the raw
    one-behind ``max|E|``.  ``robust=True`` runs the shifted three-pass
    chain (``ROBUST_ITERS``): ``t = triu(t3 t2 t1)`` of the full products
    ``t_k = X_k^T G_k``, and ``resid`` is the raw exact residual of the
    final pass (callers scale it).  ``chain_mid`` runs all but the final
    ``MID_FINAL`` iterations of each non-refine chain with bf16-split
    products.  On CUDA, r may be any of 1 .. ``MAX_WIDTH``
    (:func:`group_layout`).
    """
    if P.device.type == "cpu":
        return panel_qr_fused_plain(P, iters, robust, chain_mid)
    _require_cuda_f32(P, "P")
    m, r = P.shape
    lay = group_layout(m, r, _card_cluster(P, r))
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    lib = library()
    Q = torch.empty_like(P)
    t = torch.empty((r, r), dtype=torch.float32, device=P.device)
    resid = torch.empty((), dtype=torch.float32, device=P.device)
    scratch = torch.empty(lib.mpbqr_panel_qr_scratch_floats(m, r),
                          dtype=torch.float32, device=P.device)
    code = lib.mpbqr_panel_qr(
        P.data_ptr(), Q.data_ptr(), t.data_ptr(), resid.data_ptr(),
        scratch.data_ptr(), m, r, iters, int(robust), int(chain_mid),
        *lay.args(), _stream(P),
    )
    check(code, "panel_qr_fused")
    LAUNCHES["panel_qr_fused"] += 1
    return Q, t, resid


def ninv_chain(S: torch.Tensor, iters: int = 6
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused general Newton-Schulz inverse of the r x r Yamamoto ``S``:
    X0 = (2/3) I and ``iters`` steps of X <- X (2I - S X), in fp32.
    Returns ``(X, resid)`` with ``resid = max|I - S X|`` of the final
    iterate (NaN-propagating); callers arm their own LU fallback on it.
    On CUDA, r may be any of 1 .. ``MAX_WIDTH``; the kernel runs as one
    thread-block cluster laid out by :func:`ninv_layout` (global scratch on
    the L2 route only, above 128) and does not synchronize the host.  S is
    read with 16-byte copies when r is an instantiation and S is 16-byte
    aligned, else element by element."""
    if S.device.type == "cpu":
        return ninv_chain_plain(S, iters)
    _require_cuda_f32(S, "S")
    r = S.shape[0]
    if S.shape != (r, r) or iters < 0:
        raise ValueError(f"ninv_chain kernel takes r x r, iters >= 0; got "
                         f"{tuple(S.shape)}, iters={iters}")
    _check_width(r, "ninv_chain")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    out = _launch_ninv(library(), S, iters)
    LAUNCHES["ninv_chain"] += 1
    return out


def _launch_ninv(lib, S: torch.Tensor, iters: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``mpbqr_ninv_chain`` (an (r, r) S) or
    ``mpbqr_ninv_chain_batched`` (a (B, r, r) stack, one L2-route scratch a
    member) from the kernel library ``lib`` on a checked S, with the
    layout of :func:`ninv_layout`; counts nothing."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check

    *batch, r, _ = S.shape
    lay = ninv_layout(r, _card_cluster(S, r))
    X = torch.empty_like(S)
    resid = torch.empty(batch, dtype=torch.float32, device=S.device)
    scratch = torch.empty((batch[0] if batch else 1) * lay.scratch_floats,
                          dtype=torch.float32, device=S.device)
    ptrs = (S.data_ptr(), X.data_ptr(), resid.data_ptr(), scratch.data_ptr())
    tail = (r, iters, *_c_layout(lay), _stream(S))
    if batch:
        code = lib.mpbqr_ninv_chain_batched(*ptrs, batch[0], *tail)
    else:
        code = lib.mpbqr_ninv_chain(*ptrs, *tail)
    check(code, "ninv_chain")
    return X, resid


def ninv_chain_batched(S: torch.Tensor, iters: int = 6
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ninv_chain` of each member of a stack ``S`` (B, r, r), the
    same iteration count for all: the TPU kernel under ``jax.vmap``.

    Returns ``X (B, r, r)`` and ``resid (B,)``, member by member as
    :func:`ninv_chain` gives them.  On the CPU it runs
    :func:`ninv_chain_plain` on the stack.  On CUDA it is ONE launch of B
    clusters laid out by :func:`ninv_layout` (the member the grid's y),
    with one L2-route scratch a member above 128; each member gets the
    bits of its single launch.  A stack that is not contiguous fp32, an r
    outside 1 .. ``MAX_WIDTH``, a B outside 1 .. ``MAX_BATCH`` or negative
    ``iters`` raises ``ValueError``, with no loop of single launches in its
    place.  Counts in ``LAUNCHES`` and ``BATCH_LAUNCHES`` (one) and
    ``BATCH_MEMBERS`` (B)."""
    if S.device.type == "cpu":
        return ninv_chain_plain(S, iters)
    _require_cuda_f32(S, "S", dims=3)
    B, r = S.shape[:2]
    if S.shape != (B, r, r) or iters < 0:
        raise ValueError(f"ninv_chain_batched takes (B, r, r), iters >= 0; "
                         f"got {tuple(S.shape)}, iters={iters}")
    _check_width(r, "ninv_chain")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    out = _launch_ninv(library(), S, iters)
    LAUNCHES["ninv_chain"] += 1
    BATCH_LAUNCHES["ninv_chain"] += 1
    BATCH_MEMBERS["ninv_chain"] += B
    return out


def ninv_resident_clusters(device: torch.device, r: int) -> int:
    """How many K4 clusters of :func:`ninv_layout` (r) the card of
    ``device`` keeps resident at once (``cudaOccupancyMaxActiveClusters``):
    a batch of B inverses runs in ``ceil(B / ninv_resident_clusters)``
    waves."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import max_cluster

    lay = ninv_layout(r, max_cluster(device) if not _inst(r)
                      else L2_MAX_CLUSTER)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        check(library().mpbqr_ninv_chain_resident(
            r, *_c_layout(lay), ctypes.byref(out)),
            "ninv_chain resident clusters")
    return out.value


def tri_combine(T1: torch.Tensor, T2: torch.Tensor, T3: torch.Tensor
                ) -> torch.Tensor:
    """The R block of a robust panel, ``triu(T3 (T2 T1))``, from the three
    passes' full products ``T_k = X_k^T G_k`` (r x r each): the combine
    that closes K2's and K3's robust panels, launched on its own.  On CUDA
    the three are contiguous fp32 on one device, r any of 1 ..
    ``MAX_WIDTH``; the kernel runs :func:`combine_layout`'s CTAs in true
    fp32, both products in shared memory up to 128 and above in blocks of
    COMBINE_ROWS x COMBINE_COLS, a cluster a column block, A = T2 T1 in
    an L2-resident scratch."""
    if T1.device.type == "cpu":
        return tri_combine_plain(T1, T2, T3)
    r = T1.shape[0]
    for name, T in (("T1", T1), ("T2", T2), ("T3", T3)):
        _require_cuda_f32(T, name)
        if T.shape != (r, r) or T.device != T1.device:
            raise ValueError(f"tri_combine takes three r x r tensors on one "
                             f"device; got {name} {tuple(T.shape)} on "
                             f"{T.device}")
    lay = combine_layout(r, _card_cluster(T1, r))
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    out = torch.empty_like(T1)
    scratch = _scratch(T1, lay)
    code = library().mpbqr_tri_combine(T1.data_ptr(), T2.data_ptr(),
                                       T3.data_ptr(), out.data_ptr(),
                                       scratch.data_ptr(), r, r,
                                       *_c_layout(lay), _stream(T1))
    check(code, "tri_combine")
    PIECE_LAUNCHES["tri_combine"] += 1
    return out


def tri_cholqr_fused(P: torch.Tensor, iters: int = 10):
    """Panel factorization over :func:`ns_chain` (a composition, not a
    kernel): fp32 Gram, one chain, ``Q = P X``, with the Yamamoto column
    convention (diag of Q's top r x r block <= 0) that the reflector
    drivers need: the JAX package's ``tri_cholqr_fused(sign_fix=True)``.
    Returns ``(Q, t, X, resid)`` with ``resid`` the chain's one-behind
    residual.  On a stack (B, m, r) every member runs its own chain, all
    in one :func:`ns_chain_batched` call, and ``resid`` is one a member."""
    P = P.float()
    r = P.shape[-1]
    chain = ns_chain_batched if P.dim() == 3 else ns_chain
    X, t, resid = chain(mm_f32(P.mT, P).contiguous(), iters=iters)
    D = _sign_fix(mm_f32(P[..., :r, :], X))
    X = X * D[..., None, :]
    return mm_f32(P, X), D[..., :, None] * t, X, resid


def tri_cholqr_robust_fused(P: torch.Tensor, chain_mid: bool = False,
                            sign_fix: bool = False):
    """Shifted three-pass panel factorization over :func:`ns_chain` for
    ill-conditioned tail panels (a composition, not a kernel).  Returns
    ``(Q, t, X, resid)`` with ``resid`` the final pass's exact residual;
    ``sign_fix`` applies the Yamamoto column convention at the end.  On a
    stack (B, m, r) every member runs its own passes, each pass one
    :func:`ns_chain_batched` call, and ``resid`` is one a member."""
    P = P.float()
    chain = ns_chain_batched if P.dim() == 3 else ns_chain
    X1, t1, _ = chain(mm_f32(P.mT, P), iters=14, shift=1e-3,
                      chain_mid=chain_mid, omega=False)
    Q1 = mm_f32(P, X1)
    X2, t2, _ = chain(mm_f32(Q1.mT, Q1), iters=12, chain_mid=chain_mid,
                      omega=False)
    Q1f = mm_f32(Q1, X2)
    X3, t3, resid = chain(mm_f32(Q1f.mT, Q1f), iters=4, refine=True)
    Qs = mm_f32(Q1f, X3)
    t = torch.triu(mm_f32(t3, mm_f32(t2, t1)))
    X = mm_f32(mm_f32(X1, X2), X3)
    if sign_fix:
        D = _sign_fix(Qs[..., :P.shape[-1], :])
        Qs = Qs * D[..., None, :]
        t = D[..., :, None] * t
        X = X * D[..., None, :]
    return Qs, t, X, resid
