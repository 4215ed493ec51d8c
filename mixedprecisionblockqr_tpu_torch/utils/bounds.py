"""The least time an NVIDIA H100 could take for each kernel's work.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.bounds

prints one JSON line per kernel of the repository (K1-K9, the batched K1,
K2, K4 and K6, and the Givens chains G1-G3) at the shapes ``chip_smoke.py``
times it.  A bound is the larger of two times: the operations
the kernel does on these inputs over the peak rate for their type, and the
bytes it must move (each input read once, each output written once) over
the memory rate.  The peaks are the H100 SXM data sheet's (dense, 700 W).
This is arithmetic on shapes:
it needs no device and measures nothing.
"""

from __future__ import annotations

import json

from mixedprecisionblockqr_tpu_torch.ops.kernels.chol import chol_layout
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
    COMBINE_COLS,
    combine_layout,
    ninv_layout,
    ns_layout,
)
from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
    MAX_CLUSTER as PANEL_MAX_CLUSTER,
    MAX_WIDTH as PANEL_MAX_WIDTH,
    batched_layout,
    panel_layout,
    wide_batched_layout,
)
from mixedprecisionblockqr_tpu_torch.ops.kernels.sketch import sketch_layout

PEAK_F32 = 67e12       # fp32 outside the tensor cores
PEAK_BF16 = 989e12     # bf16 tensor cores
PEAK_INT8 = 1979e12    # int8 tensor cores
HBM_BYTES_PER_S = 3.35e12
SMS = 132              # streaming multiprocessors the peak rates are for


def bound(f32_ops=0.0, bf16_ops=0.0, nbytes=0.0, int8_ops=0.0):
    """``{"bound_ms", "bound_by"}`` for the given work."""
    t_ops = (f32_ops / PEAK_F32 + bf16_ops / PEAK_BF16
             + int8_ops / PEAK_INT8)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def cluster_bound(f32_ops, nbytes, sms):
    """The whole card's bound for ``f32_ops`` and ``nbytes``, and beside it
    ``cluster_bound_ms``: the bound of the ``sms`` SMs of a kernel's one
    thread-block cluster (or grid), the same operations at that share of
    the fp32 peak, the bytes still at the card's memory rate."""
    one = bound(f32_ops=f32_ops * SMS / sms, nbytes=nbytes)
    return {**bound(f32_ops=f32_ops, nbytes=nbytes), "cluster_sms": sms,
            "cluster_bound_ms": one["bound_ms"]}


def combine_ops(r):
    """Operations of the robust R-block combine triu(t3 (t2 t1)): two full
    r x r products."""
    return 2 * 2 * r ** 3


def chain_products(iters, refine=False):
    """r x r products of one ``ns_chain``: three per iteration, two more
    for a refine chain's exact residual, one for t = X^T G."""
    return 3 * iters + (2 if refine else 0) + 1


def tri_product_ops(r):
    """Operations of one r x r product of the chain.  Every one of them
    (X^T W, G X, X C, W C, X^T G) has an upper triangular operand, X or
    C, so output row p sums p + 1 terms over r columns: r^2 (r + 1)
    operations, about half of a full product's 2 r^3."""
    return r * r * (r + 1)


def chain_ops(r, iters, chain_mid=False, refine=False):
    """``(f32_ops, bf16_ops)`` of one chain.  With ``chain_mid`` all but
    the final two iterations of a non-refine chain run their three products
    as three bf16 products each (hi*hi + hi*lo + lo*hi), at the tensor
    cores' rate; every other product is fp32."""
    mid = max(0, iters - 2) if chain_mid and not refine else 0
    one = tri_product_ops(r)
    return ((chain_products(iters, refine) - 3 * mid) * one,
            3 * mid * 3 * one)


def robust_ops(r, chain_mid=False):
    """``(f32_ops, bf16_ops)`` of the shifted three-pass chain: 14 and 12
    iterations, a 4-iteration refine chain (never split), and the two full
    r x r products of the t3 t2 t1 combine."""
    f1, b1 = chain_ops(r, 14, chain_mid)
    f2, b2 = chain_ops(r, 12, chain_mid)
    f3, _ = chain_ops(r, 4, refine=True)
    return f1 + f2 + f3 + combine_ops(r), b1 + b2


def ns_chain_exchanges(iters, refine=False):
    """Dependent cluster exchanges of one shared-memory-route K1 launch
    (csrc/ns_chain.cuh::chain_kernel) on the fused schedule (``fuse_xw``,
    the default that every QR tier runs), each an all-gather that the
    next product waits for: two an iteration that carries W (X with W,
    then C), three one that recomputes W = G' X (X, W, C; the final two
    iterations), the closing X (which carries the residual's cluster
    max), and a refine chain's closing W and its cluster max after the
    exact residual."""
    n_fused = max(0, iters - 2)
    return 2 * n_fused + 3 * (iters - n_fused) + 1 + (2 if refine else 0)


def ns_chain_l2_exchanges(iters, refine=False, shift=False):
    """Dependent cluster barriers of one L2-route K1 launch
    (csrc/ns_chain.cuh::chain_l2_kernel): the setup's norm estimates, split
    over the cluster (one barrier before the first remote store, four an
    estimate: the maximum and the three passes; the Jacobi guard's unless
    ``refine``, the shift's with ``shift``), the barrier after the
    scratch's seeding, one an iteration (the products that read X and W
    whole wait for every CTA's columns) and the residual's cluster max at
    the end.  A refine chain's exact residual reads only the CTA's own
    columns of W: no more."""
    estimates = int(not refine) + int(bool(shift))
    return int(estimates > 0) + 4 * estimates + 1 + iters + 1


def ns_chain_bound(r, iters, chain_mid=False, refine=False,
                   exchange_ms=None, shift=False):
    """K1: G read, X and t written; the operations of ``chain_ops``.
    Beside the whole card's bound, ``cluster_bound_ms`` is the bound of
    the SMs that the one thread-block cluster of a chain can use (its
    ``ns_layout`` CTAs: R / 16 on the instantiation R that holds r, up to
    16 on the L2 route above 128): the same operations at that share of
    the peak rates (the bytes still at the card's memory rate).  With
    ``exchange_ms``, one cluster exchange of the current kernel as a run
    measured it (``utils/ns_probe.py``), also ``serial_floor_ms``: the
    launch's ``serial_exchanges`` (``ns_chain_exchanges``, on the L2 route
    ``ns_chain_l2_exchanges``, which counts the setup's with ``shift``)
    times it, what
    this design's dependent exchanges cost however fast its products.  It
    is the current design's exchange cost, not a floor of the function:
    it moves with the kernel's own exchange."""
    f32, bf16 = chain_ops(r, iters, chain_mid, refine)
    nbytes = 3 * r * r * 4
    whole = bound(f32_ops=f32, bf16_ops=bf16, nbytes=nbytes)
    sms = ns_layout(r).ctas
    share = SMS / sms
    one = bound(f32_ops=f32 * share, bf16_ops=bf16 * share, nbytes=nbytes)
    out = {**whole, "cluster_sms": sms, "cluster_bound_ms": one["bound_ms"]}
    if exchange_ms is not None:
        n = (ns_chain_l2_exchanges(iters, refine, shift)
             if ns_layout(r).route == "l2"
             else ns_chain_exchanges(iters, refine))
        out.update(serial_exchanges=n, serial_floor_ms=n * exchange_ms)
    return out


def ns_chain_batched_bound(B, r, iters, chain_mid=False, refine=False):
    """K1 over a batch of B chains (``ns_chain_batched``): B times one
    chain's operations and bytes (``ns_chain_bound``'s) at the whole card's
    rates; beside it ``member_floor_ms``, what no batch can overlap: one
    member's chain on the SMs of its own cluster (``cluster_bound_ms`` of
    ``ns_chain_bound``), and ``cluster_sms``, that cluster."""
    f32, bf16 = chain_ops(r, iters, chain_mid, refine)
    one = ns_chain_bound(r, iters, chain_mid, refine)
    return {**bound(f32_ops=B * f32, bf16_ops=B * bf16,
                    nbytes=B * 3 * r * r * 4),
            "cluster_sms": one["cluster_sms"],
            "member_floor_ms": one["cluster_bound_ms"]}


def group_work(m, r, iters, robust, bf16, proj_cols=0):
    """``(chain_f32, chain_bf16, tall, nbytes)`` of K2 / K5 on one m x (g r)
    group (``group_bound``): the chains' operations by type, the tall
    products' operations and the bytes moved."""
    chain_f32 = chain_bf16 = tall = 0
    w = len(iters) * r
    for j, (it, rb) in enumerate(zip(iters, robust)):
        f, b = robust_ops(r, bf16) if rb else chain_ops(r, it, bf16)
        chain_f32 += f
        chain_bf16 += b
        tall += (6 if rb else 2) * 2 * m * r * r
        tall += 2 * 2 * m * r * (w - (j + 1) * r)
    tall += 2 * 2 * m * proj_cols * w
    nbytes = ((2 * m * w + w * w + proj_cols * w) * 4
              + m * proj_cols * (2 if bf16 else 4))
    return chain_f32, chain_bf16, tall, nbytes


def group_bound(m, r, iters, robust, bf16, proj_cols=0):
    """K2 (and K5 with ``proj_cols`` previous columns projected out on
    entry) on an m x (g r) group: per panel the Gram(s), the chain(s),
    Q = P X and the projection of the group's later columns.  With
    ``bf16`` the tall products and K5's scrub count at the bf16 rate,
    K5's previous Q is read as bf16, and the chains run ``chain_mid``
    (the drivers set the two together)."""
    chain_f32, chain_bf16, tall, nbytes = group_work(m, r, iters, robust,
                                                     bf16, proj_cols)
    if bf16:
        return bound(f32_ops=chain_f32, bf16_ops=chain_bf16 + tall,
                     nbytes=nbytes)
    return bound(f32_ops=chain_f32 + tall, nbytes=nbytes)


def group_products(m, r, robust):
    """The tall products one K2 group of ``len(robust)`` panels issues, in
    the order of csrc/bgs_group.cu::group_body, as ``(kind, M, N, K)``:
    per panel the Gram (``gram``, r x r over m) and Q = P X (``qpx``,
    m x r over r; a robust panel three of each), then, before the last
    panel, the narrow projection of the next panel (``narrow_tn`` r x r
    over m, ``narrow_nt`` m x r over r) and the wide one of the columns
    after it (``wide_tn`` r x c over m, ``wide_nt`` m x c over r, c the
    columns left)."""
    g, out = len(robust), []
    for j, rb in enumerate(robust):
        out += [("gram", r, r, m), ("qpx", m, r, r)] * (3 if rb else 1)
        if j + 1 < g:
            out += [("narrow_tn", r, r, m), ("narrow_nt", m, r, r)]
        c = (g - j - 2) * r
        if c > 0:
            out += [("wide_tn", r, c, m), ("wide_nt", m, c, r)]
    return out


def product_work(kind, M, N, K):
    """``(operations, bytes)`` of one product of ``group_products``: 2 M N
    K; the operands read once (a Gram's one m x r panel once) and the
    output written once (a projection's update read as well)."""
    if kind.endswith("tn") or kind == "gram":
        nbytes = K * M + (0 if kind == "gram" else K * N) + M * N
    else:
        nbytes = M * K + K * N + M * N * (2 if kind != "qpx" else 1)
    return 2 * M * N * K, 4 * nbytes


def group_product_floors(B, m, r, robust, bf16):
    """The stacked products of K2 over B groups by kind (``group_products``
    one member's, each launch over the B members): ``{kind: {"launches",
    "floor_ms"}}``, each kind's B members' operations at the bf16 (with
    ``bf16``) or fp32 rate and bytes at the memory rate, the larger of the
    two summed over its launches."""
    out = {}
    for kind, M, N, K in group_products(m, r, robust):
        ops, nbytes = product_work(kind, M, N, K)
        b = (bound(bf16_ops=B * ops, nbytes=B * nbytes) if bf16
             else bound(f32_ops=B * ops, nbytes=B * nbytes))
        row = out.setdefault(kind, {"launches": 0, "floor_ms": 0.0})
        row["launches"] += 1
        row["floor_ms"] += b["bound_ms"]
    return out


def group_batched_bound(B, m, r, iters, robust, bf16):
    """K2 over a batch of B groups (``bgs_group_fused_batched``): B times
    one group's operations and bytes (``group_bound``'s) at the whole
    card's rates; beside it ``member_floor_ms``, what no batch can overlap:
    one member's chains one after another on the SMs of the chain's
    cluster (``ns_layout``'s CTAs) and its tall products at the whole
    card's rate; and ``products_floor_ms``, the B members' tall products
    launch by launch (``group_product_floors``, summed)."""
    chain_f32, chain_bf16, tall, nbytes = group_work(m, r, iters, robust,
                                                     bf16)
    products = sum(row["floor_ms"] for row in group_product_floors(
        B, m, r, robust, bf16).values())
    share = SMS / ns_layout(r).ctas
    t_floor = (share * (chain_f32 / PEAK_F32 + chain_bf16 / PEAK_BF16)
               + tall / (PEAK_BF16 if bf16 else PEAK_F32))
    if bf16:
        whole = bound(f32_ops=B * chain_f32,
                      bf16_ops=B * (chain_bf16 + tall), nbytes=B * nbytes)
    else:
        whole = bound(f32_ops=B * (chain_f32 + tall), nbytes=B * nbytes)
    return {**whole, "cluster_sms": ns_layout(r).ctas,
            "member_floor_ms": max(t_floor, nbytes / HBM_BYTES_PER_S) * 1e3,
            "products_floor_ms": products}


def panel_qr_bound(m, r):
    """K3, robust mode: three Grams, three tall products, three chains."""
    return bound(f32_ops=robust_ops(r)[0] + 6 * 2 * m * r * r,
                 nbytes=(2 * m * r + r * r) * 4)


def ninv_chain_bound(r, iters):
    """K4: 2 iters + 1 general r x r products (2 r^3 operations each); S
    read, X written.  Beside the whole card's bound, the bound of the SMs
    of its one thread-block cluster (``ninv_layout``'s CTAs,
    ``cluster_bound``)."""
    return cluster_bound((2 * iters + 1) * 2 * r ** 3, 2 * r * r * 4,
                         ninv_layout(r).ctas)


def ninv_chain_batched_bound(B, r, iters):
    """K4 over a batch of B inverses (``ninv_chain_batched``): B times one
    inverse's operations and bytes (``ninv_chain_bound``'s) at the whole
    card's rates; beside it ``member_floor_ms``, what no batch can overlap:
    one member's chain on the SMs of its own cluster
    (``cluster_bound_ms`` of ``ninv_chain_bound``), and ``cluster_sms``,
    that cluster."""
    one = ninv_chain_bound(r, iters)
    return {**bound(f32_ops=B * (2 * iters + 1) * 2 * r ** 3,
                    nbytes=B * 2 * r * r * 4),
            "cluster_sms": one["cluster_sms"],
            "member_floor_ms": one["cluster_bound_ms"]}


def tri_combine_bound(r):
    """The combine that closes K2's and K3's robust panels: ``combine_ops``;
    T1..T3 read, the r x r R block written.  Beside the whole card's bound,
    the bound of the SMs its CTAs run on (``cluster_bound``): up to 128
    ``combine_layout``'s CTAs; above, its clusters of ``ctas`` row blocks,
    one a column block of COMBINE_COLS, at most the card."""
    lay = combine_layout(r)
    sms = (lay.ctas if lay.route == "smem"
           else min(SMS, lay.ctas * -(-r // COMBINE_COLS)))
    return cluster_bound(combine_ops(r), 4 * r * r * 4, sms)


#: Clusters of K6 (``panel_factor_fused``, rows in shared memory) that an
#: NVIDIA H100 80GB HBM3 keeps resident at once, by CTAs a cluster, as
#: ``cudaOccupancyMaxActiveClusters`` gives them (``utils/panel_probe.py
#: --batched``'s resident table: the same at every shared-memory size from
#: 44,944 to 232,448 bytes a CTA, one CTA an SM).  A cluster lies inside one
#: GPC, so 10 to 16 CTAs keep 7 resident, not 132 / cluster.
H100_RESIDENT = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15,
                 9: 9, **{c: 7 for c in range(10, 17)}}


def h100_resident(lay):
    """The clusters of the K6 layout ``lay`` an H100 keeps resident at once
    (:data:`H100_RESIDENT`): the counts the layout rules take off the card,
    for the bounds and the CPU tests."""
    return H100_RESIDENT[lay.cluster]


def householder_panel_ops(m, w):
    """K6's column loop: per column the dots w^T [V | P] over the live
    rows, the rank-1 update of the columns to its right and T's column."""
    return sum(2 * (m - j) * w + 2 * (m - j) * (w - j) + j * j
               for j in range(w))


def wide_loop_ops(m, w, max_cluster=None, B=1, resident=None):
    """The column loops of K6's wide route: ``(ops, cluster)`` of each
    sub-panel ``[c, e)`` of ``wide_batched_layout(B, m, w, resident,
    max_cluster)`` (one panel's at B = 1), ``householder_panel_ops(m - c,
    e - c)`` on that sub-panel's one thread-block cluster.  The rest of
    ``householder_panel_ops(m, w)`` (the dots and T products across
    sub-panels) is what the route's trailing updates and T merges must do
    at least."""
    lay = wide_batched_layout(B, m, w, resident,
                              max_cluster or PANEL_MAX_CLUSTER)
    return [(householder_panel_ops(m - c, e - c), step.panel.cluster)
            for step in lay.steps for c, e in (step.cols,)]


def panel_factor_bound(m, w, cluster_sms=None):
    """K6: the operations of ``householder_panel_ops`` (what the function
    needs, on either route); P read, V, R and T written.  Beside the whole
    card's bound, ``cluster_bound_ms``: up to ``MAX_WIDTH`` columns the
    bound of the ``cluster_sms`` SMs of the kernel's one thread-block
    cluster (by default the cluster that ``panel_layout`` gives (m, w) on a
    card that places 16), the same operations at that share of the fp32
    peak; above it the wide route's floor, each sub-panel's column loop
    (``wide_loop_ops``, laid out on a card that places ``cluster_sms``,
    by default 16) at its own cluster's share and the remaining operations,
    run as card-wide products, at the whole card's peak; ``cluster_sms``
    is then the sub-panels' largest cluster.  The bytes are at the card's
    memory rate."""
    ops = householder_panel_ops(m, w)
    nbytes = (3 * m * w + w * w) * 4
    if w <= PANEL_MAX_WIDTH:
        if cluster_sms is None:
            cluster_sms = panel_layout(m, w).cluster
        return cluster_bound(ops, nbytes, cluster_sms)
    loops = wide_loop_ops(m, w, cluster_sms)
    t_ops = (sum(o * SMS / cl for o, cl in loops)
             + ops - sum(o for o, _ in loops)) / PEAK_F32
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {**bound(f32_ops=ops, nbytes=nbytes),
            "cluster_sms": max(cl for _, cl in loops),
            "cluster_bound_ms": max(t_ops, t_bytes) * 1e3}


def panel_factor_batched_bound(B, m, w, resident=None, max_cluster=None):
    """K6 over a batch of B m x w panels (``panel_factor_fused_batched``):
    B times one panel's operations and bytes (``panel_factor_bound``'s) at
    the whole card's rates; beside it ``member_floor_ms``, what no batch
    can overlap, and ``cluster_sms``, a member's (largest) cluster, both
    of the layouts ``batched_layout`` / ``wide_batched_layout`` give with
    ``resident`` (by default :func:`h100_resident`).  Up to 128 columns
    the floor is one member's w dependent column steps, its operations on
    the SMs of its own cluster.  Above, it is the whole wide call's: one
    member's sub-panel loops, each on its cluster (the members' loops
    overlap), plus ``products_floor_ms``, the B members' remaining
    operations (the products between sub-panels, issued once for the
    batch) at the whole card's peak; the B members' bytes at the card's
    memory rate when that is longer."""
    resident = resident or h100_resident
    mc = max_cluster or PANEL_MAX_CLUSTER
    ops = householder_panel_ops(m, w)
    nbytes = (3 * m * w + w * w) * 4
    if w <= PANEL_MAX_WIDTH:
        sms = batched_layout(B, m, w, resident, mc).cluster
        return {**bound(f32_ops=B * ops, nbytes=B * nbytes),
                "cluster_sms": sms,
                "member_floor_ms": cluster_bound(ops, nbytes, sms)[
                    "cluster_bound_ms"]}
    loops = wide_loop_ops(m, w, mc, B, resident)
    t_loops = sum(o * SMS / cl for o, cl in loops) / PEAK_F32
    t_products = B * (ops - sum(o for o, _ in loops)) / PEAK_F32
    return {**bound(f32_ops=B * ops, nbytes=B * nbytes),
            "cluster_sms": max(cl for _, cl in loops),
            "products_floor_ms": t_products * 1e3,
            "member_floor_ms": max(t_loops + t_products,
                                   B * nbytes / HBM_BYTES_PER_S) * 1e3}


def sketch_bound(d, w, r, cluster_sms=None):
    """K7: per selection step the pivot's coefficients over the sketch and
    the rank-1 downdate (4 d w operations); the sketch read and the ranks
    written once.  Beside the whole card's bound, ``cluster_bound_ms`` is
    the bound of the ``cluster_sms`` SMs of the kernel's one thread-block
    cluster (by default the cluster that ``sketch_layout`` gives (d, w)):
    the same operations at that share of the fp32 peak, the bytes still at
    the card's memory rate."""
    if cluster_sms is None:
        cluster_sms = sketch_layout(d, w).cluster
    return cluster_bound(r * 4 * d * w, (d * w + w) * 4, cluster_sms)


def matmul_bound(m, k, n, kind, out_bytes=4):
    """K8: ``2 m k n`` operations of ``kind`` ('f32', 'bf16' or 'int8')
    and each operand read, the output written, once."""
    in_bytes = {"f32": 4, "bf16": 2, "int8": 1}[kind]
    return bound(**{f"{kind}_ops": 2.0 * m * k * n},
                 nbytes=(m * k + k * n) * in_bytes + m * n * out_bytes)


def chol_rinv_bound(r, cluster_sms=None):
    """K9: the Cholesky factor and the triangular inverse, r^3 / 3
    operations each; the upper triangle of the symmetric G read (r (r + 1)
    / 2 floats), R and Rinv written.  Beside the whole card's
    bound, ``cluster_bound_ms`` is the bound of the ``cluster_sms`` SMs of
    the kernel's one thread-block cluster (by default the cluster that
    ``chol_layout`` gives r): the same operations at that share of the
    fp32 peak, the bytes still at the card's memory rate."""
    if cluster_sms is None:
        cluster_sms = chol_layout(r).cluster
    return cluster_bound(2 * r ** 3 / 3, (r * (r + 1) // 2 + 2 * r * r) * 4,
                         cluster_sms)


def rotation_bound(pairs, nbytes, steps):
    """A Givens chain: 6 fp32 operations a rotated pair of entries and the
    bytes, as ``bound``; beside it ``serial_steps``, the number of
    coefficients that each wait for the one before."""
    return {**bound(f32_ops=6.0 * pairs, nbytes=nbytes),
            "serial_steps": steps}


def givens_fold_bound(n, nb, k):
    """G1: k rows of width W = n + nb folded into an n x W factor.  Pivot
    i rotates the W - i entries of the upper trapezoid in each row; the
    trapezoid read and written once, the rows read once.  The dependent
    steps form a wavefront of n + k - 1 (pivot i of row t waits for pivot
    i - 1 of row t and pivot i of row t - 1)."""
    W = n + nb
    trap = n * W - n * (n - 1) // 2
    return rotation_bound(k * trap, (2 * trap + k * W) * 4, n + k - 1)


def givens_chain_bound(m, n, start=0):
    """G2 on an upper triangular R (m x n) and Q^T (m x m), as
    ``qr_rank1_update`` runs it (``start`` = 0; ``qr_insert_col`` starts at
    its column): rotation i, for i = m - 2 down to ``start``, meets the
    n - i columns >= i of R (both rows are zero left of i) and every column
    of Q^T.  Rows start.. of R's upper trapezoid are read, and written back
    with the entry R[i + 1, i] that rotation i fills in; those rows of Q^T
    are read and written once, the vector read once; m - 1 - start
    dependent steps."""
    steps = m - 1 - start
    rot = range(start, m - 1)
    trap = sum(max(n - i, 0) for i in range(start, m))
    fill = sum(1 for i in rot if i < n)
    pairs = sum(max(n - i, 0) for i in rot) + steps * m
    return rotation_bound(
        pairs, (2 * trap + fill + 2 * (m - start) * m + m - start) * 4, steps)


def givens_hessenberg_bound(m, n):
    """G3 as ``qr_rank1_update`` runs it: L = min(m - 1, n) rotations on an
    upper Hessenberg H (m x n) and Q^T (m x m); rotation i meets the n - i
    columns of H from column i on and every column of Q^T.  H's Hessenberg
    part (column j down to row j + 1) and rows 0..L of Q^T read and written
    once; L dependent steps."""
    L = min(m - 1, n)
    pairs = sum(n - i for i in range(L)) + L * m
    hess = sum(min(j + 2, m) for j in range(n))
    return rotation_bound(pairs, 2 * (hess + (L + 1) * m) * 4, L)


def kernel_bounds():
    """Every kernel's bound at the shapes ``chip_smoke.py`` times."""
    head = (12, 6, 6, 6, 6, 6, 6, 10)
    return {
        "K1 ns_chain": {"shape": "r=128, 6 iterations (chain_mid)",
                        **ns_chain_bound(128, 6, chain_mid=True)},
        "K1 ns_chain shift": {
            "shape": "r=128, 14 iterations (chain_mid, shift)",
            **ns_chain_bound(128, 14, chain_mid=True)},
        "K1 ns_chain refine": {"shape": "r=128, 4 iterations (refine)",
                               **ns_chain_bound(128, 4, refine=True)},
        "K2 bgs_group_fused": {
            "shape": "2048 x 1024, g=8, bf16, robust last panel",
            **group_bound(2048, 128, head, (False,) * 7 + (True,), True)},
        **{f"K1 ns_chain_batched {B}x{r}x{r} {name}": {
            "shape": f"{B} x {r} x {r}, {it} iterations ({name})",
            **ns_chain_batched_bound(B, r, it, **kw)}
           for B, r, name, it, kw in (
               (8, 128, "plain", 10, {}), (8, 128, "shift", 14, {}),
               (8, 128, "refine", 4, {"refine": True}),
               (8, 128, "chain_mid", 6, {"chain_mid": True}),
               (4, 256, "chain_mid", 6, {"chain_mid": True}))},
        **{f"K2 bgs_group_fused_batched {B}x2048x{4 * r} {kind}": {
            "shape": f"{B} x 2048 x {4 * r}, g=4, r={r}, {kind}, robust "
                     "last panel",
            **group_batched_bound(B, 2048, r, (12, 6, 6, 10),
                                  (False,) * 3 + (True,), kind == "bf16")}
           for B, r, kind in ((8, 128, "bf16"), (8, 128, "fp32"),
                              (2, 256, "bf16"))},
        "K3 panel_qr_fused": {"shape": "4096 x 128, robust",
                              **panel_qr_bound(4096, 128)},
        "K3 tri_combine": {"shape": "r=128 (robust R block)",
                           **tri_combine_bound(128)},
        "K4 ninv_chain": {"shape": "r=128, 5 iterations",
                          **ninv_chain_bound(128, 5)},
        "K4 ninv_chain 12": {"shape": "r=128, 12 iterations",
                             **ninv_chain_bound(128, 12)},
        **{f"K4 ninv_chain_batched {B}x{r}x{r} {it} it": {
            "shape": f"{B} x {r} x {r}, {it} iterations",
            **ninv_chain_batched_bound(B, r, it)}
           for B, r, it in ((8, 128, 5), (8, 128, 12), (16, 128, 12),
                            (3, 100, 5), (4, 256, 5))},
        "K5 bgs_group_fused_proj": {
            "shape": "2048 x 1024, g=8, bf16, 1024 previous columns",
            **group_bound(2048, 128, head, (False,) * 7 + (True,), True,
                          proj_cols=1024)},
        **{f"K6 panel_factor_fused {m}x128": {
            "shape": f"{m} x 128", **panel_factor_bound(m, 128)}
           for m in (2048, 2176, 3072, 4096, 8192)},
        **{f"K6 panel_factor_fused {m}x{w} (wide route)": {
            "shape": f"{m} x {w}", **panel_factor_bound(m, w)}
           for m, w in ((2048, 256), (2000, 200), (4096, 512), (8192, 256),
                        (4096, 2048), (1024, 256), (512, 256))},
        **{f"K6 panel_factor_fused_batched {B}x{m}x{w}": {
            "shape": f"{B} x {m} x {w}", **panel_factor_batched_bound(B, m, w)}
           for B, m, w in ((64, 1563, 64), (8, 512, 128), (4, 1024, 256),
                           (32, 128, 64), (64, 1024, 256), (32, 512, 256))},
        "K7 sketch_qrcp_ranks": {"shape": "136 x 2048, 128 pivots",
                                 **sketch_bound(136, 2048, 128)},
        "K8 tiled_matmul": {"shape": "2048^3 bf16 -> f32",
                            **matmul_bound(2048, 2048, 2048, "bf16")},
        "K8 tiled_matmul f32": {"shape": "2048^3 f32",
                                **matmul_bound(2048, 2048, 2048, "f32")},
        "K8 tiled_matmul int8": {"shape": "2048^3 int8 -> int32",
                                 **matmul_bound(2048, 2048, 2048, "int8")},
        **{f"K9 chol_rinv r={r}": {"shape": f"r={r}", **chol_rinv_bound(r)}
           for r in (32, 96, 128, 256, 320, 512, 1024)},
        **{f"G1 givens_fold_rows n={n} k={k}": {
            "shape": f"{n} x {n + 1}, {k} rows", **givens_fold_bound(n, 1, k)}
           for n, k in ((256, 16), (256, 1), (1024, 16), (2048, 16),
                        (2048, 1))},
        **{f"G2 givens_chain m=n={m}": {
            "shape": f"R {m} x {m}, Q^T {m} x {m}",
            **givens_chain_bound(m, m)} for m in (512, 1024, 2048)},
        **{f"G3 givens_hessenberg m=n={m}": {
            "shape": f"H {m} x {m}, Q^T {m} x {m}",
            **givens_hessenberg_bound(m, m)} for m in (512, 1024, 2048)},
    }


def main() -> int:
    for name, row in kernel_bounds().items():
        print(json.dumps({"kernel": name, **row}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
