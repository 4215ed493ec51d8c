"""K1 ``ns_chain``, K2 ``bgs_group_fused`` and K4 ``ninv_chain`` over a batch
on the card: their batched entries (``ns_chain_batched``,
``bgs_group_fused_batched``, ``ninv_chain_batched``) against the batched
plain versions, beside the loop of single calls, one PyTorch call on the
stack and the bound.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.batched_probe [--serial]

Builds (or loads) the kernel library and prints JSON lines: first the
card's name and power limit (nvidia-smi), then one line per K1 case of
:data:`K1_CASES`, one per K2 case of :data:`K2_CASES` and one per K4 case
of :data:`K4_CASES` (the cases ``chip_smoke.py`` phase 3 holds), each
with:

* the layout (K1: ``ns_layout``'s CTAs and route; K2: ``group_layout``
  for the B members, with its product route; K4: ``ninv_layout``'s) and,
  for K1 and K4, the
  clusters the card keeps resident (``ns_resident_clusters``,
  ``ninv_resident_clusters``) and the waves of the batch;
* the error against the plain version on the stack at phase 3's
  tolerances (K1: X and t within 1e-4 x max|plain|, the same canary class;
  K2: R and its robust tail block 1e-4 relative under fp32 flags, 5e-3
  under the bf16 flags, Q 1e-4 absolute or 5e-3 relative; K4: X within
  1e-4 x max|plain|, the same fallback class (resid < 1e-3) a member),
  two batched calls bit for bit equal, and every member bit for bit its
  single call (K2: at the stack's layout);
* CUDA-event times (median of 20; the plain version's of 3): the batched
  call, the loop of single calls, the plain version, the library call
  (``torch.linalg.cholesky`` of the Gram stack for K1, ``torch.linalg.qr``
  of the group stack for K2, ``torch.linalg.inv`` of the S stack for K4);
  and the bound (``utils/bounds.py``: the whole card's for B members, and
  one member's floor on its cluster);
* for K2, the device kernels, streams and idle share of one call
  (``torch.profiler``), and its device time by kind (:func:`k2_kinds`:
  the Grams, Q = P X, the narrow and wide projections' two products, the
  chains, the combine), each kind's launches, CTAs a launch and floor
  (``utils/bounds.py::group_product_floors``).

``--serial`` builds the library a second time with ``-DMPBQR_GROUP_SERIAL``
(the group entries' kernels in program order on the caller's stream) and
times each K2 stack on both builds in one process, asserting bitwise-equal
outputs: whether the two streams still help when every launch holds B
members.

``--k2`` runs the K2 stacks alone.  To time an older tree's kernels, copy
this file and ``utils/bounds.py`` into its package and run it there: a
package whose ``group_layout`` takes no ``members`` runs its stacks at the
single group's layout, against its members' single calls.

It needs a CUDA device and ``nvcc``; without a device it exits 2.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import sys

import torch

#: Phase 3's TOL_F32 / TOL_BF16: summation order only; a bf16 rounding may
#: flip.
TOL_F32 = 1e-4
TOL_BF16 = 5e-3
#: K1 stacks: (name, B, r, Gram kind, options).  The Gram of a uniform
#: 2048 x r panel ("well"), of the same panel graded over three decades
#: ("ill", the shifted robust pass) and of its orthonormalized panel
#: ("near_identity", refine).
K1_CASES = (
    ("plain", 8, 128, "well", dict(iters=10)),
    ("shift", 8, 128, "ill", dict(iters=14, shift=1e-3, omega=False,
                                  chain_mid=True)),
    ("refine", 8, 128, "near_identity", dict(iters=4, refine=True)),
    ("chain_mid", 8, 128, "well", dict(iters=6, chain_mid=True)),
    ("l2_chain_mid", 4, 256, "well", dict(iters=6, chain_mid=True)),
)
#: K2 stacks: (name, B, m, r, g, bf16 flags and chain_mid); the chains of
#: a headline-shaped group of four panels, the last one robust.
K2_CASES = (
    ("bgs1_8x2048x512", 8, 2048, 128, 4, True),
    ("bgs2_8x2048x512", 8, 2048, 128, 4, False),
    ("bgs1_16x2048x512", 16, 2048, 128, 4, True),  # two waves of chains
    ("bgs1_2x2048x1024_r256", 2, 2048, 256, 4, True),
)
K2_ITERS = (12, 6, 6, 10)
#: K4 stacks: (name, B, m, r, iterations): Yamamoto S matrices of uniform
#: m x r panels (``ninv_probe.yamamoto_s``): the polar driver's tall panel
#: (aspect 32, 5 iterations) and its aspect-2 panel (12, the LU fallback
#: armed), 16 of them (two waves if 15 clusters are resident), the padded
#: instantiation (r = 100 on R = 128) and the L2 route (r = 256: 4
#: members, and 8 in two waves if 7 clusters of 16 are resident).
K4_CASES = (
    ("panel4096_it5", 8, 4096, 128, 5),
    ("panel256_it12", 8, 256, 128, 12),
    ("panel256_it12_B16", 16, 256, 128, 12),
    ("padded_r100_it5", 3, 3200, 100, 5),
    ("l2_r256_it5", 4, 8192, 256, 5),
    ("l2_r256_it5_waves", 8, 4096, 256, 5),
)
#: The drivers' LU fallback threshold on K4's residual (ops/blockqr.py).
K4_FALLBACK = 1e-3


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def k1_stack(kind: str, B: int, r: int, gen: torch.Generator,
             dev: torch.device) -> torch.Tensor:
    """A (B, r, r) stack of Grams of ``kind`` (see :data:`K1_CASES`)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import ns_chain_plain
    from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32

    P = torch.rand((B, 2048, r), generator=gen, device=dev) - 0.5
    if kind == "ill":
        P = P * torch.logspace(0, -3, r, device=dev)
    elif kind == "near_identity":
        X, _, _ = ns_chain_plain(mm_f32(P.mT, P), iters=10)
        P = mm_f32(P, X)
    return mm_f32(P.mT, P).contiguous()


def k1_batched_row(G: torch.Tensor, kw: dict) -> dict:
    """K1's batched entry on the Gram stack ``G`` (B, r, r) with the options
    ``kw``: layout, resident clusters and waves; error against
    ``ns_chain_plain`` on the stack; bitwise repeat; each member bit for
    bit its single launch; times (one launch, and ``loop_ms``: a launch of
    ``ns_probe.LOOP`` back to back); ``torch.linalg.cholesky`` on the
    stack, and with the triangular inverse (``library_inverse_ms``,
    ``ns_probe.cholesky_inverse``); bounds.  Counts on the launch counters
    like any call: callers set them to 0 before a main path."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        _card_cluster,
        ns_chain,
        ns_chain_batched,
        ns_chain_plain,
        ns_layout,
        ns_resident_clusters,
    )
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        ns_chain_batched_bound,
    )
    from mixedprecisionblockqr_tpu_torch.utils.ns_probe import (
        LOOP,
        cholesky_inverse,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    B, r = G.shape[:2]
    lay = ns_layout(r, _card_cluster(G, r))
    resident = ns_resident_clusters(G.device, r)
    row = {"shape": [B, r, r], "options": kw, "route": lay.route,
           "ctas": lay.ctas, "resident_clusters": resident,
           "waves": -(-B // max(1, resident))}
    X, t, res = ns_chain_batched(G, **kw)
    again = ns_chain_batched(G, **kw)
    Xp, tp, resp = ns_chain_plain(G, **kw)
    singles = [ns_chain(G[i], **kw) for i in range(B)]
    torch.cuda.synchronize()
    row["bitwise_repeatable"] = all(
        bool(torch.equal(a, b)) for a, b in zip((X, t, res), again))
    row["members_bitwise_single_launch"] = all(
        bool(torch.equal(X[i], s[0]) and torch.equal(t[i], s[1])
             and torch.equal(res[i], s[2])) for i, s in enumerate(singles))
    row["err_X"], row["lim_X"] = _max_abs(X, Xp), TOL_F32 * float(
        Xp.abs().max())
    row["err_t"], row["lim_t"] = _max_abs(t, tp), TOL_F32 * float(
        tp.abs().max())
    row["max_abs_err"] = max(row["err_X"], row["err_t"])
    row["resid"] = res.tolist()
    row["resid_plain"] = resp.tolist()
    same_class = bool(((res < 1e-4) == (resp < 1e-4)).all())
    row["ok"] = (row["err_X"] <= row["lim_X"] and row["err_t"] <= row["lim_t"]
                 and same_class and row["bitwise_repeatable"]
                 and row["members_bitwise_single_launch"])
    row["ms"] = cuda_time_ms(lambda: ns_chain_batched(G, **kw))
    row["loop_ms"] = cuda_time_ms(
        lambda: [ns_chain_batched(G, **kw) for _ in range(LOOP)]) / LOOP
    row["single_loop_ms"] = cuda_time_ms(
        lambda: [ns_chain(g, **kw) for g in G], warmup=1, iters=10)
    row["plain_ms"] = cuda_time_ms(lambda: ns_chain_plain(G, **kw),
                                   warmup=1, iters=3)
    row["library_ms"] = cuda_time_ms(lambda: torch.linalg.cholesky(G))
    row["library_inverse_ms"] = cuda_time_ms(lambda: cholesky_inverse(G))
    row.update(ns_chain_batched_bound(
        B, r, kw["iters"], chain_mid=kw.get("chain_mid", False),
        refine=kw.get("refine", False)))
    return row


_PRODUCT = re.compile(r"gemm_tn|gemm_nt|stack_tn|stack_nt|stack_proj")


def stack_layout(m: int, r: int, cluster: int, B: int, g: int):
    """``group_layout`` for B members of g panels, or the single group's
    where the package's ``group_layout`` takes no ``members`` (a tree from
    before the stack's layout)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import group_layout

    if "members" in inspect.signature(group_layout).parameters:
        return group_layout(m, r, cluster, members=B, g=g)
    return group_layout(m, r, cluster)


def product_ctas(lay, B: int, kind: str, M: int, N: int) -> int:
    """CTAs of one launch of a product of ``kind`` (M x N output) over B
    members at the group layout ``lay`` (csrc/panel.cuh, or on the stack
    route csrc/stack_gemm.cu)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns

    tn = kind == "gram" or kind.endswith("tn")
    bm = lay.bm_wide if kind == "wide_nt" else lay.bm_panel
    if kind == "narrow":  # stack_proj: one cluster of `split` a member
        return B * lay.split
    if getattr(lay, "product_route", "panel") == "stack":
        T = ns.STACK_TILE
        return (B * -(-N // T) * -(-M // T) * lay.split if tn
                else B * -(-N // T) * -(-M // bm))
    if tn:
        return B * -(-N // ns.TN_TILE) * -(-M // ns.TN_TILE) * lay.split
    return B * -(-N // lay.bn) * -(-M // bm)


def k2_kinds(spans, lay, B: int, m: int, r: int, robust, bf16: bool) -> dict:
    """One K2 call's device spans (``group_probe._profile_once``) by kind:
    the products matched in issue order to ``bounds.group_products``
    (the critical stream's Grams, Q = P X and narrow projections, the
    narrow pair as one ``narrow`` launch where ``ns.stack_fused_narrow``;
    the other stream's wide projections), the chains, the combine, the
    rest (copies, the worst residual).  ``{kind: {"ms", "launches"}}``,
    the products' with their CTAs a launch (``product_ctas``) and floor
    (``bounds.group_product_floors``); ``unmatched`` counts product spans
    past the expected sequence."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        group_product_floors,
        group_products,
    )

    fused = (hasattr(ns, "stack_fused_narrow")
             and ns.stack_fused_narrow(lay, r))
    crit_streams = {st for name, st, _, _ in spans if "chain" in name}
    seq = [p for p in group_products(m, r, robust)
           if not (fused and p[0] == "narrow_nt")]
    if fused:
        seq = [("narrow", *p[1:]) if p[0] == "narrow_tn" else p for p in seq]
    want = {True: [p for p in seq if not p[0].startswith("wide")],
            False: [p for p in seq if p[0].startswith("wide")]}
    out: dict = {}
    unmatched = 0
    for crit in (True, False):
        mine = sorted((s, e) for name, st, s, e in spans
                      if _PRODUCT.search(name) and (st in crit_streams)
                      == crit)
        for i, (s, e) in enumerate(mine):
            if i >= len(want[crit]):
                unmatched += 1
                continue
            kind, M, N, _ = want[crit][i]
            row = out.setdefault(kind, {"ms": 0.0, "launches": 0,
                                        "ctas": []})
            row["ms"] += (e - s) / 1e3
            row["launches"] += 1
            ctas = product_ctas(lay, B, kind, M, N)
            if ctas not in row["ctas"]:
                row["ctas"].append(ctas)
    for name, _, s, e in spans:
        if _PRODUCT.search(name):
            continue
        kind = ("chain" if "chain" in name else "combine"
                if "combine" in name else "other")
        row = out.setdefault(kind, {"ms": 0.0, "launches": 0})
        row["ms"] += (e - s) / 1e3
        row["launches"] += 1
    floors = group_product_floors(B, m, r, robust, bf16)
    if fused:
        floors["narrow"] = {"floor_ms": floors.pop("narrow_tn")["floor_ms"]
                            + floors.pop("narrow_nt")["floor_ms"]}
    for kind, floor in floors.items():
        out.setdefault(kind, {"ms": 0.0, "launches": 0, "ctas": []})[
            "floor_ms"] = floor["floor_ms"]
    out["products_ms"] = sum(row["ms"] for k, row in out.items()
                             if isinstance(row, dict) and "ctas" in row)
    out["unmatched"] = unmatched
    return out


def timeline(spans) -> list:
    """One call's device spans as ``[kernel, stream, start us, end us]``
    from its first start, in order of start (``--timeline``)."""
    from mixedprecisionblockqr_tpu_torch.utils.group_probe import _short

    t0 = min(s for _, _, s, _ in spans)
    return [[_short(n)[:28], st, round(s - t0, 1), round(e - t0, 1)]
            for n, st, s, e in sorted(spans, key=lambda x: x[2])]


def k2_batched_row(Pg: torch.Tensor, r: int, bf16: bool,
                   iters=K2_ITERS, spans_out: bool = False) -> dict:
    """K2's batched entry on the group stack ``Pg`` (B, m, g r), its last
    panel robust, the bf16 flags and ``chain_mid`` as ``bf16``: the
    stack's layout; error against ``bgs_group_fused_plain`` on the stack;
    bitwise repeat; each member bit for bit its single call at the
    stack's layout; times; device kernels, streams, idle share and time
    by kind of one call; bounds.  Counts on the launch counters like any
    call."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        _card_cluster,
        bgs_group_fused,
        bgs_group_fused_batched,
        bgs_group_fused_plain,
    )
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        group_batched_bound,
    )
    from mixedprecisionblockqr_tpu_torch.utils.group_probe import (
        _profile_once,
        device_breakdown,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    B, m, w = Pg.shape
    robust = (False,) * (len(iters) - 1) + (True,)
    kw = dict(bf16_dots=bf16, chain_mid=bf16)
    lay = stack_layout(m, r, _card_cluster(Pg, r), B, len(iters))
    if "layout" in inspect.signature(bgs_group_fused).parameters:
        kw1 = dict(kw, layout=lay)
    else:  # a tree from before the stack's layout: the single group's
        kw1 = kw

    def batched():
        return bgs_group_fused_batched(Pg, r, iters, robust, **kw)

    row = {"shape": [B, m, w], "r": r, "g": len(iters), "bf16": bf16,
           "layout": lay._asdict()}
    row["layout"]["chain"] = lay.chain._asdict()
    Q, R, worst = batched()
    again = batched()
    Qp, Rp, wp = bgs_group_fused_plain(Pg, r, iters, robust, **kw)
    singles = [bgs_group_fused(Pg[i], r, iters, robust, **kw1)
               for i in range(B)]
    torch.cuda.synchronize()
    row["bitwise_repeatable"] = all(
        bool(torch.equal(a, b)) for a, b in zip((Q, R, worst), again))
    row["members_bitwise_single_launch"] = all(
        bool(torch.equal(Q[i], s[0]) and torch.equal(R[i], s[1])
             and torch.equal(worst[i], s[2])) for i, s in enumerate(singles))
    row["max_abs_Q"] = _max_abs(Q, Qp)
    row["rel_Q"] = max(_rel(Q[i], Qp[i]) for i in range(B))
    row["rel_R"] = max(_rel(R[i], Rp[i]) for i in range(B))
    row["rel_R_tail"] = max(_rel(R[i, -r:, -r:], Rp[i, -r:, -r:])
                            for i in range(B))
    row["max_abs_err"] = row["max_abs_Q"]
    row["resid"] = worst.tolist()
    row["resid_plain"] = wp.tolist()
    tol = TOL_BF16 if bf16 else TOL_F32
    ok = (row["rel_R"] <= tol and row["rel_R_tail"] <= tol
          and (row["rel_Q"] <= TOL_BF16 if bf16
               else row["max_abs_Q"] <= TOL_F32))
    row["ok"] = (ok and bool(((worst < 1e-4) == (wp < 1e-4)).all())
                 and row["bitwise_repeatable"]
                 and row["members_bitwise_single_launch"])
    row["ms"] = cuda_time_ms(batched)
    row["single_loop_ms"] = cuda_time_ms(
        lambda: [bgs_group_fused(p, r, iters, robust, **kw) for p in Pg],
        warmup=1, iters=10)
    row["plain_ms"] = cuda_time_ms(
        lambda: bgs_group_fused_plain(Pg, r, iters, robust, **kw),
        warmup=1, iters=3)
    row["library_ms"] = cuda_time_ms(lambda: torch.linalg.qr(Pg))
    try:
        prof = device_breakdown(batched, calls=1)
        spans = _profile_once(batched)
        kinds = k2_kinds(spans, lay, B, m, r, robust, bf16)
        if spans_out:
            row["timeline"] = timeline(spans)
    except RuntimeError:  # the profile saw no device activity
        prof = kinds = None
    if prof is not None:
        row["device_events"] = prof["device_events"]
        row["streams"] = prof["streams"]
        row["idle_share"] = prof.get("idle_share")
        row["largest"] = dict(list(prof["kernels"].items())[:5])
        row["kinds"] = kinds
    row.update(group_batched_bound(B, m, r, iters, robust, bf16))
    return row


#: The stack route's products alone (csrc/stack_gemm.cu through
#: ``mpbqr_stack_product``): (name, ta, B, m, w, M, N, K, a_col, b_col,
#: split, chunk, rows per CTA, sub, in place) on a (B, m, w) group buffer,
#: at the shapes of the K2 stacks: the Gram, the narrow and wide G1 =
#: Q^T C, Q = P X in place, the narrow and wide updates, r = 256 and a
#: short stack.
STACK_PRODUCTS = (
    ("gram", 1, 8, 2048, 512, 128, 128, 2048, 128, 128, 8, 256, 0, 0, 0),
    ("narrow_tn", 1, 8, 2048, 512, 128, 128, 2048, 0, 128, 8, 256, 0, 0, 0),
    ("wide_tn", 1, 8, 2048, 512, 128, 256, 2048, 0, 256, 8, 256, 0, 0, 0),
    ("gram_r256", 1, 2, 2048, 1024, 256, 256, 2048, 256, 256, 8, 256, 0, 0,
     0),
    ("gram_short", 1, 3, 130, 512, 128, 128, 130, 0, 0, 2, 128, 0, 0, 0),
    ("qpx_in_place", 0, 8, 2048, 512, 2048, 128, 128, 128, 0, 0, 0, 128, 0,
     1),
    ("narrow_nt", 0, 8, 2048, 512, 2048, 128, 128, 0, 128, 0, 0, 128, 1, 0),
    ("wide_nt", 0, 8, 2048, 512, 2048, 256, 128, 0, 256, 0, 0, 256, 1, 0),
    ("qpx_r256", 0, 2, 2048, 1024, 2048, 256, 256, 256, 0, 0, 0, 128, 0, 0),
    ("qpx_short", 0, 3, 130, 512, 130, 128, 128, 0, 0, 0, 0, 128, 0, 1),
    # the fused narrow projection (ta = 2: G1 into C, A's columns b_col
    # updated in place)
    ("narrow_proj", 2, 8, 2048, 512, 128, 128, 2048, 0, 128, 8, 256, 0, 1,
     0),
    ("narrow_proj_short", 2, 3, 130, 512, 128, 128, 130, 128, 256, 2, 128, 0,
     1, 0),
)


def stack_product_rows(gen: torch.Generator, dev: torch.device) -> list:
    """Each product of :data:`STACK_PRODUCTS` under both flags: against a
    float64 product of the same (bf16-rounded under the bf16 flags)
    operands, max|err| within 1e-5 x max|ref| (the fp32 sum's order);
    two launches bit for bit; each member bit for bit a one-member launch;
    device ms (``group_probe.device_ms``) and the bound of its bytes and
    operations."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import _stream
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        bound, product_work,
    )
    from mixedprecisionblockqr_tpu_torch.utils.group_probe import device_ms

    lib = library()
    rows = []
    for (name, ta, B, m, w, M, N, K, ac, bc, split, chunk, rows_cta, sub,
         inplace) in STACK_PRODUCTS:
        for bf in (True, False):
            P0 = torch.rand((B, m, w), generator=gen, device=dev) - 0.5
            Xs = torch.rand((B, K, N), generator=gen, device=dev) - 0.5

            def rnd(x):
                return x.bfloat16().double() if bf else x.double()

            def run(P, X, C, members=B):
                if ta:
                    args = (ta, int(bf), members, M, N, K, P.data_ptr(), m, w,
                            m * w, ac, P.data_ptr(), w, m * w, bc,
                            C.data_ptr(), N, M * N)
                elif inplace:
                    args = (0, int(bf), members, M, N, K, P.data_ptr(), m, w,
                            m * w, ac, X.data_ptr(), N, K * N, 0,
                            P.data_ptr() + 4 * ac, w, m * w)
                else:
                    args = (0, int(bf), members, M, N, K, P.data_ptr(), m, w,
                            m * w, ac, X.data_ptr(), N, K * N, 0,
                            P.data_ptr() + 4 * bc, w, m * w)
                check(lib.mpbqr_stack_product(
                    *args, int(sub), split, chunk, rows_cta, _stream(P)),
                    f"stack product {name}")

            def call(P, X, members=B):
                P = P.clone()
                C = torch.zeros((members, M, N), device=dev) if ta else None
                run(P, X, C, members)
                if ta == 2:
                    return torch.cat([C, P[..., bc:bc + N]], dim=1)
                if ta:
                    return C
                return P[..., bc:bc + N] if not inplace else P[..., ac:ac + N]

            if ta == 2:  # G1 against float64, C against the kernel's G1
                G1 = rnd(P0[..., ac:ac + M]).mT @ rnd(P0[..., bc:bc + N])
                out0 = call(P0, Xs)
                ref = torch.cat([G1, P0[..., bc:bc + N].double()
                                 - rnd(P0[..., ac:ac + M])
                                 @ rnd(out0[:, :M].float())], dim=1)
            elif ta:
                ref = rnd(P0[..., ac:ac + M]).mT @ rnd(P0[..., bc:bc + N])
            else:
                prod = rnd(P0[..., ac:ac + K]) @ rnd(Xs)
                base = P0[..., bc:bc + N].double()
                ref = base - prod if sub else prod
            out = call(P0, Xs)
            again = call(P0, Xs)
            ones = [call(P0[i:i + 1], Xs[i:i + 1], 1) for i in range(B)]
            Pt = P0.clone()
            Ct = torch.zeros((B, M, N), device=dev) if ta else None
            if ta == 2:
                Pt = Pt.abs() * 0  # repeated in place: keep it finite
            t_ms = device_ms(lambda: run(Pt, Xs, Ct))
            torch.cuda.synchronize()
            err = float((out.double() - ref).abs().max())
            lim = 1e-5 * float(ref.abs().max())
            kinds = (["narrow_tn", "narrow_nt"] if ta == 2 else
                     ["gram" if name.startswith("gram") else "narrow_tn"
                      if ta else "qpx" if not sub else "narrow_nt"])
            ops = nbytes = 0
            for kind in kinds:  # the fused pair's update is K x N over M
                o, b = product_work(kind, *((K, N, M) if ta == 2
                                            and kind == "narrow_nt"
                                            else (M, N, K)))
                ops, nbytes = ops + o, nbytes + b
            rows.append({
                "product": name, "bf16": bf, "members": B, "M": M, "N": N,
                "K": K, "err": err, "lim": lim,
                "bitwise_repeatable": bool(torch.equal(out, again)),
                "members_bitwise_one": all(
                    bool(torch.equal(out[i:i + 1], o))
                    for i, o in enumerate(ones)),
                "device_ms": t_ms,
                **bound(**({"bf16_ops": B * ops} if bf
                           else {"f32_ops": B * ops}), nbytes=B * nbytes)})
            rows[-1]["ok"] = (err <= lim and rows[-1]["bitwise_repeatable"]
                              and rows[-1]["members_bitwise_one"])
    return rows


def k4_stack(B: int, m: int, r: int, gen: torch.Generator,
             dev: torch.device) -> torch.Tensor:
    """A (B, r, r) stack of Yamamoto S matrices of uniform m x r panels
    (see :data:`K4_CASES`)."""
    from mixedprecisionblockqr_tpu_torch.utils.ninv_probe import yamamoto_s

    return yamamoto_s(m, gen, dev, r=r, batch=(B,))


def k4_batched_row(S: torch.Tensor, iters: int) -> dict:
    """K4's batched entry on the S stack ``S`` (B, r, r): layout, resident
    clusters and waves; error against ``ninv_chain_plain`` on the stack;
    the fallback class a member; bitwise repeat; each member bit for bit
    its single launch; times; bounds.  Counts on the launch counters like
    any call: callers set them to 0 before a main path."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        _card_cluster,
        ninv_chain,
        ninv_chain_batched,
        ninv_chain_plain,
        ninv_layout,
        ninv_resident_clusters,
    )
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        ninv_chain_batched_bound,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    B, r = S.shape[:2]
    lay = ninv_layout(r, _card_cluster(S, r))
    resident = ninv_resident_clusters(S.device, r)
    row = {"shape": [B, r, r], "iters": iters, "route": lay.route,
           "ctas": lay.ctas, "resident_clusters": resident,
           "waves": -(-B // max(1, resident))}
    X, res = ninv_chain_batched(S, iters)
    again = ninv_chain_batched(S, iters)
    Xp, resp = ninv_chain_plain(S, iters)
    singles = [ninv_chain(S[i], iters) for i in range(B)]
    torch.cuda.synchronize()
    row["bitwise_repeatable"] = all(
        bool(torch.equal(a, b)) for a, b in zip((X, res), again))
    row["members_bitwise_single_launch"] = all(
        bool(torch.equal(X[i], s[0]) and torch.equal(res[i], s[1]))
        for i, s in enumerate(singles))
    row["max_abs_err"] = _max_abs(X, Xp)
    row["lim_X"] = TOL_F32 * float(Xp.abs().max())
    row["resid"] = res.tolist()
    row["resid_plain"] = resp.tolist()
    same_class = bool(((res < K4_FALLBACK) == (resp < K4_FALLBACK)).all())
    row["ok"] = (row["max_abs_err"] <= row["lim_X"] and same_class
                 and row["bitwise_repeatable"]
                 and row["members_bitwise_single_launch"])
    row["ms"] = cuda_time_ms(lambda: ninv_chain_batched(S, iters))
    row["single_loop_ms"] = cuda_time_ms(
        lambda: [ninv_chain(s, iters) for s in S], warmup=1, iters=10)
    row["plain_ms"] = cuda_time_ms(lambda: ninv_chain_plain(S, iters),
                                   warmup=1, iters=3)
    row["library_ms"] = cuda_time_ms(lambda: torch.linalg.inv(S))
    row.update(ninv_chain_batched_bound(B, r, iters))
    return row


def k2_stack(B: int, m: int, w: int, gen: torch.Generator,
             dev: torch.device) -> torch.Tensor:
    return torch.rand((B, m, w), generator=gen, device=dev) - 0.5


def serial_rows(stacks: dict) -> dict:
    """Each K2 stack (name -> (Pg, r, bf16)) on the default build and on
    the serial build (``-DMPBQR_GROUP_SERIAL``) in one process: both times
    (CUDA events, median of 20) and whether the outputs agree bit for
    bit."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import _launch_group
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    out = {}
    with _build.instrumented_library("-DMPBQR_GROUP_SERIAL") as serial:
        for name, (Pg, r, bf) in stacks.items():
            robust = (False,) * (len(K2_ITERS) - 1) + (True,)
            args = (Pg, r, K2_ITERS, robust, bf, bf, bf)
            a = _launch_group(_build.library(), *args)
            c = _launch_group(serial, *args)
            torch.cuda.synchronize()
            out[name] = {
                "serial_equal": all(bool(torch.equal(x, y))
                                    for x, y in zip(a, c)),
                "streams_ms": cuda_time_ms(
                    lambda: _launch_group(_build.library(), *args)),
                "serial_ms": cuda_time_ms(lambda: _launch_group(serial,
                                                                *args))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serial", action="store_true")
    ap.add_argument("--k2", action="store_true",
                    help="the K2 stacks alone")
    ap.add_argument("--products", action="store_true",
                    help="the stack route's products alone, then stop")
    ap.add_argument("--timeline", action="store_true",
                    help="each K2 stack's device spans of one call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("batched_probe: no CUDA device", file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
    from mixedprecisionblockqr_tpu_torch.utils.group_probe import _smi

    print(_smi("name,power.limit"), flush=True)
    _build.library()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(23)
    ok = True
    if args.products:
        for row in stack_product_rows(gen, dev):
            ok = ok and row["ok"]
            print(json.dumps(row), flush=True)
        print(json.dumps({"ok": ok}), flush=True)
        return 0 if ok else 1
    for name, B, r, kind, kw in () if args.k2 else K1_CASES:
        row = k1_batched_row(k1_stack(kind, B, r, gen, dev), kw)
        ok = ok and row["ok"]
        print(json.dumps({"k1": name, **row}), flush=True)
    stacks = {}
    for name, B, m, r, g, bf in K2_CASES:
        Pg = k2_stack(B, m, g * r, gen, dev)
        stacks[name] = (Pg, r, bf)
        row = k2_batched_row(Pg, r, bf, spans_out=args.timeline)
        ok = ok and row["ok"]
        print(json.dumps({"k2": name, **row}), flush=True)
    for name, B, m, r, it in () if args.k2 else K4_CASES:
        row = k4_batched_row(k4_stack(B, m, r, gen, dev), it)
        ok = ok and row["ok"]
        print(json.dumps({"k4": name, **row}), flush=True)
    if args.serial:
        rows = serial_rows(stacks)
        ok = ok and all(row["serial_equal"] for row in rows.values())
        print(json.dumps({"serial": rows}), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
