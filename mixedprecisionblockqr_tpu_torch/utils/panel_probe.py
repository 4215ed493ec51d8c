"""K6 ``panel_factor_fused`` alone on the card, against its plain version
and ``torch.geqrf``.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.panel_probe [--phases]
        [--wide-only] [--batched]

Builds (or loads) the kernel library, then for each panel of
:data:`PROBE_SHAPES` (uniform in [-0.5, 0.5), seeded) prints one JSON line
from :func:`k6_row`: the layout (cluster, rows, route), whether V, T and R
are within 1e-4 of max|plain| and two launches agree bit for bit, the
kernel's, the plain version's and ``torch.geqrf``'s times (CUDA events,
median of 20; the plain version's median of 3), and the bounds.  A second
line per panel times the kernel at the other candidate layouts
(``rows_target`` of :data:`ROWS_TARGETS`, launched through the same C entry).
The panels of :data:`WIDE_SHAPES` (w > 128) take the wide route: their
:func:`k6_row` names each sub-panel's layout, and a second line
(:func:`wide_times`) times the route at sub-panels of each width in
:data:`WIDE_SUBS` and the staging copies of ``WIDE_SUB`` alone (what
giving K6 a row stride instead could save at most).  ``--wide-only``
skips the 128-wide panels.
With ``--batched`` it times K6's batched entry alone instead: first the
card's resident cluster counts (:func:`resident_table`), then on the
stacks of :data:`BATCH_SHAPES` (:func:`k6_batched_row`: against the
batched plain version, each member bit for bit against a single launch
at the batch's layout, with the resident clusters and waves, beside the
loop of single calls and ``torch.geqrf`` of the stack); for each stack
of at most 128 columns the batched launch at every candidate layout of
``batched_layout`` with its waves (the batch's clusters over the
clusters the card keeps resident at once) and which one the rule, the
shapes-only rule it replaced and ``one_wave`` pick
(:func:`batched_layout_times`); for each wider stack the route's K6
launches and products timed apart, under the batch-wide and the
per-member product tiles (:func:`wide_products_times`).  Then, for each
main path of :func:`_paths` (tsqr, refine, the batched solve and
``block_qr_batched``), the batched shapes it lays out and a
:func:`batched_layout_times` line for each one not timed yet.
The first line is the card's name and power limit (nvidia-smi).
``chip_smoke.py`` phases 3 and 24 run the same rows through :func:`k6_row`,
phase 3 the stacks through :func:`k6_batched_row`.

With ``--phases``, ``panel_factor.cu`` is built alone a second time with
``-DMPBQR_PANEL_PROF`` (:data:`PROF_BUILD`, ``_build.instrumented_library``);
one launch from it on each panel of :data:`PHASE_PANELS` gives a line
(:func:`phase_row`): the microseconds that CTA 0's last thread spent in
each slot of :data:`PHASES` (summed over the columns; the outputs and T
build after the loop), at the SM clock that ``nvidia-smi`` reads beside
it, each slot's share, every CTA's microseconds, and whether the clock
build's outputs equal the library's bit for bit.  ``--parent-slots`` names
the slots by :data:`PARENT_PHASES`, for another tree's build run with this
file (``PYTHONPATH=<tree> python3 -P .../panel_probe.py --phases
--parent-slots``).  It
needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

#: Panel heights at w = 128: lstsq's panels (4096 down to 2176 rows in its
#: first stage, 2048 and below in its second), and the in-place route.
PROBE_SHAPES = ((2048, 128), (4096, 128), (3072, 128), (2176, 128),
                (8192, 128))
#: Rows per CTA the layout may aim at: 128 and 256 (16 x 128 and 8 x 256 at
#: 2048 rows), 342 (12 x 342 at 4096) and 405 (the most a CTA holds).
ROWS_TARGETS = (128, 256, 342, 405)
#: Wide-route panels: the 'householder' tiers at block 256 and 2000^2 at
#: 200, 512 columns, in-place sub-panels (8192 rows), lstsq(method='tsqr')'s
#: one 4096 x 2048 leaf.
WIDE_SHAPES = ((2048, 256), (2000, 200), (4096, 512), (8192, 256),
               (4096, 2048))
#: Batched stacks (B, m, w): tsqr 100000 x 64's leaves and its first tree
#: level, the refine lstsq's first CAQR panel's leaves (8 of 512 x 128),
#: tsqr 65536 x 256's leaves (wide route) and a smaller wide batch.
BATCH_SHAPES = ((64, 1563, 64), (32, 128, 64), (8, 512, 128),
                (64, 1024, 256), (4, 1024, 256),
                # the first and last panel steps of the batched drivers on
                # 8 x 2048 x 512 (lstsq_batched, block_qr_batched)
                (8, 2048, 128), (8, 1664, 128))
#: Sub-panel widths the wide route is timed at.
WIDE_SUBS = (64, 128)
TOL = 1e-4  # fp32 summation order only


def _finite_err(a: torch.Tensor, b: torch.Tensor):
    """max|a - b| and max|b| over the entries finite in both."""
    keep = torch.isfinite(a) & torch.isfinite(b)
    if not bool(keep.any()):
        return 0.0, 0.0
    return (float((a - b)[keep].abs().max()), float(b[keep].abs().max()))


def k6_row(P: torch.Tensor, nan_input: bool = False) -> dict:
    """K6 on ``P`` against the plain version: layout, per-output error and
    limit, bitwise repeat, times and bounds.  ``ok`` holds when V, T and
    R's upper triangle are within ``TOL`` * max|plain| over the entries
    finite in both, two launches agree bit for bit, and either every
    output is finite or (``nan_input``) the NaN reaches R in the plain
    version's places."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        panel_factor_fused,
        panel_factor_fused_plain,
    )
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        panel_factor_bound,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    m, w = P.shape
    row = {"shape": [m, w], **layout_fields(m, w, P.device)}
    V, T, R = panel_factor_fused(P)
    V2, T2, R2 = panel_factor_fused(P)
    Vp, Tp, Rp = panel_factor_fused_plain(P)
    torch.cuda.synchronize()
    Rp = torch.triu(Rp)
    ok = all(bool(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
             for a, b in ((V, V2), (T, T2), (R, R2)))
    row["bitwise_repeatable"] = ok
    for key, a, b in (("V", V, Vp), ("T", T, Tp), ("R", R, Rp)):
        e, mx = _finite_err(a, b)
        row[f"max_abs_{key}"], row[f"lim_{key}"] = e, TOL * mx
        ok = ok and e <= TOL * mx
    row["nan_in_R"] = bool(torch.isnan(R).any())
    if nan_input:
        ok = ok and row["nan_in_R"] and bool(
            torch.equal(torch.isnan(R), torch.isnan(Rp)))
    else:
        ok = ok and all(bool(torch.isfinite(x).all()) for x in (V, T, R))
    row["ok"] = ok
    row["ms"] = cuda_time_ms(lambda: panel_factor_fused(P))
    row["plain_ms"] = cuda_time_ms(lambda: panel_factor_fused_plain(P),
                                   warmup=1, iters=3)
    row["library_ms"] = cuda_time_ms(lambda: torch.geqrf(P))
    row.update(panel_factor_bound(m, w, row["cluster"]))
    return row


def k6_batched_row(P: torch.Tensor, plain_iters: int = 3) -> dict:
    """K6's batched entry on the (B, m, w) stack ``P`` against
    ``panel_factor_fused_batched_plain``: layout, the clusters the card
    keeps resident and the waves (each sub-panel's on the wide route, with
    its product launches a call), per-output error and limit (V, T and R's
    upper triangle within ``TOL`` * max|plain|), two batched calls bitwise
    equal, each member bit for bit a single launch at the batch's layout
    (the single entry, ``mpbqr_panel_factor`` or
    ``mpbqr_panel_factor_wide``, with the same plan), and times (CUDA
    events, median of 20): the batched call, the loop of single
    ``panel_factor_fused`` calls (median of 5), ``torch.geqrf`` of the
    stack, the plain version (median of ``plain_iters``; 0: the one call
    that the error check makes); the bounds.  Counts nothing on the main
    paths' counters that a caller keeps: they are set to 0 before each
    path."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        MAX_WIDTH,
        _launch,
        _launch_wide,
        batched_layout,
        card_resident,
        max_cluster,
        panel_factor_fused,
        panel_factor_fused_batched,
        panel_factor_fused_batched_plain,
        wide_batched_layout,
    )
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        panel_factor_batched_bound,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    B, m, w = P.shape
    lib, mc = library(), max_cluster(P.device)
    resident = card_resident(P.device)
    if w <= MAX_WIDTH:
        lay = batched_layout(B, m, w, resident, mc)
        steps = [lay]
        row = {"shape": [B, m, w], "cluster": lay.cluster, "rows": lay.rows,
               "route": _route(lay)}

        def single(x):
            return _launch(lib, x, lay)
    else:
        wl = wide_batched_layout(B, m, w, resident, mc)
        steps = [st.panel for st in wl.steps]
        row = {"shape": [B, m, w], "route": "wide", "sub": wl.sub,
               "cluster": max(st.cluster for st in steps),
               "sub_panels": [f"{c}:{e} {st.panel.cluster}x{st.panel.rows} "
                              f"{_route(st.panel)}"
                              for st in wl.steps for c, e in (st.cols,)],
               "products": wl.products()}

        def single(x):
            return _launch_wide(lib, x, wl)
    row["resident_clusters"] = [resident(st) for st in steps]
    row["waves"] = [-(-B // n) for n in row["resident_clusters"]]
    V, T, R = panel_factor_fused_batched(P)
    V2, T2, R2 = panel_factor_fused_batched(P)
    (Vp, Tp, Rp), first_plain_ms = _timed(
        lambda: panel_factor_fused_batched_plain(P))
    Rp = torch.triu(Rp)
    ok = all(bool(torch.equal(a, b)) for a, b in ((V, V2), (T, T2), (R, R2)))
    row["bitwise_repeatable"] = ok
    same = all(bool(torch.equal(a[i], b))
               for i in range(B)
               for a, b in zip((V, T, R), single(P[i].contiguous())))
    row["members_bitwise_single_launch"] = same
    ok = ok and same
    for key, a, b in (("V", V, Vp), ("T", T, Tp), ("R", R, Rp)):
        e, mx = _finite_err(a, b)
        row[f"max_abs_{key}"], row[f"lim_{key}"] = e, TOL * mx
        ok = ok and e <= TOL * mx
    row["ok"] = ok and all(bool(torch.isfinite(x).all()) for x in (V, T, R))
    row["ms"] = cuda_time_ms(lambda: panel_factor_fused_batched(P))
    row["single_loop_ms"] = cuda_time_ms(
        lambda: [panel_factor_fused(p) for p in P], warmup=1, iters=5)
    row["plain_ms"] = (cuda_time_ms(
        lambda: panel_factor_fused_batched_plain(P), warmup=1,
        iters=plain_iters) if plain_iters else first_plain_ms)
    row["library_ms"] = cuda_time_ms(lambda: torch.geqrf(P))
    row.update(panel_factor_batched_bound(B, m, w, resident, mc))
    return row


def _timed(fn):
    """``(fn(), its ms)``: one call between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


#: The CTAs an H100 SXM has: the shapes-only rule that batched_layout
#: followed before it read the card's resident clusters.
_CARD_SMS = 132


def shapes_only_layout(B: int, m: int, w: int, max_cluster: int):
    """The batched layout by shapes alone, as ``batched_layout`` chose it
    before it read the card (kept here to time beside it):
    ``panel_layout``'s while its B clusters fit 132 CTAs, else ``132 //
    B`` CTAs a member, no fewer than ``fewest_layout``'s."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        PanelLayout,
        _smem_bytes,
        fewest_layout,
        panel_layout,
    )

    lay = panel_layout(m, w, max_cluster)
    if B * lay.cluster <= _CARD_SMS or not lay.in_smem:
        return lay
    cluster = min(lay.cluster, max(fewest_layout(m, w, max_cluster).cluster,
                                   _CARD_SMS // B))
    rows = -(-m // cluster)
    return PanelLayout(cluster, rows, True, _smem_bytes(w, rows, True))


def batched_layout_times(P: torch.Tensor) -> dict:
    """The batched launch on the (B, m, w) stack ``P`` (at most 128
    columns; CUDA events, median of 20) at every candidate of
    ``batched_layout``: the in-shared-memory layouts from
    ``panel_layout``'s cluster down to ``fewest_layout``'s (or
    ``panel_layout``'s in-place one alone), each with the clusters the card
    keeps resident and its waves, keyed by its CTAs a member; then which
    cluster the rule (``rule``), the shapes-only rule it replaced
    (``shapes_only``), ``one_wave`` (the most CTAs a member whose B
    clusters are all resident at once; absent when none) and the fastest
    candidate picked, and the rule's time over the fastest's."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        PanelLayout,
        _launch,
        _smem_bytes,
        batched_layout,
        card_resident,
        fewest_layout,
        max_cluster,
        panel_layout,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    B, m, w = P.shape
    lib, mc = library(), max_cluster(P.device)
    resident = card_resident(P.device)
    top = panel_layout(m, w, mc)
    cands = [top]
    if top.in_smem:
        cands += [PanelLayout(c, -(-m // c), True,
                              _smem_bytes(w, -(-m // c), True))
                  for c in range(top.cluster - 1,
                                 fewest_layout(m, w, mc).cluster - 1, -1)]
    times = {}
    for lay in cands:
        n = resident(lay)
        times[lay.cluster] = {
            "rows": lay.rows, "route": _route(lay), "resident_clusters": n,
            "waves": -(-B // n),
            "ms": cuda_time_ms(lambda lay=lay: _launch(lib, P, lay))}
    fastest = min(times, key=lambda c: times[c]["ms"])
    rule = batched_layout(B, m, w, resident, mc).cluster
    out = {"candidates": times, "rule": rule,
           "shapes_only": shapes_only_layout(B, m, w, mc).cluster,
           "fastest": fastest,
           "rule_over_fastest": times[rule]["ms"] / times[fastest]["ms"]}
    one = [c for c in times if times[c]["waves"] == 1]
    if one:
        out["one_wave"] = max(one)
    return out


def wide_products_times(P: torch.Tensor) -> dict:
    """The wide route on the (B, m, w) stack ``P`` (w > 128) under two
    plans that differ only in the products' splits and tiles: ``batch``
    (``wide_batched_layout``'s, from the B members' tiles together) and
    ``per_member`` (each product laid out as for one member, as the route
    laid them out before it issued each product once for the B members).
    For each: the call's time (CUDA events, median of 20) and, from
    ``torch.profiler`` over one call, the device ms and count of its K6
    launches and of its products (``gemm_tn`` / ``gemm_nt``) apart."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        _launch_wide,
        card_resident,
        max_cluster,
        wide_batched_layout,
        wide_layout,
    )
    from mixedprecisionblockqr_tpu_torch.utils.group_probe import (
        device_breakdown,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    B, m, w = P.shape
    lib, mc = library(), max_cluster(P.device)
    lay = wide_batched_layout(B, m, w, card_resident(P.device), mc)
    one = wide_layout(m, w, mc)
    plans = {"batch": lay, "per_member": lay._replace(steps=tuple(
        st._replace(update=s1.update, merge=s1.merge)
        for st, s1 in zip(lay.steps, one.steps)))}
    out = {}
    for name, plan in plans.items():
        def call(plan=plan):
            return _launch_wide(lib, P, plan)

        kernels = device_breakdown(call, calls=2)["kernels"]
        row = {"plan": [st.args() for st in plan.steps],
               "ms": cuda_time_ms(call)}
        for part, keys in (("k6", ("panel_factor_kernel",)),
                           ("products", ("gemm_tn", "gemm_nt"))):
            hits = [v for k, v in kernels.items()
                    if any(x in k for x in keys)]
            row[f"{part}_device_ms"] = sum(v["ms"] for v in hits)
            row[f"{part}_launches"] = sum(v["count"] for v in hits)
        out[name] = row
    return out


#: Dynamic shared memory (bytes a CTA) at which :func:`resident_table`
#: asks the card: 128 rows of 64 / 128 columns, the two-a-SM edge, and
#: the most a CTA may use.
RESIDENT_SMEM = (44944, 77840, 100000, 113000, 116000, 150000, 232448)


def resident_table(device: torch.device) -> dict:
    """The clusters of 1 to 16 CTAs (in shared memory) that the card keeps
    resident at once at each size of :data:`RESIDENT_SMEM`, keyed
    ``"<smem>"`` then ``"<cluster>"`` (0 where the query raises)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        PanelLayout,
        resident_clusters,
    )

    def count(c, smem):
        try:
            return resident_clusters(device, PanelLayout(c, 128, True, smem))
        except RuntimeError:  # none resident, or the query refused
            return 0

    return {str(smem): {str(c): count(c, smem) for c in range(1, 17)}
            for smem in RESIDENT_SMEM}


def record_layouts(fn) -> list:
    """The batched K6 shapes ``(B, m, w)`` (up to 128 columns; a wide
    call's sub-panels) that one call of ``fn`` lays out, in the order first
    seen: ``panel.batched_layout`` and ``panel.wide_batched_layout`` are
    wrapped for the call, so nothing else changes."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import panel

    seen = []
    narrow, wide = panel.batched_layout, panel.wide_batched_layout

    def note(shape):
        if shape not in seen:
            seen.append(shape)

    def batched_layout(B, m, w, *args, **kw):
        note((B, m, w))
        return narrow(B, m, w, *args, **kw)

    def wide_batched_layout(B, m, w, *args, **kw):
        lay = wide(B, m, w, *args, **kw)
        for c, e in (st.cols for st in lay.steps):
            note((B, m - c, e - c))
        return lay

    panel.batched_layout = batched_layout
    panel.wide_batched_layout = wide_batched_layout
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        panel.batched_layout, panel.wide_batched_layout = narrow, wide
    return seen


def layouts_of(fn, device: torch.device) -> list:
    """For each batched K6 shape one call of ``fn`` lays out
    (:func:`record_layouts`): ``"BxMxW"``, the layout (CTAs x rows and
    route), the clusters the card keeps resident and the waves."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        batched_layout,
        card_resident,
        max_cluster,
    )

    resident, mc = card_resident(device), max_cluster(device)
    out = []
    for B, m, w in record_layouts(fn):
        lay = batched_layout(B, m, w, resident, mc)
        n = resident(lay)
        out.append({"shape": f"{B}x{m}x{w}",
                    "layout": f"{lay.cluster}x{lay.rows} {_route(lay)}",
                    "resident_clusters": n, "waves": -(-B // n)})
    return out


def _route(lay) -> str:
    return "smem" if lay.in_smem else "in_place"


def layout_fields(m: int, w: int, device: torch.device) -> dict:
    """K6's layout of an m x w panel on the card of ``device``: up to 128
    columns its cluster, rows per CTA and route; wider, ``route`` 'wide',
    the sub-panel width, each sub-panel's ``"c:e clusterxrows route"``,
    the product launches and (as ``cluster``) the largest sub-panel
    cluster."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        MAX_WIDTH,
        max_cluster,
        panel_layout,
        wide_layout,
    )

    mc = max_cluster(device)
    if w <= MAX_WIDTH:
        lay = panel_layout(m, w, mc)
        return {"cluster": lay.cluster, "rows": lay.rows,
                "route": _route(lay)}
    lay = wide_layout(m, w, mc)
    return {"route": "wide", "sub": lay.sub,
            "cluster": max(st.panel.cluster for st in lay.steps),
            "sub_panels": [f"{c}:{e} {st.panel.cluster}x{st.panel.rows} "
                           f"{_route(st.panel)}"
                           for st in lay.steps for c, e in (st.cols,)],
            "products": lay.products()}


def wide_times(P: torch.Tensor) -> dict:
    """The wide route on ``P`` (CUDA events, median of 20) at sub-panels of
    each width in :data:`WIDE_SUBS`, keyed ``"sub<width>_ms"`` (launched
    through the same C entry, uncounted), and ``staging_ms``: the copies
    the route makes at ``WIDE_SUB`` alone (each sub-panel staged into a
    contiguous buffer, its V and R copied back, its T block), as strided
    ``copy_`` on the same shapes."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        WIDE_SUB,
        _launch_wide,
        max_cluster,
        wide_layout,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    lib, (m, w) = library(), P.shape
    out = {f"sub{sub}_ms": cuda_time_ms(lambda sub=sub: _launch_wide(
        lib, P, wide_layout(m, w, max_cluster(P.device), sub)))
        for sub in WIDE_SUBS}
    R, V, T = P.clone(), torch.zeros_like(P), P.new_zeros((w, w))
    bufs = [torch.empty((m - c) * min(WIDE_SUB, w - c), device=P.device)
            for c in range(0, w, WIDE_SUB)]

    def staging():
        for c, buf in zip(range(0, w, WIDE_SUB), bufs):
            e = min(w, c + WIDE_SUB)
            Ps = buf.view(m - c, e - c)
            Ps.copy_(R[c:, c:e])
            R[c:, c:e].copy_(Ps)
            V[c:, c:e].copy_(Ps)
            T[c:e, c:e].copy_(Ps[:e - c])

    out["staging_ms"] = cuda_time_ms(staging)
    return out


def layout_times(P: torch.Tensor) -> dict:
    """The kernel's time (CUDA events, median of 20) at each distinct
    layout of :data:`ROWS_TARGETS`, keyed ``"<cluster>x<rows>_<route>"``."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        _launch,
        max_cluster,
        panel_layout,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    lib, out = library(), {}
    for target in ROWS_TARGETS:
        lay = panel_layout(*P.shape, max_cluster(P.device), target)
        name = (f"{lay.cluster}x{lay.rows}_"
                f"{'smem' if lay.in_smem else 'in_place'}")
        if name not in out:
            out[name] = cuda_time_ms(lambda: _launch(lib, P, lay))
    return out


#: Slots of the kernel's phase clocks (csrc/panel_factor.cu, PROF), as a
#: CTA's last thread sees them, summed over the columns: the exchange (the
#: one cluster barrier a column, the wait for every CTA's pushed partial
#: dots and pivot row), the scalars and dots (with G's column), the x'
#: sub-pass (the reflector and the next column, then a CTA barrier), the
#: fused pass (update, V, the next column's partial dots, then a CTA
#: barrier), the push, and after the loop the outputs' write and the T
#: build.  The prologue (column 0's dots) falls in the last three of the
#: loop's slots.
PHASES = {"exchange": 0, "scalars": 1, "x_subpass": 2, "fused_pass": 3,
          "push": 4, "outputs": 5, "t_build": 6}
#: The slots of the loop before it (two cluster barriers a column), to
#: read a tree of that loop with ``--parent-slots`` (which builds every
#: source: such a tree's ``_build`` cannot build ``panel_factor.cu``
#: alone).
PARENT_PHASES = {"norm_exchange": 0, "wv": 1, "dot_pass": 2,
                 "dot_exchange": 3, "update": 4, "outputs": 5, "t_build": 6}
#: The clock build: panel_factor.cu alone with -DMPBQR_PANEL_PROF, and its
#: entry that copies the 16 x 8 clocks out (``_build.instrumented_library``).
PROF_BUILD = ("-DMPBQR_PANEL_PROF", "mpbqr_panel_prof", 1,
              ("panel_factor.cu",))

#: Panels the clock reads: the single launches (lstsq's 2048 and 4096 x
#: 128, the in-place 8192 x 128, the cholqr hybrid's 208 x 128 tail) and
#: the batched solve's first panel step, 8 x 2048 x 128, whose clocks are
#: those of one member (every member's cluster writes the same slots).
PHASE_PANELS = ((2048, 128), (4096, 128), (8192, 128), (208, 128),
                (8, 2048, 128))


def phase_row(lib, P: torch.Tensor, mhz: float, phases=None) -> dict:
    """One launch of the clock build ``lib`` on the panel or stack ``P``
    at the layout the main path gives it: CTA 0's microseconds by slot of
    ``phases`` (:data:`PHASES` by default; summed over the columns) at
    ``mhz``, each slot's share, every CTA's microseconds, and whether V, T
    and R equal the library build's bit for bit (``same_as_library``)."""
    import numpy as np

    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check,
        library,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        _launch,
        batched_layout,
        card_resident,
        max_cluster,
        panel_layout,
    )

    mc = max_cluster(P.device)
    lay = (batched_layout(*P.shape, card_resident(P.device), mc)
           if P.dim() == 3 else panel_layout(*P.shape, mc))
    out = _launch(lib, P, lay)
    torch.cuda.synchronize()
    prof = np.zeros((16, 8), np.int64)
    check(lib.mpbqr_panel_prof(prof.ctypes.data), "panel_prof")
    same = all(bool(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
               for a, b in zip(out, _launch(library(), P, lay)))
    phases = phases or PHASES
    us = {name: float(prof[0][k]) / mhz for name, k in phases.items()}
    total = sum(us.values())
    return {"cluster": lay.cluster, "rows": lay.rows, "route": _route(lay),
            "sm_mhz": mhz, "cta0_us": us,
            "share": {k: v / total for k, v in us.items()},
            "per_cta_us": {name: [round(float(p[k]) / mhz, 1)
                                  for p in prof[:lay.cluster]]
                           for name, k in phases.items()},
            "same_as_library": same}


def _sm_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--wide-only", action="store_true")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--parent-slots", action="store_true",
                    help="name the clock's slots by PARENT_PHASES")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("panel_probe: no CUDA device", file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.library()
    dev = torch.device("cuda", 0)
    if args.batched:
        return _main_batched(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    panels = {f"{m}x{w}": torch.rand((m, w), generator=gen, device=dev) - 0.5
              for m, w in PROBE_SHAPES}
    if args.wide_only:
        panels = {}
    ok = True
    for name, P in panels.items():
        row = k6_row(P)
        ok = ok and row["ok"]
        print(json.dumps({"panel": name, **row}), flush=True)
        print(json.dumps({"panel": name, "layouts_ms": layout_times(P)}),
              flush=True)
    gen_w = torch.Generator(device=dev).manual_seed(24)
    for m, w in WIDE_SHAPES:
        P = torch.rand((m, w), generator=gen_w, device=dev) - 0.5
        row = k6_row(P)
        ok = ok and row["ok"]
        print(json.dumps({"panel": f"{m}x{w}", **row}), flush=True)
        print(json.dumps({"panel": f"{m}x{w}", **wide_times(P)}),
              flush=True)
    if args.phases:
        gen_p = torch.Generator(device=dev).manual_seed(30)
        phases, build = PHASES, PROF_BUILD
        if args.parent_slots:
            phases, build = PARENT_PHASES, PROF_BUILD[:3] + (_build.SOURCES,)
        with _build.instrumented_library(*build) as prof:
            for shape in PHASE_PANELS:
                P = torch.rand(shape, generator=gen_p, device=dev) - 0.5
                row = phase_row(prof, P, _sm_mhz(), phases)
                ok = ok and row["same_as_library"]
                print(json.dumps({"panel": "x".join(map(str, shape)),
                                  **row}), flush=True)
    return 0 if ok else 1


def _paths(dev: torch.device) -> dict:
    """The main paths that run K6's batched entry, on ``chip_smoke.py``'s
    inputs (phases 16, 17 and 24), as calls by name."""
    import numpy as np

    from mixedprecisionblockqr_tpu_torch import (
        POLICY_FP32,
        block_qr_batched,
        lstsq,
        lstsq_batched,
        tsqr,
    )
    from mixedprecisionblockqr_tpu_torch.utils.datagen import slam_jacobian

    rng = np.random.default_rng(0)
    A16 = torch.from_numpy(rng.random((100000, 64), dtype=np.float32)
                           - 0.5).to(dev)
    A24 = torch.from_numpy(rng.random((65536, 256), dtype=np.float32)
                           - 0.5).to(dev)
    J = torch.from_numpy(slam_jacobian(4096, 2048, seed=0)).to(dev)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(4096)
                         .astype(np.float32)).to(dev)
    Ab = torch.from_numpy(np.stack([slam_jacobian(2048, 512, seed=i)
                                    for i in range(8)])).to(dev)
    bb = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 2048)).astype(np.float32)).to(dev)
    return {"tsqr 100000x64": lambda: tsqr(A16),
            "tsqr 65536x256": lambda: tsqr(A24),
            "refine lstsq 4096x2048": lambda: lstsq(J, b, refine_steps=2),
            "lstsq_batched 8x2048x512": lambda: lstsq_batched(Ab, bb),
            "block_qr_batched 8x2048x512": lambda: block_qr_batched(
                Ab, 128, POLICY_FP32, panel_method="householder")}


def _main_batched(dev: torch.device) -> int:
    """``--batched``: a :func:`k6_batched_row` line per stack of
    :data:`BATCH_SHAPES` with, up to 128 columns, a line of
    :func:`batched_layout_times`, and above, one of
    :func:`wide_products_times`; then per main path of :func:`_paths` its
    batched shapes (:func:`layouts_of`) and a :func:`batched_layout_times`
    line for each shape of B > 1 not timed yet."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import MAX_WIDTH

    print(json.dumps({"resident_table": resident_table(dev)}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(21)
    ok, timed = True, set()
    for B, m, w in BATCH_SHAPES:
        P = torch.rand((B, m, w), generator=gen, device=dev) - 0.5
        name = f"{B}x{m}x{w}"
        row = k6_batched_row(P, plain_iters=0 if B * m * w > 4e6 else 3)
        ok = ok and row["ok"]
        print(json.dumps({"stack": name, **row}), flush=True)
        if w <= MAX_WIDTH:
            timed.add((B, m, w))
            print(json.dumps({"stack": name,
                              "layouts": batched_layout_times(P)}),
                  flush=True)
        else:
            print(json.dumps({"stack": name,
                              "wide_products": wide_products_times(P)}),
                  flush=True)
    for path, fn in _paths(dev).items():
        shapes = record_layouts(fn)
        print(json.dumps({"path": path, "layouts": layouts_of(fn, dev)}),
              flush=True)
        for B, m, w in shapes:
            if B > 1 and (B, m, w) not in timed:
                timed.add((B, m, w))
                P = torch.rand((B, m, w), generator=gen, device=dev) - 0.5
                print(json.dumps({"path": path, "stack": f"{B}x{m}x{w}",
                                  "layouts": batched_layout_times(P)}),
                      flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
