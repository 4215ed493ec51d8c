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
With ``--batched`` it times K6's batched entry alone instead, on the
stacks of :data:`BATCH_SHAPES` (:func:`k6_batched_row`: against the
batched plain version, each member bit for bit against a single launch
at the batch's layout, beside the loop of single calls and
``torch.geqrf`` of the stack), and for each stack of at most 128 columns
the batched launch under both candidate layouts of ``batched_layout``
(``panel_layout``'s 128 rows a CTA, ``fewest_layout``'s fewest CTAs in
shared memory), the rule's and the most CTAs a member whose B clusters
the card keeps resident at once (one wave), each with its waves: the
batch's clusters over the clusters the card keeps resident at once.
The first line is the card's name and power limit (nvidia-smi).
``chip_smoke.py`` phases 3 and 24 run the same rows through :func:`k6_row`,
phase 3 the stacks through :func:`k6_batched_row`.

With ``--phases``, the kernel library is built a second time with
``-DMPBQR_PANEL_PROF`` (``_build.instrumented_library``); one more launch
per panel from it gives a line per panel: the microseconds that CTA 0's
last thread (column 127, live on every column) spent in each phase
(summed over the columns; the T build after the loop), at the SM clock
that ``nvidia-smi`` reads beside it, each phase's share, and every CTA's
microseconds.  It
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
#: 2048 rows), 342 (12 x 342 at 4096) and 428 (the most a CTA holds).
ROWS_TARGETS = (128, 256, 342, 428)
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


def k6_batched_row(P: torch.Tensor) -> dict:
    """K6's batched entry on the (B, m, w) stack ``P`` against
    ``panel_factor_fused_batched_plain``: layout and waves, per-output
    error and limit (V, T and R's upper triangle within ``TOL`` *
    max|plain|), two batched calls bitwise equal, each member bit for bit
    a single launch at the batch's layout (the single entry,
    ``mpbqr_panel_factor`` or ``mpbqr_panel_factor_wide``, with the same
    plan), and times (CUDA events, median of 20; the plain version's of
    3): the batched call, the loop of single ``panel_factor_fused`` calls,
    ``torch.geqrf`` of the stack; the bounds.  Counts
    nothing on the main paths' counters that a caller keeps: they are set
    to 0 before each path."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        MAX_WIDTH,
        _launch,
        _launch_wide,
        batched_layout,
        max_cluster,
        panel_factor_fused,
        panel_factor_fused_batched,
        panel_factor_fused_batched_plain,
        resident_clusters,
        wide_batched_layout,
    )
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        panel_factor_batched_bound,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    B, m, w = P.shape
    lib, mc = library(), max_cluster(P.device)
    if w <= MAX_WIDTH:
        lay = batched_layout(B, m, w, mc)
        steps = [lay]
        row = {"shape": [B, m, w], "cluster": lay.cluster, "rows": lay.rows,
               "route": _route(lay)}

        def single(x):
            return _launch(lib, x, lay)
    else:
        wl = wide_batched_layout(B, m, w, mc)
        steps = [st.panel for st in wl.steps]
        row = {"shape": [B, m, w], "route": "wide", "sub": wl.sub,
               "cluster": max(st.cluster for st in steps),
               "sub_panels": [f"{c}:{e} {st.panel.cluster}x{st.panel.rows} "
                              f"{_route(st.panel)}"
                              for st in wl.steps for c, e in (st.cols,)]}

        def single(x):
            return _launch_wide(lib, x, wl)
    row["waves"] = [-(-B // max(1, resident_clusters(P.device, st)))
                    for st in steps]
    V, T, R = panel_factor_fused_batched(P)
    V2, T2, R2 = panel_factor_fused_batched(P)
    Vp, Tp, Rp = panel_factor_fused_batched_plain(P)
    torch.cuda.synchronize()
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
    row["plain_ms"] = cuda_time_ms(
        lambda: panel_factor_fused_batched_plain(P), warmup=1, iters=3)
    row["library_ms"] = cuda_time_ms(lambda: torch.geqrf(P))
    row.update(panel_factor_batched_bound(B, m, w))
    return row


def batched_layout_times(P: torch.Tensor) -> dict:
    """The batched launch on the (B, m, w) stack ``P`` (at most 128
    columns; CUDA events, median of 20) under ``batched_layout``'s two
    candidates, the rule's and ``one_wave`` (the most CTAs a member, from
    the rule's down to the fewest, at which the card keeps all B clusters
    resident at once; absent when none does), keyed ``"<candidate>
    <cluster>x<rows>_<route>"``, each with its waves."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        PanelLayout,
        _launch,
        _smem_bytes,
        batched_layout,
        fewest_layout,
        max_cluster,
        panel_layout,
        resident_clusters,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    B, m, w = P.shape
    lib, mc = library(), max_cluster(P.device)
    rule, fewest = batched_layout(B, m, w, mc), fewest_layout(m, w, mc)
    candidates = [("panel_layout", panel_layout(m, w, mc)),
                  ("fewest", fewest), ("rule", rule)]
    if rule.in_smem:
        for cluster in range(rule.cluster, fewest.cluster - 1, -1):
            rows = -(-m // cluster)
            lay = PanelLayout(cluster, rows, True, _smem_bytes(w, rows, True))
            if resident_clusters(P.device, lay) >= B:
                candidates.append(("one_wave", lay))
                break
    out = {}
    for name, lay in candidates:
        res = resident_clusters(P.device, lay)
        out[f"{name} {lay.cluster}x{lay.rows}_{_route(lay)}"] = {
            "ms": cuda_time_ms(lambda lay=lay: _launch(lib, P, lay)),
            "resident_clusters": res, "waves": -(-B // max(1, res))}
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
#: CTA's last thread sees them: the first cluster barrier (the wait for every row
#: group's pushed norm partial), the scalars and w, the dot pass, the dot
#: push and the second barrier, the update (with the norm push), the
#: outputs' write (after the loop) and the T build.
PHASES = {"norm_exchange": 0, "wv": 1, "dot_pass": 2,
          "dot_exchange": 3, "update": 4, "outputs": 5, "t_build": 6}


def _phases(lib, P: torch.Tensor, mhz: float) -> dict:
    import numpy as np

    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        _launch,
        max_cluster,
        panel_layout,
    )

    lay = panel_layout(*P.shape, max_cluster(P.device))
    _launch(lib, P, lay)
    torch.cuda.synchronize()
    prof = np.zeros((16, 8), np.int64)
    check(lib.mpbqr_panel_prof(prof.ctypes.data), "panel_prof")
    us = {name: float(prof[0][k]) / mhz for name, k in PHASES.items()}
    total = sum(us.values())
    return {"cluster": lay.cluster, "rows": lay.rows, "cta0_us": us,
            "share": {k: v / total for k, v in us.items()},
            "per_cta_us": {name: [round(float(p[k]) / mhz, 1)
                                  for p in prof[:lay.cluster]]
                           for name, k in PHASES.items()}}


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
        with _build.instrumented_library("-DMPBQR_PANEL_PROF",
                                         "mpbqr_panel_prof", 1) as prof:
            for name, P in panels.items():
                mhz = _sm_mhz()
                print(json.dumps({"panel": name, "sm_mhz": mhz,
                                  **_phases(prof, P, mhz)}), flush=True)
    return 0 if ok else 1


def _main_batched(dev: torch.device) -> int:
    """``--batched``: a :func:`k6_batched_row` line per stack of
    :data:`BATCH_SHAPES` and, up to 128 columns, a line of
    :func:`batched_layout_times`."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import MAX_WIDTH

    gen = torch.Generator(device=dev).manual_seed(21)
    ok = True
    for B, m, w in BATCH_SHAPES:
        P = torch.rand((B, m, w), generator=gen, device=dev) - 0.5
        name = f"{B}x{m}x{w}"
        row = k6_batched_row(P)
        ok = ok and row["ok"]
        print(json.dumps({"stack": name, **row}), flush=True)
        if w <= MAX_WIDTH:
            print(json.dumps({"stack": name,
                              "layouts": batched_layout_times(P)}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
