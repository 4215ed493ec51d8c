"""The chain kernels at panel widths other than 32, 64 and 128, on the card.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.width_probe [r ...]
    python3 -m mixedprecisionblockqr_tpu_torch.utils.width_probe --sweep [--headline] [r ...]

For each width (default 48, 100, 125, 192, 256) holds K1 (``ns_chain``),
K4 (``ninv_chain``), the R-block combine (``tri_combine``), K3
(``panel_qr_fused``), K2 (``bgs_group_fused``) and K5
(``bgs_group_fused_proj``) against their plain PyTorch versions with the
tolerances of their r = 128 rows in ``chip_smoke.py`` phase 3, launches
each twice and compares the bits, and prints one JSON line per kernel:
route and CTAs of its layout (``ops/kernels/ns.py``), error, time (CUDA
events only: many ``torch.profiler`` sessions in one process have come
back empty) beside the plain version, one library call and the bound
(``utils/bounds.py``).
``chip_smoke.py`` phase 3 calls :func:`width_rows` and, for K1, K4 and
the combine alone at the L2 route's edges (r = 129, 200, 512, 1024),
:func:`l2_edge_rows`.
``--sweep`` times
K1 and K4 instead at 0, 1, 2, 4 and 8 iterations (K1 also with
``chain_mid`` and ``refine``) at each width: the intercept is a launch's
setup and closing products, the slope one iteration; ``--headline``
adds the headline call's time (``block_qr`` 2048^2 at r = 128, phase 4's
input).  The sweep uses only entry points that older trees of the package
have too, so ``PYTHONPATH=<tree> python3 .../width_probe.py --sweep``
times another tree's kernels in the same process layout.  It needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

WIDTHS = (48, 100, 125, 192, 256)
#: K1, K4 and the combine alone at the L2 route's edges
#: (:func:`l2_edge_rows`): the narrowest width on it, a width of ragged
#: dealt tiles, and the widest two.
L2_EDGE_WIDTHS = (129, 200, 512, 1024)
#: The kernels :func:`l2_edge_rows` takes there: those with an L2 route.
L2_EDGE_KERNELS = ("ns_chain", "ninv_chain", "tri_combine")
TOL_F32 = 1e-4   # fp32 kernels vs plain: summation order only
TOL_BF16 = 5e-3  # bf16-rounded operands: a rounding may flip
#: K1's option combinations (chip_smoke.py phase 3): name -> (Gram, kwargs)
#: with the Gram one of 'well', 'ill' (condition ~1e6) or 'near_identity'.
K1_MODES = {
    "plain": ("well", dict(iters=10)),
    "shift": ("ill", dict(iters=14, shift=1e-3)),
    "shift_mid": ("ill", dict(iters=14, shift=1e-3, omega=False,
                              chain_mid=True)),
    "pass2_mid": ("well", dict(iters=12, omega=False, chain_mid=True)),
    "refine": ("near_identity", dict(iters=4, refine=True)),
    "chain_mid": ("well", dict(iters=6, chain_mid=True)),
    "chain_mid10": ("well", dict(iters=10, chain_mid=True)),
    "classic": ("well", dict(iters=10, fuse_xw=False)),
}


def _max_abs(a, b) -> float:
    return float((a - b).abs().max())


def _rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _same(xs, ys) -> bool:
    return all(bool(torch.equal(x, y)) for x, y in zip(xs, ys))


def _route(lay) -> dict:
    return {"route": lay.route, "ctas": lay.ctas, "inst": lay.inst}


def k1_row(r: int, gen: torch.Generator) -> dict:
    """K1 at width r in every option combination: X and t within 1e-4 of
    the plain version's scale, the same canary class, two launches
    bitwise equal; NaN in G gives a NaN residual."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
    from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32
    from mixedprecisionblockqr_tpu_torch.utils.bounds import ns_chain_bound
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    dev = gen.device
    P = torch.rand((2048, r), generator=gen, device=dev) - 0.5
    Pill = P * torch.logspace(0, -3, r, device=dev)
    Qn = mm_f32(P, ns.ns_chain_plain(mm_f32(P.T, P), iters=10)[0])
    grams = {"well": mm_f32(P.T, P), "ill": mm_f32(Pill.T, Pill),
             "near_identity": mm_f32(Qn.T, Qn)}
    grams = {k: v.contiguous() for k, v in grams.items()}
    rows, err, ok_all = {}, 0.0, True
    for name, (gname, kw) in K1_MODES.items():
        G = grams[gname]
        out = ns.ns_chain(G, **kw)
        again = ns.ns_chain(G, **kw)
        Xp, tp, resp = ns.ns_chain_plain(G, **kw)
        torch.cuda.synchronize()
        ex, et = _max_abs(out[0], Xp), _max_abs(out[1], tp)
        row = {"err_X": ex, "lim_X": TOL_F32 * float(Xp.abs().max()),
               "err_t": et, "lim_t": TOL_F32 * float(tp.abs().max()),
               "resid": float(out[2]), "resid_plain": float(resp),
               "bitwise_repeatable": _same(out, again)}
        row["ok"] = (ex <= row["lim_X"] and et <= row["lim_t"]
                     and row["bitwise_repeatable"]
                     and (row["resid"] < 1e-4) == (row["resid_plain"] < 1e-4))
        rows[name] = row
        err = max(err, ex, et)
        ok_all = ok_all and row["ok"]
    G = grams["well"]
    G_nan = G.clone()
    G_nan[3, 5] = float("nan")
    nan_resid = float(ns.ns_chain(G_nan, iters=6, chain_mid=True)[2])
    kw = K1_MODES["chain_mid"][1]
    lay = ns.ns_layout(r, ns._card_cluster(G, r))
    return {"kernel": "ns_chain", "r": r, **_route(lay), "modes": rows,
            "nan_resid": nan_resid, "max_abs_err": err,
            "ok": ok_all and nan_resid != nan_resid,
            "ms": cuda_time_ms(lambda: ns.ns_chain(G, **kw)),
            "plain_ms": cuda_time_ms(lambda: ns.ns_chain_plain(G, **kw),
                                     warmup=1, iters=5),
            "ms_mode": "chain_mid (6 iterations)",
            "library_call": "torch.linalg.cholesky(G)",
            "library_ms": cuda_time_ms(lambda: torch.linalg.cholesky(G)),
            **ns_chain_bound(r, 6, chain_mid=True)}


def k4_rows(r: int, gen: torch.Generator) -> dict:
    """K4 at width r on the Yamamoto S of a 4096 x r panel (5 iterations,
    the polar tier's) and of a 2r x r one (12), through
    ``ninv_probe.k4_row`` (X within 1e-4 of the plain version's scale, the
    same fallback class, two launches bitwise equal); NaN in S gives a NaN
    residual."""
    from mixedprecisionblockqr_tpu_torch.ops.cholqr import _sign_fix
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
    from mixedprecisionblockqr_tpu_torch.utils.ninv_probe import k4_row

    dev = gen.device

    def yamamoto_S(m):
        Qb, _ = torch.linalg.qr(
            torch.rand((m, r), generator=gen, device=dev) - 0.5)
        D = _sign_fix(Qb[:r])
        return (torch.eye(r, device=dev) - (Qb * D)[:r].T).contiguous()

    inputs = {"panel4096_it5": (yamamoto_S(4096), 5),
              f"panel{2 * r}_it12": (yamamoto_S(2 * r), 12)}
    rows = {name: k4_row(S, it, profiled=False)
            for name, (S, it) in inputs.items()}
    S_nan = inputs["panel4096_it5"][0].clone()
    S_nan[4, 9] = float("nan")
    nan_resid = float(ns.ninv_chain(S_nan, 5)[1])
    S = inputs["panel4096_it5"][0]
    return {"kernel": "ninv_chain", "r": r,
            **_route(ns.ninv_layout(r, ns._card_cluster(S, r))),
            "inputs": rows, "nan_resid": nan_resid,
            "max_abs_err": max(row["max_abs_X"] for row in rows.values()),
            "ok": all(row["ok"] for row in rows.values())
            and nan_resid != nan_resid}


def combine_row(r: int, gen: torch.Generator) -> dict:
    """The combine at width r on the t1, t2, t3 of a robust panel of a
    4096 x r panel (``ninv_probe.combine_row``: within 1e-4 of the plain
    version's scale, two launches bitwise equal)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
    from mixedprecisionblockqr_tpu_torch.utils import ninv_probe

    P = torch.rand((4096, r), generator=gen, device=gen.device) - 0.5
    row = ninv_probe.combine_row(*ns.robust_products(P), profiled=False)
    return {"kernel": "tri_combine", **row,
            **_route(ns.combine_layout(r, ns._card_cluster(P, r)))}


def k3_row(r: int, gen: torch.Generator) -> dict:
    """K3 at width r on a uniform 4096 x r panel in robust, plain
    10-iteration and robust chain_mid mode: max|dQ| <= 1e-4 max|Q|,
    ||dt|| / ||t|| <= 1e-4, the drivers' canary class, two launches
    bitwise equal."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
    from mixedprecisionblockqr_tpu_torch.utils.bounds import panel_qr_bound
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    P = torch.rand((4096, r), generator=gen, device=gen.device) - 0.5
    modes = {"robust": dict(robust=True), "plain10": dict(iters=10),
             "robust_mid": dict(robust=True, chain_mid=True)}
    rows, err = {}, 0.0
    for name, kw in modes.items():
        out = ns.panel_qr_fused(P, **kw)
        again = ns.panel_qr_fused(P, **kw)
        Qp, tp, resp = ns.panel_qr_fused_plain(P, **kw)
        torch.cuda.synchronize()
        robust = kw.get("robust", False)

        def canary(x):
            return (0.01 * x if robust else x * x) < 1e-4

        eq = _max_abs(out[0], Qp)
        row = {"max_abs_Q": eq, "lim_Q": TOL_F32 * float(Qp.abs().max()),
               "rel_t": _rel(out[1], tp), "resid": float(out[2]),
               "resid_plain": float(resp),
               "bitwise_repeatable": _same(out, again)}
        row["ok"] = (eq <= row["lim_Q"] and row["rel_t"] <= TOL_F32
                     and row["bitwise_repeatable"]
                     and canary(row["resid"]) == canary(row["resid_plain"]))
        rows[name] = row
        err = max(err, eq)
    lay = ns.group_layout(4096, r, ns._card_cluster(P, r))
    kw = modes["robust"]
    return {"kernel": "panel_qr_fused", "r": r, "shape": [4096, r],
            **_route(lay.chain), "bn": lay.bn, "modes": rows,
            "max_abs_err": err, "ok": all(x["ok"] for x in rows.values()),
            "ms": cuda_time_ms(lambda: ns.panel_qr_fused(P, **kw)),
            "plain_ms": cuda_time_ms(lambda: ns.panel_qr_fused_plain(P, **kw),
                                     warmup=1, iters=5),
            "ms_mode": "robust", "library_call": "torch.linalg.qr(P)",
            "library_ms": cuda_time_ms(lambda: torch.linalg.qr(P)),
            **panel_qr_bound(4096, r)}


GROUP_ITERS = (12, 6, 6, 10)
GROUP_ROBUST = (False, False, False, True)


def k2_row(r: int, gen: torch.Generator) -> dict:
    """K2 at width r on a 2048 x 4r group (g = 4, a robust tail panel) with
    the bf16 flags (bgs1: ||dQ|| / ||Q||, ||dR|| / ||R|| and the tail
    block's <= 5e-3) and fp32 (bgs2's group: max|dQ| <= 1e-4, ||dR|| /
    ||R|| <= 1e-4); the canary class; two launches bitwise equal."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
    from mixedprecisionblockqr_tpu_torch.utils.bounds import group_bound
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    Pg = torch.rand((2048, 4 * r), generator=gen, device=gen.device) - 0.5
    rows, err = {}, 0.0
    for bf in (True, False):
        kw = dict(bf16_dots=bf, chain_mid=bf)

        def call():
            return ns.bgs_group_fused(Pg, r, GROUP_ITERS, GROUP_ROBUST, **kw)

        out, again = call(), call()
        Qp, Rp, wp = ns.bgs_group_fused_plain(Pg, r, GROUP_ITERS,
                                              GROUP_ROBUST, **kw)
        torch.cuda.synchronize()
        Q, R, w = out
        row = {"max_abs_Q": _max_abs(Q, Qp), "rel_Q": _rel(Q, Qp),
               "rel_R": _rel(R, Rp),
               "rel_R_tail": _rel(R[-r:, -r:], Rp[-r:, -r:]),
               "resid": float(w), "resid_plain": float(wp),
               "bitwise_repeatable": _same(out, again)}
        tol = TOL_BF16 if bf else TOL_F32
        ok = (row["rel_R"] <= tol and row["rel_R_tail"] <= tol
              and row["bitwise_repeatable"])
        ok = ok and (row["rel_Q"] <= TOL_BF16 if bf
                     else row["max_abs_Q"] <= TOL_F32)
        row["ok"] = ok and (row["resid"] < 1e-4) == (row["resid_plain"]
                                                     < 1e-4)
        row["ms"] = cuda_time_ms(call)
        if bf:
            row["plain_ms"] = cuda_time_ms(lambda: ns.bgs_group_fused_plain(
                Pg, r, GROUP_ITERS, GROUP_ROBUST, **kw), warmup=1, iters=5)
        rows["bgs1" if bf else "bgs2"] = row
        err = max(err, row["max_abs_Q"])
    lay = ns.group_layout(2048, r, ns._card_cluster(Pg, r))
    return {"kernel": "bgs_group_fused", "r": r, "shape": [2048, 4 * r],
            "g": 4, **_route(lay.chain), "bn": lay.bn, "configs": rows,
            "max_abs_err": err, "ok": all(x["ok"] for x in rows.values()),
            "ms": rows["bgs1"]["ms"], "plain_ms": rows["bgs1"]["plain_ms"],
            "ms_mode": "bgs1 (bf16 flags), robust tail",
            "library_call": "torch.linalg.qr(Pg)",
            "library_ms": cuda_time_ms(lambda: torch.linalg.qr(Pg)),
            **group_bound(2048, r, GROUP_ITERS, GROUP_ROBUST, True)}


def k5_row(r: int, gen: torch.Generator) -> dict:
    """K5 at width r: a 2048 x 4r group scrubbed against 2r orthonormal
    columns read in place from a 4r-wide buffer (fp32 and bf16).  fp32:
    max|dQ| <= 1e-4, ||dRprev||, ||dRg|| <= 1e-4 relative; bf16: those
    two and the first panel's ||dQ|| <= 5e-3 relative, reconstruction,
    orthogonality and |Qprev^T Qg| within 2x of the plain version's; two
    launches bitwise equal."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
    from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32
    from mixedprecisionblockqr_tpu_torch.utils.bounds import group_bound
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    dev = gen.device
    w, p = 4 * r, 2 * r
    Pg = torch.rand((2048, w), generator=gen, device=dev) - 0.5
    Qbuf = torch.linalg.qr(torch.rand((2048, w), generator=gen, device=dev)
                           - 0.5)[0].contiguous()
    eye_w = torch.eye(w, device=dev)
    rows, err = {}, 0.0
    for bf in (False, True):
        Qprev = Qbuf.to(torch.bfloat16 if bf else torch.float32)[:, :p]
        kw = dict(bf16_dots=bf, chain_mid=bf)

        def call():
            return ns.bgs_group_fused_proj(Pg, Qprev, r, GROUP_ITERS,
                                           GROUP_ROBUST, **kw)

        def contract(Qg, Rprev, Rg):
            rec = _rel(mm_f32(Qprev, Rprev) + mm_f32(Qg, Rg), Pg)
            return (rec, _max_abs(mm_f32(Qg.T, Qg), eye_w),
                    float(mm_f32(Qprev.T, Qg).abs().max()))

        out, again = call(), call()
        plain = ns.bgs_group_fused_proj_plain(Pg, Qprev, r, GROUP_ITERS,
                                              GROUP_ROBUST, **kw)
        torch.cuda.synchronize()
        ck, cp = contract(*out[:3]), contract(*plain[:3])
        row = {"max_abs_Q": _max_abs(out[0], plain[0]),
               "rel_Q_first_panel": _rel(out[0][:, :r], plain[0][:, :r]),
               "rel_Rprev": _rel(out[1], plain[1]),
               "rel_Rg": _rel(out[2], plain[2]),
               "contract": ck, "contract_plain": cp,
               "resid": float(out[3]), "resid_plain": float(plain[3]),
               "bitwise_repeatable": _same(out, again)}
        tol = TOL_BF16 if bf else TOL_F32
        ok = (row["rel_Rprev"] <= tol and row["rel_Rg"] <= tol
              and row["bitwise_repeatable"])
        if bf:
            ok = ok and row["rel_Q_first_panel"] <= TOL_BF16 and all(
                a <= 2 * b for a, b in zip(ck, cp))
        else:
            ok = ok and row["max_abs_Q"] <= TOL_F32
        row["ok"] = ok and (row["resid"] < 1e-4) == (row["resid_plain"]
                                                     < 1e-4)
        row["ms"] = cuda_time_ms(call)
        if bf:
            row["plain_ms"] = cuda_time_ms(
                lambda: ns.bgs_group_fused_proj_plain(
                    Pg, Qprev, r, GROUP_ITERS, GROUP_ROBUST, **kw),
                warmup=1, iters=5)

            def library():
                C2 = torch.matmul(Qprev.float().T, Pg)
                return torch.linalg.qr(Pg - torch.matmul(Qprev.float(), C2))

            row["library_ms"] = cuda_time_ms(library)
        rows["bf16" if bf else "fp32"] = row
        err = max(err, row["max_abs_Q"])
    lay = ns.group_layout(2048, r, ns._card_cluster(Pg, r))
    return {"kernel": "bgs_group_fused_proj", "r": r, "shape": [2048, w],
            "p": p, **_route(lay.chain), "bn": lay.bn, "configs": rows,
            "max_abs_err": err, "ok": all(x["ok"] for x in rows.values()),
            "ms": rows["bf16"]["ms"], "plain_ms": rows["bf16"]["plain_ms"],
            "ms_mode": "bf16 flags and bf16 Qprev",
            "library_call": "two torch.matmul and torch.linalg.qr of the "
                            "scrubbed group",
            "library_ms": rows["bf16"]["library_ms"],
            **group_bound(2048, r, GROUP_ITERS, GROUP_ROBUST, True,
                          proj_cols=p)}


KERNELS = {"ns_chain": k1_row, "ninv_chain": k4_rows,
           "tri_combine": combine_row, "panel_qr_fused": k3_row,
           "bgs_group_fused": k2_row, "bgs_group_fused_proj": k5_row}


def sweep_row(r: int, gen: torch.Generator) -> dict:
    """K1 and K4 at width r, CUDA-event ms by iteration count."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
    from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    P = torch.rand((2048, r), generator=gen, device=gen.device) - 0.5
    G = mm_f32(P.T, P).contiguous()
    S = (torch.eye(r, device=gen.device) * 1.5).contiguous()
    its = (0, 1, 2, 4, 8)
    kinds = {"fp32": {}, "chain_mid": dict(chain_mid=True),
             "refine": dict(refine=True), "shift": dict(shift=1e-3)}
    layout = getattr(ns, "ns_layout", None)
    row = {"r": r, "route": layout(r).route if layout else "smem"}
    for name, kw in kinds.items():
        row[f"k1_{name}"] = {
            it: cuda_time_ms(lambda: ns.ns_chain(G, iters=it, **kw))
            for it in its}
    row["k4"] = {it: cuda_time_ms(lambda: ns.ninv_chain(S, it)) for it in its}
    return row


def headline_ms(dev: torch.device) -> float:
    """CUDA-event median of the headline call (``chip_smoke.py`` phase 4:
    ``block_qr`` 2048^2, numpy seed 0 uniform - 0.5, r = 128)."""
    import numpy as np

    from mixedprecisionblockqr_tpu_torch import POLICY_MIXED_FAST, block_qr
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    A = torch.from_numpy(np.random.default_rng(0).random(
        (2048, 2048), dtype=np.float32) - 0.5).to(dev)
    return cuda_time_ms(lambda: block_qr(
        A, 128, POLICY_MIXED_FAST, mode="complete", panel_method="auto",
        quality="fast", check="defer"), warmup=2, iters=20)


def width_rows(dev: torch.device, widths=WIDTHS) -> dict:
    """kernel name -> {r: row} for every kernel of :data:`KERNELS` at
    every width, each width's inputs drawn from a generator seeded with
    r (so that the rows do not depend on each other)."""
    out = {name: {} for name in KERNELS}
    for r in widths:
        for name, fn in KERNELS.items():
            gen = torch.Generator(device=dev).manual_seed(1000 + r)
            out[name][r] = fn(r, gen)
    return out


def l2_edge_rows(dev: torch.device, widths=L2_EDGE_WIDTHS) -> dict:
    """kernel name -> {r: row} for each kernel of :data:`L2_EDGE_KERNELS`
    at each of ``widths``, each row from a generator seeded with 1000 + r,
    as :func:`width_rows` draws them."""
    return {name: {r: KERNELS[name](
        r, torch.Generator(device=dev).manual_seed(1000 + r))
        for r in widths} for name in L2_EDGE_KERNELS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("widths", nargs="*", type=int, default=list(WIDTHS))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--headline", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("width_probe: no CUDA device", file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.library()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.sweep:
        if args.headline:
            print(json.dumps({"headline_ms": headline_ms(dev)}), flush=True)
        for r in args.widths:
            gen = torch.Generator(device=dev).manual_seed(1000 + r)
            print(json.dumps(sweep_row(r, gen)), flush=True)
        return 0
    bad = 0
    for r in args.widths:
        for name, fn in KERNELS.items():
            gen = torch.Generator(device=dev).manual_seed(1000 + r)
            try:
                row = fn(r, gen)
            except Exception as exc:  # report every kernel, then fail
                row = {"kernel": name, "r": r, "ok": False,
                       "error": f"{type(exc).__name__}: {exc}"[:2000]}
            bad += not row["ok"]
            print(json.dumps(row), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
