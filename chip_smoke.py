"""Drive the PyTorch + CUDA port of the mixed-precision blocked QR on one
NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
last line):
  1. device   -- the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build    -- build (or load) the kernel library from csrc/ (one nvcc
                 per source, in parallel);
  3. kernels  -- ns_chain, bgs_group_fused, panel_qr_fused, ninv_chain,
                 panel_factor_fused and sketch_qrcp_ranks against their
                 plain PyTorch versions on the card at the main paths'
                 shapes, with the stated tolerances; the kernel's, the plain
                 version's and the library call's times (CUDA events,
                 median of 20 unless a line says otherwise);
  4. main     -- block_qr(A, 128, POLICY_MIXED_FAST, mode='complete',
                 panel_method='auto', quality='fast', check='defer') on the
                 2048^2 benchmark input (numpy seed 0, uniform - 0.5):
                 resolves to bgs1 / g8, two bgs_group_fused launches, quality
                 gates, time and TFLOP/s;
  5. qr       -- qr(A, policy=POLICY_MIXED): the 'balanced' (bgs2) default;
  6. band     -- block_qr as in phase 4 at 4096^2: the per-panel ns_chain
                 route;
  7. lstsq    -- the rank-revealing least-squares path: lstsq(J, -b) on a
                 4096 x 2048 gauge-deficient SLAM Jacobian (64 dependent
                 columns) reroutes to RQRCP, 16 panel_qr_fused and 16
                 sketch_qrcp_ranks launches, checked against the float64
                 np.linalg.lstsq oracle; pivoted_qr's contract; times of
                 lstsq and of pivoted_qr_qtb's two tiers;
  8. robust   -- block_qr(A, 128, POLICY_FP32, panel_method='householder')
                 on the 2048^2 input: the robust Householder tier;
  9. polar    -- block_qr(A, 128, POLICY_MIXED_FAST, mode='complete',
                 panel_method='auto', quality='fast') on a 4096 x 2048 input
                 resolves to polar / g8: 16 ns_chain and 16 ninv_chain
                 launches, quality within 2x of the JAX package's;
 10. pallas   -- block_qr(A, 128, POLICY_FP32,
                 panel_method='householder_pallas') at 2048^2: 16
                 panel_factor_fused launches, R against phase 8's;
 11. cholqr   -- cholqr1 / cholqr2 / cholqr2s / cholqr1x2 at 2048^2 (one
                 panel_factor_fused launch each), cholqr1 scan (15
                 ninv_chain launches), and bgs1 on a 2000 x 2000 input
                 (resolves to cholqr1; K6 at 208 x 128 and 80 x 80);
 12. device   -- a numpy input with no device= runs on the card.
Then a line with every kernel's launches on its main path (phases 4-6 for
ns_chain and bgs_group_fused, phase 7 for panel_qr_fused and
sketch_qrcp_ranks, phase 9 for ninv_chain, phase 10 for
panel_factor_fused, one call each), error, times and bound, and as the
last line {"ok": true, "device": {...}}.  Without a CUDA device it exits 2
and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Quality of the same call in the JAX reference (BENCH_r05.json).
REF_BACKWARD = 2.42e-3
REF_ORTH = 7.66e-2
# The JAX package's block_qr(A, 128, POLICY_MIXED_FAST, mode='complete',
# panel_method='polar', group_panels=8) on phase 9's 4096 x 2048 input, run
# on the CPU (JAX 0.9.0, XLA branch of the polar driver), measured by its
# ops/metrics.py::evaluate with precision_bits = 8.
REF_POLAR_BACKWARD = 6.290683057159185e-3
REF_POLAR_ORTH = 8.180379867553711e-3
TOL_F32 = 1e-4   # fp32 kernels vs plain: summation order only
TOL_BF16 = 5e-3  # bf16-rounded operands: a rounding may flip


def emit(obj):
    print(json.dumps(obj), flush=True)


def rel_fro(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def max_abs(a, b):
    return float((a - b).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch import (
        POLICY_FP32,
        POLICY_MIXED,
        POLICY_MIXED_FAST,
        block_qr,
        lstsq,
        metrics,
        numerical_rank,
        pivoted_qr,
        pivoted_qr_qtb,
        qr,
    )
    from mixedprecisionblockqr_tpu_torch.ops import pivoted
    from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
        resolve_panel_config,
    )
    from mixedprecisionblockqr_tpu_torch.ops.cholqr import _sign_fix
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
    from mixedprecisionblockqr_tpu_torch.ops import blockqr as bq
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        LAUNCHES,
        bgs_group_fused,
        bgs_group_fused_plain,
        ninv_chain,
        ninv_chain_plain,
        ns_chain,
        ns_chain_plain,
        panel_qr_fused,
        panel_qr_fused_plain,
        reset_launches,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        panel_factor_fused,
        panel_factor_fused_plain,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.sketch import (
        sketch_qrcp_ranks,
        sketch_qrcp_ranks_plain,
    )
    from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        group_bound,
        ninv_chain_bound,
        ns_chain_bound,
        panel_factor_bound,
        panel_qr_bound,
        sketch_bound,
    )
    from mixedprecisionblockqr_tpu_torch.utils.datagen import (
        gauge_deficient_system,
    )
    from mixedprecisionblockqr_tpu_torch.utils.flops import qr_flops
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{smi} (nvidia-smi name, power.limit)"
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds})

    # 3. kernels against their plain versions, at the main path's shapes
    gen = torch.Generator(device=dev).manual_seed(0)
    P = torch.rand((2048, 128), generator=gen, device=dev) - 0.5
    G = mm_f32(P.T, P).contiguous()
    Pill = P * torch.logspace(0, -3, 128, device=dev)
    G_ill = mm_f32(Pill.T, Pill).contiguous()
    X0, _, _ = ns_chain_plain(G, iters=10)
    Qn = mm_f32(P, X0)
    G_ref = mm_f32(Qn.T, Qn).contiguous()
    modes = {
        "plain": (G, dict(iters=10)),
        "shift": (G_ill, dict(iters=14, shift=1e-3)),
        "refine": (G_ref, dict(iters=4, refine=True)),
        "chain_mid": (G, dict(iters=6, chain_mid=True)),
        "classic": (G, dict(iters=10, fuse_xw=False)),
    }
    ns_rows, ns_err = {}, 0.0
    for name, (Gm, kw) in modes.items():
        X, t, res = ns_chain(Gm, **kw)
        Xp, tp, resp = ns_chain_plain(Gm, **kw)
        torch.cuda.synchronize()
        ex, et = max_abs(X, Xp), max_abs(t, tp)
        lim_x = TOL_F32 * float(Xp.abs().max())
        lim_t = TOL_F32 * float(tp.abs().max())
        ok = (ex <= lim_x and et <= lim_t
              and (float(res) < 1e-4) == (float(resp) < 1e-4))
        ns_rows[name] = {"err_X": ex, "lim_X": lim_x, "err_t": et,
                         "lim_t": lim_t, "resid": float(res),
                         "resid_plain": float(resp), "ok": ok,
                         "ms": cuda_time_ms(lambda: ns_chain(Gm, **kw)),
                         "plain_ms": cuda_time_ms(
                             lambda: ns_chain_plain(Gm, **kw))}
        ns_err = max(ns_err, ex, et)
        assert ok, (name, ns_rows[name])
    lib_k1 = cuda_time_ms(lambda: torch.linalg.cholesky(G))
    emit({"phase": "kernels", "kernel": "ns_chain", "r": 128,
          "tolerance": "max|diff| <= 1e-4 * max|plain| for X and t; same "
                       "canary class (resid < 1e-4)",
          "modes": ns_rows, "library_call": "torch.linalg.cholesky(G)",
          "library_ms": lib_k1, "card": card})

    Pg = torch.rand((2048, 1024), generator=gen, device=dev) - 0.5
    iters = (12, 6, 6, 6, 6, 6, 6, 10)
    grp_rows, grp_err = {}, 0.0
    for bf in (True, False):
        for rob in (False, True):
            robust = (False,) * 7 + (rob,)
            kw = dict(bf16_dots=bf, chain_mid=bf)
            Q, R, w = bgs_group_fused(Pg, 128, iters, robust, **kw)
            Qp, Rp, wp = bgs_group_fused_plain(Pg, 128, iters, robust, **kw)
            torch.cuda.synchronize()
            # The tail panel's diagonal block alone, where the robust
            # three-pass chain writes its R block.
            row = {"max_abs_Q": max_abs(Q, Qp), "rel_Q": rel_fro(Q, Qp),
                   "rel_R": rel_fro(R, Rp),
                   "rel_R_tail": rel_fro(R[-128:, -128:], Rp[-128:, -128:]),
                   "resid": float(w), "resid_plain": float(wp)}
            tol = TOL_BF16 if bf else TOL_F32
            ok = row["rel_R"] <= tol and row["rel_R_tail"] <= tol
            if bf:
                ok = ok and row["rel_Q"] <= TOL_BF16
            else:
                ok = ok and row["max_abs_Q"] <= TOL_F32
            row["ok"] = ok and (row["resid"] < 1e-4) == (
                row["resid_plain"] < 1e-4)
            row["ms"] = cuda_time_ms(
                lambda: bgs_group_fused(Pg, 128, iters, robust, **kw))
            row["plain_ms"] = cuda_time_ms(
                lambda: bgs_group_fused_plain(Pg, 128, iters, robust, **kw))
            grp_rows[f"{'bgs1' if bf else 'bgs2'}_robust={rob}"] = row
            grp_err = max(grp_err, row["max_abs_Q"])
            assert row["ok"], (bf, rob, row)
    lib_k2 = cuda_time_ms(lambda: torch.linalg.qr(Pg))
    emit({"phase": "kernels", "kernel": "bgs_group_fused",
          "shape": [2048, 1024], "r": 128, "g": 8,
          "tolerance": "fp32 flags: max|dQ| <= 1e-4, ||dR||/||R|| <= 1e-4; "
                       "bf16 flags: ||dQ||/||Q||, ||dR||/||R|| <= 5e-3",
          "configs": grp_rows, "library_call": "torch.linalg.qr(Pg)",
          "library_ms": lib_k2, "card": card})

    # K3 at the RQRCP panels' shape (m = 4096, r = 128), on a uniform panel
    # and on the same panel with its columns graded over three decades.
    Pk = torch.rand((4096, 128), generator=gen, device=dev) - 0.5
    panels = {"uniform": Pk,
              "graded": Pk * torch.logspace(0, -3, 128, device=dev)}
    k3_modes = {"robust": dict(robust=True),
                "plain10": dict(iters=10),
                "robust_mid": dict(robust=True, chain_mid=True)}
    k3_rows, k3_err = {}, 0.0
    for pname, Pm in panels.items():
        for mname, kw in k3_modes.items():
            Q, t, res = panel_qr_fused(Pm, **kw)
            Qp, tp, resp = panel_qr_fused_plain(Pm, **kw)
            torch.cuda.synchronize()
            robust = kw.get("robust", False)

            def canary(x):  # the drivers' scaling of the raw residual
                return (0.01 * x if robust else x * x) < 1e-4

            eq, lim_q = max_abs(Q, Qp), TOL_F32 * float(Qp.abs().max())
            row = {"max_abs_Q": eq, "lim_Q": lim_q, "rel_t": rel_fro(t, tp),
                   "resid": float(res), "resid_plain": float(resp)}
            row["ok"] = (eq <= lim_q and row["rel_t"] <= TOL_F32
                         and canary(row["resid"]) == canary(
                             row["resid_plain"]))
            row["ms"] = cuda_time_ms(lambda: panel_qr_fused(Pm, **kw))
            row["plain_ms"] = cuda_time_ms(
                lambda: panel_qr_fused_plain(Pm, **kw))
            k3_rows[f"{pname}_{mname}"] = row
            k3_err = max(k3_err, eq)
            assert row["ok"], (pname, mname, row)
    lib_k3 = cuda_time_ms(lambda: torch.linalg.qr(Pk))
    emit({"phase": "kernels", "kernel": "panel_qr_fused",
          "shape": [4096, 128],
          "tolerance": "max|dQ| <= 1e-4 * max|Q|, ||dt||/||t|| <= 1e-4; "
                       "same canary class (0.01 resid < 1e-4 robust, "
                       "resid^2 < 1e-4 plain)",
          "modes": k3_rows, "library_call": "torch.linalg.qr(P)",
          "library_ms": lib_k3, "card": card})

    # K4 on Yamamoto S matrices (I - Q1^T, Q1 the sign-fixed top block of
    # a panel's orthonormal basis): a 4096 x 128 panel (aspect 32, 5
    # iterations, the polar phase's), a 256 x 128 one (aspect 2, 12), and a
    # near-singular S: the rotation by pi about (1,1,1)/sqrt(3) of the JAX
    # package's ops/cholqr.py:110-115, scaled by 0.999, in the top corner.
    def yamamoto_S(m):
        Qb, _ = torch.linalg.qr(
            torch.rand((m, 128), generator=gen, device=dev) - 0.5)
        D = _sign_fix(Qb[:128])
        return (torch.eye(128, device=dev) - (Qb * D)[:128].T).contiguous()

    c3 = torch.ones(3, device=dev) / 3 ** 0.5
    S_sing = torch.eye(128, device=dev)
    S_sing[:3, :3] -= 0.999 * (2 * torch.outer(c3, c3)
                               - torch.eye(3, device=dev)).T
    k4_inputs = {"panel4096_it5": (yamamoto_S(4096), 5),
                 "panel256_it12": (yamamoto_S(256), 12),
                 "near_singular_it12": (S_sing.contiguous(), 12)}
    k4_rows, k4_err = {}, 0.0
    for name, (S, it) in k4_inputs.items():
        X, res = ninv_chain(S, it)
        Xp, resp = ninv_chain_plain(S, it)
        torch.cuda.synchronize()
        ex, lim = max_abs(X, Xp), TOL_F32 * float(Xp.abs().max())
        row = {"iters": it, "max_abs_X": ex, "lim_X": lim,
               "resid": float(res), "resid_plain": float(resp),
               "ok": ex <= lim and (float(res) < 1e-3) == (
                   float(resp) < 1e-3),
               "ms": cuda_time_ms(lambda: ninv_chain(S, it)),
               "plain_ms": cuda_time_ms(lambda: ninv_chain_plain(S, it)),
               "library_ms": cuda_time_ms(lambda: torch.linalg.inv(S))}
        k4_rows[name] = row
        k4_err = max(k4_err, ex)
        assert row["ok"], (name, row)
    emit({"phase": "kernels", "kernel": "ninv_chain", "r": 128,
          "tolerance": "max|dX| <= 1e-4 * max|X|; same fallback class "
                       "(resid < 1e-3)", "library_call": "torch.linalg.inv(S)",
          "inputs": k4_rows, "card": card})

    # K6 at the paths' panel shapes: householder_pallas's first panel
    # (2048 x 128) and square last one (128 x 128), the cholqr hybrid's
    # tails at 2000^2 (208 x 128, 80 x 80), and a 2048 x 128 panel with a
    # zero column and one with a NaN.  4096 x 128 (householder_pallas's
    # first panel at 4096 x 2048) and 8192 x 128 (the wrapper's top height)
    # exceed the cluster's shared memory: the kernel works on their rows in
    # place in R.
    k6_inputs = {f"{m}x{w}": torch.rand((m, w), generator=gen, device=dev)
                 - 0.5 for m, w in ((2048, 128), (128, 128), (208, 128),
                                    (80, 80), (4096, 128), (8192, 128))}
    Pz = torch.rand((2048, 128), generator=gen, device=dev) - 0.5
    Pz[:, 5] = 0.0
    k6_inputs["2048x128_zero_column"] = Pz
    Pn = torch.rand((2048, 128), generator=gen, device=dev) - 0.5
    Pn[300, 9] = float("nan")
    k6_inputs["2048x128_nan"] = Pn

    def finite_err(a, b):
        """max|a - b| and max|b| over the entries finite in both."""
        keep = torch.isfinite(a) & torch.isfinite(b)
        return (float((a - b)[keep].abs().max()),
                float(b[keep].abs().max()))

    k6_rows, k6_err = {}, 0.0
    for name, Pm in k6_inputs.items():
        V, T, Rr = panel_factor_fused(Pm)
        Vp, Tp, Rp = panel_factor_fused_plain(Pm)
        torch.cuda.synchronize()
        Rp = torch.triu(Rp)
        row, ok = {}, True
        for key, a, b in (("V", V, Vp), ("T", T, Tp), ("R", Rr, Rp)):
            e, mx = finite_err(a, b)
            row[f"max_abs_{key}"], row[f"lim_{key}"] = e, TOL_F32 * mx
            ok = ok and e <= TOL_F32 * mx
            k6_err = max(k6_err, e)
        row["nan_in_R"] = bool(torch.isnan(Rr).any())
        same_nan = bool(torch.equal(torch.isnan(Rr), torch.isnan(Rp)))
        finite_vt = bool(torch.isfinite(V).all() and torch.isfinite(T).all())
        if name.endswith("nan"):
            ok = ok and row["nan_in_R"] and same_nan
        else:
            ok = ok and finite_vt and bool(torch.isfinite(Rr).all())
        row["ok"] = ok
        row["ms"] = cuda_time_ms(lambda: panel_factor_fused(Pm))
        row["plain_ms"] = cuda_time_ms(lambda: panel_factor_fused_plain(Pm),
                                       warmup=1, iters=3)
        row["library_ms"] = cuda_time_ms(lambda: torch.geqrf(Pm))
        k6_rows[name] = row
        assert ok, (name, row)
    emit({"phase": "kernels", "kernel": "panel_factor_fused",
          "tolerance": "V, T and R's upper triangle each within 1e-4 * "
                       "max|plain| over finite entries (the kernel writes "
                       "exact zeros below R's diagonal, the plain version "
                       "residue); the NaN reaches R, in the plain version's "
                       "places; plain ms: median of 3",
          "library_call": "torch.geqrf(P)", "inputs": k6_rows,
          "card": card})

    # K7 on seeded Gaussian sketches of d = 128 + 8 at the RQRCP panels'
    # widths, and on one with a zero column and a duplicated column.
    sketches = {f"w{w}": torch.randn((136, w), generator=gen, device=dev)
                for w in (2048, 1920, 200)}
    Sz = torch.randn((136, 2048), generator=gen, device=dev)
    Sz[:, 3] = 0.0
    Sz[:, 7] = Sz[:, 1000]
    sketches["zero_dup"] = Sz
    k7_rows, k7_err = {}, 0
    for sname, S in sketches.items():
        rk = sketch_qrcp_ranks(S, 128)
        rp = sketch_qrcp_ranks_plain(S, 128)
        torch.cuda.synchronize()
        same = bool(torch.equal(torch.argsort(rk, stable=True),
                                torch.argsort(rp, stable=True)))
        err = int((rk.long() - rp.long()).abs().max())
        row = {"same_order": same, "max_abs_rank": err,
               "ms": cuda_time_ms(lambda: sketch_qrcp_ranks(S, 128)),
               "plain_ms": cuda_time_ms(
                   lambda: sketch_qrcp_ranks_plain(S, 128))}
        k7_rows[sname] = row
        k7_err = max(k7_err, err)
        assert same and err == 0, (sname, row)
    emit({"phase": "kernels", "kernel": "sketch_qrcp_ranks", "d": 136,
          "r": 128, "tolerance": "identical stable-argsort order (and "
                                 "identical ranks)",
          "sketches": k7_rows, "card": card})

    # 4-6. the main path: one call each, launch counts from these calls only
    a = np.random.default_rng(0).random((2048, 2048), dtype=np.float32) - 0.5
    A = torch.from_numpy(a).to(dev)
    A4 = torch.rand((4096, 4096), generator=gen, device=dev) - 0.5

    def headline(x):
        return block_qr(x, 128, POLICY_MIXED_FAST, mode="complete",
                        panel_method="auto", quality="fast", check="defer")

    assert resolve_panel_config(
        2048, 2048, 128, POLICY_MIXED_FAST, "auto", "unroll", 4,
        mode="complete", on_gpu=True, quality="fast",
    ) == ("bgs1", "unroll", 8)
    torch.cuda.synchronize()
    reset_launches()
    Q, R = headline(A)
    torch.cuda.synchronize()
    c4 = dict(LAUNCHES)
    Q5, R5 = qr(A, policy=POLICY_MIXED)
    torch.cuda.synchronize()
    c5 = {k: LAUNCHES[k] - c4[k] for k in LAUNCHES}
    Q6, R6 = headline(A4)
    torch.cuda.synchronize()
    c6 = {k: LAUNCHES[k] - c4[k] - c5[k] for k in LAUNCHES}
    main_launches = dict(LAUNCHES)

    rep = metrics.evaluate(A, Q, R, POLICY_MIXED_FAST.precision_bits)
    assert c4["bgs_group_fused"] == 2, c4
    assert rep.all_ok and rep.tight_ok, str(rep)
    assert 0.5 * REF_BACKWARD <= rep.backward <= 2 * REF_BACKWARD, rep
    assert 0.5 * REF_ORTH <= rep.orthogonality <= 2 * REF_ORTH, rep
    ms4 = cuda_time_ms(lambda: headline(A), warmup=2, iters=20)
    emit({"phase": "main", "call": "block_qr 2048^2 POLICY_MIXED_FAST "
          "complete auto fast defer", "resolved": ["bgs1", "unroll", 8],
          "launches": c4, "backward": rep.backward,
          "orthogonality": rep.orthogonality,
          "lower_trapezoid": rep.lower_trapezoid, "all_ok": rep.all_ok,
          "tight_ok": rep.tight_ok, "ms": ms4,
          "tflops": qr_flops(2048, 2048) / (ms4 * 1e-3) / 1e12,
          "card": card})

    rep5 = metrics.evaluate(A, Q5, R5, POLICY_MIXED.precision_bits)
    assert rep5.all_ok and rep5.orthogonality <= 1e-4, str(rep5)
    assert c5["ns_chain"] >= 1 and c5["bgs_group_fused"] == 2, c5
    ms5 = cuda_time_ms(lambda: qr(A, policy=POLICY_MIXED), warmup=2,
                       iters=20)
    emit({"phase": "qr", "call": "qr 2048^2 POLICY_MIXED (balanced -> bgs2)",
          "launches": c5, "backward": rep5.backward,
          "orthogonality": rep5.orthogonality,
          "lower_trapezoid": rep5.lower_trapezoid, "all_ok": rep5.all_ok,
          "tight_ok": rep5.tight_ok, "ms": ms5,
          "tflops": qr_flops(2048, 2048) / (ms5 * 1e-3) / 1e12,
          "card": card})

    rep6 = metrics.evaluate(A4, Q6, R6, POLICY_MIXED_FAST.precision_bits)
    assert c6["ns_chain"] > 0 and c6["bgs_group_fused"] == 0, c6
    assert rep6.all_ok, str(rep6)
    ms6 = cuda_time_ms(lambda: headline(A4), warmup=1, iters=20)
    emit({"phase": "band", "call": "block_qr 4096^2 POLICY_MIXED_FAST "
          "complete auto fast defer (per-panel route)", "launches": c6,
          "backward": rep6.backward, "orthogonality": rep6.orthogonality,
          "lower_trapezoid": rep6.lower_trapezoid, "all_ok": rep6.all_ok,
          "tight_ok": rep6.tight_ok, "ms": ms6,
          "tflops": qr_flops(4096, 4096) / (ms6 * 1e-3) / 1e12,
          "card": card})

    for k in ("ns_chain", "bgs_group_fused"):
        assert main_launches[k] > 0, f"{k} was not launched on the main path"

    # 7. the rank-revealing least-squares path at full size
    Jn, bn = gauge_deficient_system(4096, 2048, 64)
    t0 = time.perf_counter()
    x_o, _, rank_o, _ = np.linalg.lstsq(
        Jn.astype(np.float64), -bn.astype(np.float64),
        rcond=float(np.finfo(np.float32).eps) * 4096)
    oracle_s = time.perf_counter() - t0
    J = torch.from_numpy(Jn).to(dev)
    b = torch.from_numpy(bn).to(dev)
    torch.cuda.synchronize()
    reset_launches()
    x = lstsq(J, -b)
    torch.cuda.synchronize()
    c7 = dict(LAUNCHES)
    assert c7["panel_qr_fused"] == 16 and c7["sketch_qrcp_ranks"] == 16, c7
    # The same deterministic RQRCP call as inside lstsq (seed 0): its worst
    # panel residual shows that the exact fallback did not fire.
    R7, _, _, _, worst7 = pivoted._rqrcp_impl(J, -b[:, None], False, True,
                                             128, 8, 0)
    rank7 = numerical_rank(R7[:2048], m=4096)
    J64 = torch.from_numpy(Jn).double()
    x64 = x.double().cpu()
    res_o = float(torch.linalg.norm(J64 @ torch.from_numpy(x_o)
                                    + torch.from_numpy(bn).double()))
    res_x = float(torch.linalg.norm(J64 @ x64 + torch.from_numpy(bn).double()))
    x_err = float(torch.linalg.norm(x64 - torch.from_numpy(x_o))
                  / torch.linalg.norm(torch.from_numpy(x_o)))
    row7 = {"worst_resid": float(worst7), "rank": rank7,
            "rank_oracle": int(rank_o), "resid": res_x,
            "resid_oracle": res_o, "resid_rel": abs(res_x - res_o) / res_o,
            "x_rel_err": x_err}
    assert row7["worst_resid"] < 1e-4, row7
    assert rank7 == int(rank_o) == 1984, row7
    assert row7["resid_rel"] <= 1e-5 and x_err <= 1e-4, row7
    # pivoted_qr's contract (tests/test_pivoted.py::_check_rqrcp)
    Qp, Rp, pp = pivoted_qr(J, mode="reduced")
    Qd, Rd = Qp.double(), Rp.double()
    Jd = J.double()
    rec = float(torch.linalg.norm(Jd[:, pp] - Qd @ Rd) / torch.linalg.norm(Jd))
    orth = float((Qd.T @ Qd - torch.eye(2048, dtype=torch.float64,
                                        device=dev)).abs().max())
    dd = Rd.diagonal().abs()
    runmax = torch.cummax(dd, 0).values[:-1]
    decay = bool((dd[1:] <= 1.3 * runmax + 5e-6 * (dd[0] + 1e-30)).all())
    perm_ok = bool(torch.equal(torch.sort(pp).values,
                               torch.arange(2048, device=dev)))
    row7.update({"pivoted_qr_reconstruction": rec,
                 "pivoted_qr_orthogonality": orth, "diag_decay": decay,
                 "perm_valid": perm_ok})
    assert rec < 5e-6 and orth < 5e-6 and decay and perm_ok, row7
    row7["ms"] = cuda_time_ms(lambda: lstsq(J, -b), warmup=1, iters=5)
    row7["rqrcp_ms"] = cuda_time_ms(
        lambda: pivoted_qr_qtb(J, -b, method="rqrcp"), warmup=1, iters=5)
    row7["exact_ms"] = cuda_time_ms(
        lambda: pivoted_qr_qtb(J, -b, method="exact"), warmup=1, iters=5)
    emit({"phase": "lstsq", "call": "lstsq(J, -b) POLICY_FP32, J = "
          "slam_jacobian(4096, 2048, seed=0) with 64 dependent columns",
          "launches": c7, "oracle": "np.linalg.lstsq float64, rcond = "
          "eps_f32 * 4096", "oracle_seconds": oracle_s, **row7,
          "tolerance": "rank equal, residual 1e-5 relative, x 1e-4 "
                       "relative; pivoted_qr reconstruction and "
                       "orthogonality < 5e-6", "card": card})
    for k in ("panel_qr_fused", "sketch_qrcp_ranks"):
        assert c7[k] > 0, f"{k} was not launched on the lstsq path"

    # 8. the robust Householder tier on the 2048^2 input
    Q8, R8 = block_qr(A, 128, POLICY_FP32, panel_method="householder")
    rep8 = metrics.evaluate(A, Q8, R8, POLICY_FP32.precision_bits)
    assert rep8.all_ok and rep8.tight_ok, str(rep8)
    ms8 = cuda_time_ms(
        lambda: block_qr(A, 128, POLICY_FP32, panel_method="householder"),
        warmup=1, iters=5)
    emit({"phase": "robust", "call": "block_qr 2048^2 POLICY_FP32 "
          "householder reduced", "backward": rep8.backward,
          "orthogonality": rep8.orthogonality,
          "lower_trapezoid": rep8.lower_trapezoid, "all_ok": rep8.all_ok,
          "tight_ok": rep8.tight_ok, "ms": ms8,
          "tflops": qr_flops(2048, 2048) / (ms8 * 1e-3) / 1e12,
          "card": card})

    # 9. polar: the auto-dispatched complete Q of a tall matrix
    a9 = np.random.default_rng(0).random((4096, 2048), dtype=np.float32) - 0.5
    A9 = torch.from_numpy(a9).to(dev)

    def polar_call(x):
        return block_qr(x, 128, POLICY_MIXED_FAST, mode="complete",
                        panel_method="auto", quality="fast")

    assert resolve_panel_config(
        4096, 2048, 128, POLICY_MIXED_FAST, "auto", "unroll", 4,
        mode="complete", on_gpu=True, quality="fast",
    ) == ("polar", "unroll", 8)
    torch.cuda.synchronize()
    reset_launches()
    Q9, R9 = polar_call(A9)
    torch.cuda.synchronize()
    c9 = dict(LAUNCHES)
    rep9 = metrics.evaluate(A9, Q9, R9, POLICY_MIXED_FAST.precision_bits)
    assert c9["ninv_chain"] == 16 and c9["ns_chain"] == 16, c9
    assert rep9.all_ok, str(rep9)
    for got, ref in ((rep9.backward, REF_POLAR_BACKWARD),
                     (rep9.orthogonality, REF_POLAR_ORTH)):
        assert 0.5 * ref <= got <= 2 * ref, (got, ref, str(rep9))
    ms9 = cuda_time_ms(lambda: polar_call(A9), warmup=1, iters=10)
    emit({"phase": "polar", "call": "block_qr 4096x2048 POLICY_MIXED_FAST "
          "complete auto fast defer", "resolved": ["polar", "unroll", 8],
          "launches": c9, "backward": rep9.backward,
          "orthogonality": rep9.orthogonality,
          "ref_backward": REF_POLAR_BACKWARD, "ref_orthogonality":
          REF_POLAR_ORTH, "lower_trapezoid": rep9.lower_trapezoid,
          "all_ok": rep9.all_ok, "tight_ok": rep9.tight_ok, "ms": ms9,
          "tflops": qr_flops(4096, 2048) / (ms9 * 1e-3) / 1e12,
          "card": card})

    # 10. householder_pallas: every panel through K6
    def pallas_call(x):
        return block_qr(x, 128, POLICY_FP32, panel_method="householder_pallas")

    torch.cuda.synchronize()
    reset_launches()
    Q10, R10 = pallas_call(A)
    torch.cuda.synchronize()
    c10 = dict(LAUNCHES)
    rep10 = metrics.evaluate(A, Q10, R10, POLICY_FP32.precision_bits)
    rel10 = rel_fro(R10, R8)
    assert c10["panel_factor_fused"] == 16, c10
    assert rep10.all_ok and rep10.tight_ok, str(rep10)
    assert rel10 <= 1e-4, rel10
    ms10 = cuda_time_ms(lambda: pallas_call(A), warmup=1, iters=5)
    emit({"phase": "pallas", "call": "block_qr 2048^2 POLICY_FP32 "
          "householder_pallas reduced", "launches": c10,
          "backward": rep10.backward, "orthogonality": rep10.orthogonality,
          "lower_trapezoid": rep10.lower_trapezoid, "all_ok": rep10.all_ok,
          "tight_ok": rep10.tight_ok, "rel_R_vs_householder": rel10,
          "ms": ms10, "householder_ms": ms8,
          "tflops": qr_flops(2048, 2048) / (ms10 * 1e-3) / 1e12,
          "card": card})

    # 11. the CholeskyQR tiers, one call each, with the launches they make
    a11 = np.random.default_rng(0).random((2000, 2000), dtype=np.float32) - 0.5
    A11 = torch.from_numpy(a11).to(dev)
    assert resolve_panel_config(2000, 2000, 128, POLICY_MIXED, "bgs1",
                                "unroll", 4, on_gpu=True) == (
        "cholqr1", "unroll", 4)
    k6_shapes = []
    k6_wrapper = bq.panel_factor_fused

    def recording_k6(panel):
        k6_shapes.append(list(panel.shape))
        return k6_wrapper(panel)

    chol_calls = [
        ("cholqr1", POLICY_MIXED, "unroll", A, {"panel_factor_fused": 1}),
        ("cholqr2", POLICY_FP32, "unroll", A, {"panel_factor_fused": 1}),
        ("cholqr2s", POLICY_FP32, "unroll", A, {"panel_factor_fused": 1}),
        ("cholqr1x2", POLICY_MIXED, "unroll", A, {"panel_factor_fused": 1}),
        ("cholqr1", POLICY_MIXED, "scan", A, {"ninv_chain": 15}),
        ("bgs1", POLICY_MIXED, "unroll", A11, {"panel_factor_fused": 2}),
    ]
    chol_rows = {}
    for pm, pol, lm, X, want in chol_calls:
        def call():
            return block_qr(X, 128, pol, mode="complete", panel_method=pm,
                            loop_mode=lm)

        name = f"{pm}_{lm}_{pol.name}_{X.shape[0]}"
        k6_shapes.clear()
        bq.panel_factor_fused = recording_k6
        torch.cuda.synchronize()
        reset_launches()
        Qc, Rc = call()
        torch.cuda.synchronize()
        cc = dict(LAUNCHES)
        bq.panel_factor_fused = k6_wrapper
        repc = metrics.evaluate(X, Qc, Rc, pol.precision_bits)
        row = {"launches": cc, "k6_shapes": list(k6_shapes),
               "backward": repc.backward,
               "orthogonality": repc.orthogonality, "all_ok": repc.all_ok,
               "tight_ok": repc.tight_ok}
        assert repc.all_ok, (name, str(repc))
        for k, v in want.items():
            assert cc[k] == v, (name, cc)
        if pm == "bgs1":
            assert k6_shapes == [[208, 128], [80, 80]], k6_shapes
        row["ms"] = cuda_time_ms(call, warmup=1, iters=5)
        chol_rows[name] = row
    emit({"phase": "cholqr", "calls": chol_rows, "card": card})

    # 12. a numpy input with no device= runs on the card
    Qd, Rd = qr(a, policy=POLICY_MIXED)
    assert Qd.is_cuda and Rd.is_cuda, (Qd.device, Rd.device)
    emit({"phase": "device", "call": "qr(numpy 2048^2, POLICY_MIXED)",
          "q_device": str(Qd.device), "r_device": str(Rd.device)})

    emit({"kernels": [
        {"name": "ns_chain", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/ns_chain.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:335",
         "launches": main_launches["ns_chain"], "max_abs_err": ns_err,
         "ms": ns_rows["chain_mid"]["ms"],
         "plain_ms": ns_rows["chain_mid"]["plain_ms"],
         **ns_chain_bound(128, 6),
         "library_ms": lib_k1},
        {"name": "bgs_group_fused", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/bgs_group.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:900",
         "launches": main_launches["bgs_group_fused"],
         "max_abs_err": grp_err,
         "ms": grp_rows["bgs1_robust=True"]["ms"],
         "plain_ms": grp_rows["bgs1_robust=True"]["plain_ms"],
         **group_bound(2048, 128, iters, (False,) * 7 + (True,), True),
         "library_ms": lib_k2},
        {"name": "panel_qr_fused", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/panel_qr.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:501",
         "launches": c7["panel_qr_fused"], "max_abs_err": k3_err,
         "ms": k3_rows["uniform_robust"]["ms"],
         "plain_ms": k3_rows["uniform_robust"]["plain_ms"],
         **panel_qr_bound(4096, 128),
         "library_ms": lib_k3},
        {"name": "ninv_chain", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/ninv_chain.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:384",
         "launches": c9["ninv_chain"], "max_abs_err": k4_err,
         "ms": k4_rows["panel4096_it5"]["ms"],
         "plain_ms": k4_rows["panel4096_it5"]["plain_ms"],
         **ninv_chain_bound(128, 5),
         "library_ms": k4_rows["panel4096_it5"]["library_ms"]},
        {"name": "panel_factor_fused", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/panel_factor.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/panel.py:115",
         "launches": c10["panel_factor_fused"], "max_abs_err": k6_err,
         "ms": k6_rows["2048x128"]["ms"],
         "plain_ms": k6_rows["2048x128"]["plain_ms"],
         **panel_factor_bound(2048, 128),
         "library_ms": k6_rows["2048x128"]["library_ms"]},
        {"name": "sketch_qrcp_ranks", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/sketch_qrcp.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/sketch.py:88",
         "launches": c7["sketch_qrcp_ranks"], "max_abs_err": k7_err,
         "ms": k7_rows["w2048"]["ms"],
         "plain_ms": k7_rows["w2048"]["plain_ms"],
         **sketch_bound(136, 2048, 128),
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
