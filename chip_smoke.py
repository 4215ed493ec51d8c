"""Drive the PyTorch + CUDA port of the mixed-precision Block Gram-Schmidt QR
on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
last line):
  1. device   -- the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build    -- build (or load) the kernel library from csrc/;
  3. kernels  -- ns_chain and bgs_group_fused against their plain PyTorch
                 versions on the card at the main path's shapes, with the
                 stated tolerances, and both times (CUDA events, median of
                 20 calls);
  4. main     -- block_qr(A, 128, POLICY_MIXED_FAST, mode='complete',
                 panel_method='auto', quality='fast', check='defer') on the
                 2048^2 benchmark input (numpy seed 0, uniform - 0.5):
                 resolves to bgs1 / g8, two bgs_group_fused launches, quality
                 gates, time and TFLOP/s;
  5. qr       -- qr(A, policy=POLICY_MIXED): the 'balanced' (bgs2) default;
  6. band     -- block_qr as in phase 4 at 4096^2: the per-panel ns_chain
                 route.
Then a line with every kernel's launches on the main path (phases 4-6, one
call each), error and times, and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device it exits 2 and
prints no result.
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
        POLICY_MIXED,
        POLICY_MIXED_FAST,
        block_qr,
        metrics,
        qr,
    )
    from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
        resolve_panel_config,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        LAUNCHES,
        bgs_group_fused,
        bgs_group_fused_plain,
        ns_chain,
        ns_chain_plain,
        reset_launches,
    )
    from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32
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
    emit({"phase": "kernels", "kernel": "ns_chain", "r": 128,
          "tolerance": "max|diff| <= 1e-4 * max|plain| for X and t; same "
                       "canary class (resid < 1e-4)",
          "modes": ns_rows, "card": card})

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
    emit({"phase": "kernels", "kernel": "bgs_group_fused",
          "shape": [2048, 1024], "r": 128, "g": 8,
          "tolerance": "fp32 flags: max|dQ| <= 1e-4, ||dR||/||R|| <= 1e-4; "
                       "bf16 flags: ||dQ||/||Q||, ||dR||/||R|| <= 5e-3",
          "configs": grp_rows, "card": card})

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

    for k, n in main_launches.items():
        assert n > 0, f"kernel {k} was not launched on the main path"
    emit({"kernels": [
        {"name": "ns_chain", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/ns_chain.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:335",
         "launches": main_launches["ns_chain"], "max_abs_err": ns_err,
         "ms": ns_rows["chain_mid"]["ms"],
         "plain_ms": ns_rows["chain_mid"]["plain_ms"]},
        {"name": "bgs_group_fused", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/bgs_group.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:900",
         "launches": main_launches["bgs_group_fused"],
         "max_abs_err": grp_err,
         "ms": grp_rows["bgs1_robust=True"]["ms"],
         "plain_ms": grp_rows["bgs1_robust=True"]["plain_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
