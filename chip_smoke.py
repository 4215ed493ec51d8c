"""Drive the PyTorch + CUDA port of the mixed-precision blocked QR on one
NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
last line):
  1. device   -- the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build    -- build (or load) the kernel library from csrc/ (one nvcc
                 per source, in parallel);
  3. kernels  -- all nine kernels (ns_chain, bgs_group_fused,
                 panel_qr_fused, ninv_chain, panel_factor_fused,
                 sketch_qrcp_ranks, bgs_group_fused_proj, tiled_matmul,
                 chol_rinv) and the three Givens chains of the streaming
                 family (givens_fold_rows, givens_chain, givens_hessenberg:
                 G1 at n = 256 with 16, 8, 4, 2 and one rows and at 1100
                 with 4 and 2, G2 and G3 at m = n = 512, G3 at 1100, each
                 launched twice and compared bit for bit, G1 and G3 also
                 bit for bit with their plain versions, and once more at
                 phase 19's n = 2048; G1's and G3's clock build run once,
                 utils/givens_probe.py --phases) against their plain
                 PyTorch versions on the
                 card at the main paths' shapes, with the stated tolerances;
                 K1, K4, the combine, K3, K2 and K5 at r = 48, 100, 125
                 (the shared-memory route of the instantiation that holds
                 r) and 192, 256 (the L2 route) with their r = 128 rows'
                 tolerances, route, CTAs and a bitwise repeat
                 (utils/width_probe.py), K1, K4 and the combine alone also
                 at 129, 200, 512 and 1024 (utils/width_probe.py::
                 l2_edge_rows), K1 on the batched 4 x 256 stack (each
                 member bit for bit its single launch);
                 ns_chain at r = 32, 64, 128 in every option combination
                 the QR tiers use, bitwise repeatable, NaN in -> NaN resid,
                 beside torch.linalg.cholesky and beside cholesky + the
                 triangular inverse; its clock build run once
                 (-DMPBQR_NS_PROF, utils/ns_probe.py --phases: cycles by
                 slot a launch and an iteration, outputs bit for bit the
                 library's, and the L2 route's slots at r = 256 on 16
                 CTAs) and the serial floor from its measured cluster
                 exchange;
                 tiled_matmul on both routes (fed by TMA, predicated
                 loaders), the route of each call asserted; chol_rinv at
                 r = 32, 96, 128, 256, 320, 512 (shared-memory route) and
                 1024 (in place), with its cluster and route per r, on a
                 Gram of condition 1e6 and on an indefinite one;
                 panel_factor_fused at 2048, 4096, 3072 and 2176 x 128
                 (lstsq's panels, in shared memory), 8192 x 128 (in
                 place), 128 x 128, 208 x 128 and 80 x 80, a zero column
                 and a NaN, 6480 and 6481 x 128 (either side of the
                 shared-memory route's 16 x 405 rows), with its cluster,
                 rows per CTA and route, bitwise repeatable; its clock
                 build run once (-DMPBQR_PANEL_PROF, utils/panel_probe.py
                 --phases: 2048 and 8192 x 128, every slot of every CTA,
                 outputs bit for bit the library's); its batched entry on
                 64 x 1563 x 64,
                 8 x 512 x 128 and (wide) 4 x 1024 x 256 stacks against
                 the batched plain version, each member bit for bit a
                 single launch at the batch's layout, beside the loop of
                 single calls and torch.geqrf of the stack; the batched
                 entries of ns_chain (8 x 128 x 128 plain, shift, refine,
                 chain_mid; 4 x 256 x 256 on the L2 route, with resident
                 clusters and waves) and bgs_group_fused (8 x 2048 x 512
                 g4 with a robust last panel, bf16 flags on and off; 16 x
                 2048 x 512; 2 x 2048 x 1024 at r = 256; on the stack
                 route's products, csrc/stack_gemm.cu) against their plain
                 versions on the stack, each member bit for bit its single
                 call (K2: at the batch's layout), with K2's device time
                 by kind,
                 beside the loop of single calls, torch.linalg.cholesky /
                 torch.linalg.qr of the stack and the bound
                 (utils/batched_probe.py); the batched entry of
                 ninv_chain (Yamamoto S stacks 8 x 128 at 5 and 12
                 iterations, 16 x 128, 3 x 100, 4 x 256 and 8 x 256 on the
                 L2 route, with resident clusters and waves) against its
                 plain
                 version on the stack, each member bit for bit its single
                 launch, a NaN in member 2's S -> a NaN resid for member 2
                 only, beside the loop of single launches and
                 torch.linalg.inv of the stack;
                 sketch_qrcp_ranks on 136 x 2048, 1920, 200 and 8192 (in
                 place), 72 x 1024 (r = 64), 138 x 2048, 73 x 300, 700 x 256
                 and 700 x 1024 (in place), zero / duplicate, NaN and inf
                 columns and a 6-wide sketch, with its cluster and route,
                 bitwise repeatable and rank for rank the plain version's;
                 bgs_group_fused, bgs_group_fused_proj and panel_qr_fused
                 each launched twice and compared bit for bit, with their
                 product layout (ops/kernels/ns.py::group_layout) and the
                 device kernels and streams of one call (torch.profiler);
                 the combine that closes their robust panels on its own
                 (tri_combine, r = 128), twice, bit for bit; ninv_chain on
                 utils/ninv_probe.py's inputs (5 and 12 iterations, a
                 near-singular S), twice, bit for bit, with its cluster,
                 and NaN in S -> NaN resid; K4's L2 clock build run once
                 (-DMPBQR_NINV_PROF, utils/ninv_probe.py --phases --l2: r =
                 256, 5 iterations, every slot on each of the 16 CTAs,
                 outputs bit for bit the library's);
                 the kernel's,
                 the plain version's and the library call's times (CUDA
                 events, median of 20 unless a line says otherwise);
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
                 sketch_qrcp_ranks launches, and its two Householder
                 stages make 32 panel_factor_fused launches; checked
                 against the float64
                 np.linalg.lstsq oracle; pivoted_qr's contract; times of
                 lstsq and of pivoted_qr_qtb's two tiers;
  8. robust   -- block_qr(A, 128, POLICY_FP32, panel_method='householder')
                 on the 2048^2 input: the robust Householder tier, 16
                 panel_factor_fused launches, the metric triple and R
                 against a POLICY_FP64 'householder' run (plain loop);
  9. polar    -- block_qr(A, 128, POLICY_MIXED_FAST, mode='complete',
                 panel_method='auto', quality='fast') on a 4096 x 2048 input
                 resolves to polar / g8: 16 ns_chain and 16 ninv_chain
                 launches, quality within 2x of the JAX package's;
 10. pallas   -- block_qr(A, 128, POLICY_FP32,
                 panel_method='householder_pallas') at 2048^2: 16
                 panel_factor_fused launches, R against phase 8's (K6
                 against K6);
 11. cholqr   -- cholqr1 / cholqr2 / cholqr2s / cholqr1x2 at 2048^2 (one
                 panel_factor_fused launch each), cholqr1 scan (15
                 ninv_chain launches), and bgs1 on a 2000 x 2000 input
                 (resolves to cholqr1; K6 at 208 x 128 and 80 x 80);
 12. device   -- a numpy input with no device= runs on the card;
 13. proj_entry -- _block_qr_bgs on the 2048^2 input, POLICY_MIXED_FAST, g8,
                 with proj_entry=True: one bgs_group_fused and one
                 bgs_group_fused_proj launch, quality within 2x of phase
                 4's, R against the default route's; both routes' times;
 14. scan     -- (a) phase 4's call at 16384^2 resolves to bgs1 / scan:
                 3 x 128 ns_chain launches; (b) block_qr(A, 128,
                 POLICY_FP32, panel_method='bgs', loop_mode='scan') at
                 4096^2: 32 panel_qr_fused launches; (c) block_qr_resumable
                 on (b)'s input, stopped after 3 segments and called again:
                 torch.equal with (b), only step_32 left;
 15. exported -- tiled_matmul and chol_rinv through their own entry points:
                 CholeskyQR2 of a 4096 x 256 panel built from them, timed
                 beside the same panel with cholesky_ex + solve_triangular
                 in chol_rinv's place, and matmul_bf16_accum_f32 at 2048^3;
 16. tsqr     -- tsqr(A) on a 100000 x 64 input (numpy seed 0, uniform -
                 0.5): 64 leaves, 7 batched panel_factor_fused launches
                 (the 64 leaves, then one a tree level) for 127 panels, the
                 metric triple; its time and K6 device time beside
                 torch.linalg.qr and one panel_factor_fused call on the
                 whole panel (in place); lstsq(A, b, method='tsqr') against
                 float64 np.linalg.lstsq;
 17. refine   -- lstsq(J, b, refine_steps=2) on the full-rank
                 slam_jacobian(4096, 2048, seed=0): stored-factor CAQR (only
                 batched panel_factor_fused launches, one for each panel's
                 leaves and one a tree level, over all its leaves and
                 nodes: no reroute), x against float64 np.linalg.lstsq with
                 and without the sweeps, its time and K6 device time beside
                 method='blocked', the device events of the call and of
                 one apply_qt replay (one stacked application a panel's
                 leaves and one a tree level; torch.profiler);
                 lstsq_batched on 8 systems slam_jacobian(2048, 512, seed=i)
                 (the Householder driver on the whole stack: 4 batched
                 panel_factor_fused launches for 32 panels), each against
                 float64, its time beside the member loop of the same
                 driver and torch.linalg.lstsq on the stack, K6's device
                 time and each batched shape's layout and waves (the
                 refine call's too);
                 block_qr_batched on the same stack (block 128, POLICY_FP32,
                 'householder', reduced): 4 batched launches for 32
                 panels, each member all_ok and its R within 1e-5
                 relative of its single block_qr, a NaN in member 3
                 poisons R[3, 0, 0] and no other member, its time beside
                 the loop of 8 block_qr calls and torch.linalg.qr on the
                 stack; 3-D bf16 products (torch.bmm, fp32 output) against
                 each member's 2-D product;
 18. autodiff -- qr_autodiff on the first 1024 columns of phase 4's input,
                 POLICY_FP32 (resolves to bgs: bgs_group_fused in the
                 forward, no kernel in the backward): gA of a seeded weighted
                 loss against float64 torch.linalg.qr autograd on
                 sign-canonicalized factors, NaN in A -> NaN in gA, forward
                 and backward time beside fp32 torch.linalg.qr + autograd;
                 lstsq_autodiff's x and gradients in A and b against a
                 float64 oracle;
 19. streaming -- experiments/r10_incremental.py's cell on the port: the
                 complete factors of default_rng(0).random((n, n)) - 0.5;
                 at n = 1024 qr_rank1_update, qr_delete_col(k=7) then
                 qr_insert_col(k=7) (the script's order inserts into a
                 square factor, which both packages refuse),
                 qr_delete_row(k=0) (backward < 1e-5,
                 orthogonality < 1e-4) and qr_append_row (Gram < 1e-5); at
                 n = 1024 and 2048 each streaming call's time beside the
                 block_qr refactorizations (POLICY_FP32, POLICY_MIXED_FAST);
                 rls_init on phase 17's system, rls_update of 16 rows,
                 rls_solve against float64 and beside lstsq of the stacked
                 4112 x 2048 system; givens_qr at 512^2 (metric triple,
                 beside torch.linalg.qr); one G1 per rls_update and
                 qr_append_row, one G2 + one G3 per qr_rank1_update, one G2
                 per qr_insert_col and qr_delete_row, one G3 per
                 qr_delete_col, asserted call by call;
 20. dist     -- the distributed layer on a world of one rank over NCCL
                 (init_process_group with an in-process HashStore, no
                 network; make_mesh() on cuda): (a) dist_block_qr(A, mesh,
                 128, POLICY_MIXED_FAST, mode='reduced', quality='fast') on
                 phase 4's input (bgs1: K1 launches asserted, metric
                 triple), its time beside phase 4's block_qr, the NCCL
                 kernels' count and device time and the collectives' host
                 time (torch.profiler); (b) quality='balanced' at 16384^2
                 (bgs2, switched to scan), beside block_qr of the same
                 tier; (c) panel_method='householder', POLICY_FP32, on
                 phase 9's input, reduced and mode='r' with b: 16 K6 and
                 16 K4 each, R within 1e-4 of block_qr's 'householder' R
                 (row signs made nonnegative), x from back_substitution
                 within 1e-4 of float64 np.linalg.lstsq, and K4's LU
                 fallback timed in both forms (a host read of the
                 residual, kept; torch.where over both branches); (d)
                 tsqr_sharded 65536 x 64 with 8 local leaves (4 batched K6
                 for 15 panels) against tsqr; (e) block_qr_batched_sharded
                 8 x 1024 x 512 on a batch mesh (cholqr2 on the whole
                 stack; timed beside 8 block_qr calls) and
                 tsqr_batched_sharded_2d
                 4 x 16384 x 64 on a (1, 1) mesh, with CholeskyQR2 leaves
                 (no K6) and Householder leaves (one batched K6 for 4),
                 backward error per problem < 1e-5;
 21. widths   -- the calls that reach the kernels at other widths, each
                 with its launches and its phase's quality gate: (a) phase
                 4's call at block_size=256 (bgs1, g4: K2 at r = 256); (b)
                 2000^2 (seed 0, uniform - 0.5) at blocks 100 and 125
                 (bgs1: K2 at 100 / 125); (c) phase 9's polar call at
                 r = 256 (8 K1 + 8 K4 at 256); (d) lstsq(J, -b,
                 block_size=96) on phase 7's system (K6 at 96; the
                 reroute's RQRCP keeps its block of 128); (d2)
                 pivoted_qr_qtb(method='rqrcp', block_size=96) on a 4096 x
                 1920 gauge-deficient system and the min-norm solve (20 K3
                 and K7 at r = 96), against float64.
 22. dist2d   -- dist_block_qr_2d on a (1, 1) (rows, cols) mesh of phase
                 20's one-rank NCCL group, each case timed (CUDA events,
                 median of 5) beside the 1-D dist_block_qr on the same
                 input, its K1 / K4 / K6 launches asserted: (a) bgs1
                 POLICY_MIXED_FAST reduced on phase 4's input (20 K1: 14
                 plain panels, 2 robust x 3 chains), backward and
                 orthogonality at most 2x phase 20 (a)'s; (b) the
                 reflector tier, fp32, mode='r' with b on phase 9's input
                 (16 K6 + 16 K4), x within phase 20 (c)'s gate; (c)
                 cholqr2s, loop_mode='scan', mode='complete' on 2048 x
                 1024 fp32 (8 K4, 1 K6), backward and max|Q^T Q - I|
                 below 1e-5.
 23. cli      -- the command-line interface: cli.main in-process (qr, bench,
                 solve, dist with its own one-rank NCCL group, tsqr-bench,
                 dataset then qr --file through the native parser,
                 precision-study, plot) and one `python -m
                 mixedprecisionblockqr_tpu_torch qr --n 1024`; every call
                 exits 0, every printed JSON line parses, K1, K2 and K6
                 are launched.
 24. k6_widths -- K6 above 128 columns, through its wide route (sub-panels
                 of 128 by K6, joined by true-fp32 products; csrc/
                 panel_factor.cu): (k) 2048 x 256, 2000 x 200, 4096 x 512,
                 8192 x 256 (in-place sub-panels), 4096 x 2048, 1024 x 256
                 and 256 x 256 against the plain
                 version at phase 3's tolerance, bitwise repeatable, beside
                 torch.geqrf and the bound, with each sub-panel's layout;
                 (a) block_qr(A, 256, POLICY_FP32, 'householder_pallas')
                 and (b) 'householder' on phase 4's input: 16 K6 each, R
                 within 1e-4 relative of phase 8's POLICY_FP64 R; (c)
                 'cholqr1' at 256: all_ok, its last panel wide; (d)
                 lstsq(J, b, method='tsqr') on phase 17's system (one
                 4096 x 2048 leaf) against float64, beside phase 17's
                 times; (e) tsqr on 65536 x 256: 7 wide batched calls (14
                 K6 launches and 42 product launches, each over the
                 call's members) for 127 panels, metric triple within
                 2^-23 m, K6's and the products' device time, each batched
                 shape's layout and waves;
 25. bgs_batched -- the BGS tiers on the whole stack, only batched K1 /
                 K2 launches (counted): (a) block_qr_batched 8 x 2048^2
                 (member i from default_rng(i)) POLICY_MIXED_FAST bgs1, 4
                 batched K2 for 32 groups, every member all_ok and within
                 2x of its single block_qr, a NaN in member 3 poisons
                 member 3 only, beside the member loop and
                 torch.linalg.qr; (b) 8 x slam_jacobian(2048, 512, seed=i)
                 POLICY_FP32 bgs (R 1e-4 of each single call) and
                 POLICY_MIXED bgs2 (quality within 2x): 2 batched K2 + the
                 rescrub's batched K1; (c) 3 x 6144 x 512 bgs1 (m > 5120,
                 per-panel route): 6 batched K1, no K2; (d)
                 block_qr_batched_sharded 8 x 1024 x 512 'auto' under
                 POLICY_MIXED_FAST on one NCCL rank: 2 batched K2;
 26. polar_batched -- the polar tier on the whole stack, only batched K1
                 / K4 launches (counted): (a) block_qr_batched 8 x 4096 x
                 2048 (member i from default_rng(i), member 0 phase 9's
                 input) POLICY_MIXED_FAST complete: 16 batched K1 + 16
                 batched K4, every member all_ok and within 2x of its
                 single block_qr, a NaN in member 3 poisons member 3 only,
                 beside the member loop and torch.linalg.qr; (b) 8 x
                 1024^2 POLICY_FP32 complete (the robust tail panel, the
                 square final panel, the LU fallback): 10 batched K1 + 7
                 batched K4, R 1e-4 of each single call; (c)
                 block_qr_batched_sharded 'polar' 8 x 1024 x 512
                 POLICY_MIXED_FAST on one NCCL rank: 4 batched K1 + 4 K4.
Then a line with every kernel's launches on its main path (phases 4-6 for
ns_chain and bgs_group_fused, phase 7 for panel_qr_fused,
sketch_qrcp_ranks and panel_factor_fused, phase 9 for ninv_chain,
phase 13 for bgs_group_fused_proj, phase 15 for
tiled_matmul and chol_rinv, phase 19 for the Givens chains: each streaming
call once at n = 2048; phase 20's cases (a)-(d) add their launches of
ns_chain, ninv_chain and panel_factor_fused, phase 21's of the kernels its
calls run, phases 22, 23 and 24 theirs, K6's with its wide route's calls
and products, phases 25's and 26's; K6's batched entry with its launches
and panels on phases 16, 17 (refine, lstsq_batched, block_qr_batched),
20, 23 and 24, K1's with its launches and members on phases 25 and 26,
K2's on phase 25, K4's on phase 26; the widths
each kernel was held at; the counts are set to 0 just before each path
and read just after; phases 16-18 assert their own counts the same way),
error, times and bound, and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device it exits 2
and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

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


def bitwise_equal(xs, ys):
    return all(bool(torch.equal(x, y)) for x, y in zip(xs, ys))


def device_kernels(fn):
    """The device kernels (name -> count) and streams of one call of fn."""
    from mixedprecisionblockqr_tpu_torch.utils.group_probe import (
        device_breakdown,
    )

    row = device_breakdown(fn, calls=1)
    return {"device_kernels": {k: v["count"]
                               for k, v in row["kernels"].items()},
            "device_events": row["device_events"], "streams": row["streams"]}


def device_ms_by(fn, **groups):
    """Device ms and launches, per group, of the kernels whose names hold
    one of the group's words in one call of fn (``torch.profiler``, the
    last of two profiled calls): ``{group: {"ms", "launches"}}``; None for
    each when the profiles saw no device activity."""
    from mixedprecisionblockqr_tpu_torch.utils.group_probe import (
        device_breakdown,
    )

    try:
        kernels = device_breakdown(fn, calls=2)["kernels"]
    except RuntimeError:
        return {g: None for g in groups}
    out = {}
    for g, words in groups.items():
        hits = [v for k, v in kernels.items() if any(x in k for x in words)]
        out[g] = {"ms": sum(v["ms"] for v in hits),
                  "launches": sum(v["count"] for v in hits)}
    return out


def k6_device_ms(fn):
    """Device ms of the K6 kernels (single and batched launches alike) in
    one call of fn (``device_ms_by``); None when the profiles saw no
    device activity."""
    row = device_ms_by(fn, k6=("panel_factor_kernel",))["k6"]
    return row and row["ms"]


def max_abs(a, b):
    return float((a - b).abs().max())


def solve_errors(a, b, x):
    """A least-squares solution x (on the card) of the numpy system (a, b)
    against float64 np.linalg.lstsq (rcond = eps_f32 * m): relative
    residual difference and relative x error, with the oracle's rank."""
    m = a.shape[0]
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    x_o, _, rank_o, _ = np.linalg.lstsq(
        a64, b64, rcond=float(np.finfo(np.float32).eps) * m)
    x64 = x.detach().double().cpu().numpy()
    res_o = float(np.linalg.norm(a64 @ x_o - b64))
    res_x = float(np.linalg.norm(a64 @ x64 - b64))
    return {"rank_oracle": int(rank_o), "resid": res_x, "resid_oracle": res_o,
            "resid_rel": abs(res_x - res_o) / res_o,
            "x_rel_err": float(np.linalg.norm(x64 - x_o)
                               / np.linalg.norm(x_o))}


#: The batched entries on the main paths: K6's (phases 16, 17, 20, 23 and
#: 24), K1's (phases 25 and 26), K2's (phase 25) and K4's (phase 26): their
#: launches and the panels, chains, groups or inverses they ran, summed
#: over the counted calls.
BATCHED = {k: {"launches": 0, "members": 0}
           for k in ("panel_factor_fused", "ns_chain", "bgs_group_fused",
                     "ninv_chain")}


def batched_counts(main_path=False, kernel="panel_factor_fused"):
    """The batched entry of ``kernel``: its launches and members since the
    counts were last set to 0 (``ns.BATCH_LAUNCHES`` / ``BATCH_MEMBERS``).
    With ``main_path`` every batched entry's counts are added to
    ``BATCHED`` (call it once a path)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        BATCH_LAUNCHES,
        BATCH_MEMBERS,
    )

    if main_path:
        for k, tot in BATCHED.items():
            tot["launches"] += BATCH_LAUNCHES[k]
            tot["members"] += BATCH_MEMBERS[k]
    return {"launches": BATCH_LAUNCHES[kernel],
            "members": BATCH_MEMBERS[kernel]}


def _counter():
    """``(counted, total)``: ``counted(fn)`` runs fn with the launch counts
    set to 0 just before it and read just after it, returns ``(out, the
    nonzero counts)`` and adds those to ``total``.  A batched entry's
    launches and members (K6, K1, K2, K4), where nonzero, are among the counts
    as ``<kernel>_batched`` and ``<kernel>_members`` (its launches count
    under ``<kernel>`` too)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        BATCH_LAUNCHES,
        BATCH_MEMBERS,
        LAUNCHES,
        reset_launches,
    )

    total = {}

    def counted(fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        c = {k: v for k, v in LAUNCHES.items() if v}
        batched_counts(main_path=True)
        for k, v in BATCH_LAUNCHES.items():
            if v:
                c[f"{k}_batched"] = v
                c[f"{k}_members"] = BATCH_MEMBERS[k]
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        return out, c

    return counted, total


def triple(rep):
    """The metric triple of a report, with its two gates."""
    return {"backward": rep.backward, "orthogonality": rep.orthogonality,
            "lower_trapezoid": rep.lower_trapezoid,
            "all_ok": rep.all_ok, "tight_ok": rep.tight_ok}


def phase_dist(A, ms_block_qr, dev, card):
    """Phase 20: the distributed entry points on a one-rank NCCL mesh (the
    process group is started by the caller).  Returns ``(row, launches)``:
    the phase's line and the K1 / K4 / K6 launches of cases (a)-(e), each
    counted from 0 just before its call."""
    from unittest import mock

    from mixedprecisionblockqr_tpu_torch import (
        POLICY_FP32,
        POLICY_MIXED_FAST,
        back_substitution,
        block_qr,
        block_qr_batched_sharded,
        dist_block_qr,
        make_mesh,
        metrics,
        tsqr,
        tsqr_batched_sharded_2d,
        tsqr_sharded,
    )
    from mixedprecisionblockqr_tpu_torch.ops.cholqr import lu_inv
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import ninv_chain
    from mixedprecisionblockqr_tpu_torch.parallel import dist_qr
    from mixedprecisionblockqr_tpu_torch.utils.group_probe import (
        device_breakdown,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    def host_collectives(fn):
        """Host-side profiler events of the collectives in one call of
        fn: name -> (count, CPU ms including children)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as p:
            fn()
            torch.cuda.synchronize()
        return {e.key: (e.count, e.cpu_time_total / 1e3)
                for e in p.key_averages()
                if "nccl" in e.key.lower() or "c10d" in e.key.lower()}

    keys = ("ns_chain", "ninv_chain", "panel_factor_fused")
    counted, total = _counter()
    mesh = make_mesh()
    row = {"world_size": dist.get_world_size(),
           "backend": dist.get_backend()}

    # (a) bgs1 at 2048^2 beside phase 4's block_qr.
    def fast(x):
        return dist_block_qr(x, mesh, 128, POLICY_MIXED_FAST,
                             mode="reduced", quality="fast")

    (Qa, Ra), ca = counted(lambda: fast(A))
    rep = metrics.evaluate(A, Qa, Ra, POLICY_MIXED_FAST.precision_bits)
    assert rep.all_ok, str(rep)
    assert ca.get("ns_chain", 0) > 0, ca
    prof = device_breakdown(lambda: fast(A), calls=1)
    nccl = {k: v for k, v in prof["kernels"].items() if "nccl" in k.lower()}
    host_coll = host_collectives(lambda: fast(A))
    row["a"] = {
        "call": "dist_block_qr(A, mesh, 128, POLICY_MIXED_FAST, "
                "mode='reduced', quality='fast') 2048^2 (bgs1, unrolled)",
        "launches": ca, **triple(rep),
        "ms": cuda_time_ms(lambda: fast(A), warmup=2, iters=10),
        "block_qr_ms": ms_block_qr, "block_qr_call": "phase 4",
        "nccl_kernels": sum(v["count"] for v in nccl.values()),
        "nccl_ms": sum(v["ms"] for v in nccl.values()),
        "nccl_by_name": nccl, "host_collectives": host_coll,
        "device_busy_ms": prof["busy_ms"],
        "idle_share": prof["idle_share"],
        "device_events": prof["device_events"]}
    del Qa, Ra

    # (b) bgs2 at 16384^2: the unrolled tier's 128 panels switch to scan.
    a16 = np.random.default_rng(0).random((16384, 16384),
                                          dtype=np.float32) - 0.5
    A16 = torch.from_numpy(a16).to(dev)
    del a16

    def balanced(x):
        return dist_block_qr(x, mesh, 128, POLICY_MIXED_FAST,
                             mode="reduced", quality="balanced")

    def balanced_one(x):
        return block_qr(x, 128, POLICY_MIXED_FAST, mode="reduced",
                        panel_method="auto", quality="balanced")

    (Qb, Rb), cb = counted(lambda: balanced(A16))
    rep = metrics.evaluate(A16, Qb, Rb, POLICY_MIXED_FAST.precision_bits)
    assert rep.all_ok, str(rep)
    assert cb.get("ns_chain", 0) > 0, cb
    del Qb, Rb
    row["b"] = {
        "call": "dist_block_qr(A, mesh, 128, POLICY_MIXED_FAST, "
                "mode='reduced', quality='balanced') 16384^2 (bgs2, scan, "
                "g4)", "launches": cb, **triple(rep),
        "ms": cuda_time_ms(lambda: balanced(A16), warmup=1, iters=3),
        "block_qr_ms": cuda_time_ms(lambda: balanced_one(A16), warmup=1,
                                    iters=3),
        "block_qr_call": "block_qr(A, 128, POLICY_MIXED_FAST, "
                         "mode='reduced', panel_method='auto', "
                         "quality='balanced') (bgs2, scan, g4)",
        "timing": "median of 3"}
    del A16
    torch.cuda.empty_cache()

    # (c) the reflector tier, fp32, on phase 9's input: K6 and K4 once a
    # panel; R against the single-device 'householder' R (row signs made
    # nonnegative: the Yamamoto sign fix flips some), x against float64.
    a9 = np.random.default_rng(0).random((4096, 2048), dtype=np.float32) - 0.5
    b9 = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    A9, B9 = torch.from_numpy(a9).to(dev), torch.from_numpy(b9).to(dev)

    def refl(x):
        return dist_block_qr(x, mesh, 128, POLICY_FP32, mode="reduced",
                             panel_method="householder")

    def refl_r(x, y):
        return dist_block_qr(x, mesh, 128, POLICY_FP32, mode="r", b=y,
                             panel_method="householder")

    def canon(R):
        return R * torch.where(torch.diagonal(R) < 0, -1.0, 1.0)[:, None]

    (Qc, Rc), cc = counted(lambda: refl(A9))
    (Rr, qtb), cr = counted(lambda: refl_r(A9, B9))
    for c in (cc, cr):
        assert c.get("panel_factor_fused") == 16, c
        assert c.get("ninv_chain") == 16, c
    rep = metrics.evaluate(A9, Qc, Rc, POLICY_FP32.precision_bits)
    assert rep.all_ok, str(rep)
    R1 = block_qr(A9, 128, POLICY_FP32, mode="r",
                  panel_method="householder")
    r_rel = rel_fro(canon(Rc), canon(R1))
    assert r_rel <= 1e-4, r_rel
    rr_rel = rel_fro(Rr, Rc)
    assert rr_rel <= 1e-5, rr_rel
    x9 = back_substitution(Rr, qtb[:2048, 0])
    sol = solve_errors(a9, b9, x9)
    assert sol["x_rel_err"] <= 1e-4, sol

    def s_inverse_where(S):
        Xn, nresid = ninv_chain(S.float().contiguous(), iters=12)
        return torch.where(nresid < 1e-3, Xn, lu_inv(S.float()))

    prof_c = device_breakdown(lambda: refl(A9), calls=1)
    forms = {}
    for form in ("sync", "where", "where", "sync"):
        if form == "where":
            with mock.patch.object(dist_qr, "_s_inverse", s_inverse_where):
                ms = cuda_time_ms(lambda: refl(A9), warmup=1, iters=5)
        else:
            ms = cuda_time_ms(lambda: refl(A9), warmup=1, iters=5)
        forms.setdefault(form + "_ms", []).append(ms)
    row["c"] = {
        "call": "dist_block_qr(A, mesh, 128, POLICY_FP32, mode='reduced' "
                "and mode='r' with b, panel_method='householder') 4096 x "
                "2048 (phase 9's input; b default_rng(1))",
        "launches": cc, "launches_mode_r": cr, **triple(rep),
        "r_rel_vs_block_qr_householder": r_rel,
        "r_rel_mode_r_vs_reduced": rr_rel, **sol,
        "ms": statistics.median(forms["sync_ms"]),
        "block_qr_ms": cuda_time_ms(
            lambda: block_qr(A9, 128, POLICY_FP32, mode="reduced",
                             panel_method="householder"),
            warmup=1, iters=5),
        "k4_fallback_forms": forms,
        "profile": {k: prof_c[k] for k in (
            "busy_ms", "idle_share", "device_events")},
        "largest": dict(list(prof_c["kernels"].items())[:5]),
        "k4_fallback_note": "sync: a host read of the residual, the LU "
                            "inverse only when needed (dist_qr._s_inverse); "
                            "where: torch.where over K4's result and the "
                            "LU inverse of every panel; alternating sync, "
                            "where, where, sync, each a median of 5"}
    del Qc, Rc, Rr, A9, B9

    # (d) TSQR over the rows axis, 8 local leaves: one batched K6 for the
    # 8 leaves and one for each of the 3 tree levels' 4 + 2 + 1 pairs.
    a_d = np.random.default_rng(0).random((65536, 64), dtype=np.float32) - 0.5
    A_d = torch.from_numpy(a_d).to(dev)
    (Qd, Rd), cd = counted(lambda: tsqr_sharded(A_d, mesh, local_leaves=8))
    assert (cd.get("panel_factor_fused") == 4
            and cd.get("panel_factor_fused_batched") == 4
            and cd.get("panel_factor_fused_members") == 15), cd
    Qt, Rt = tsqr(A_d, n_leaves=8)
    d_rel = rel_fro(Rd, Rt)
    assert d_rel <= 1e-4, d_rel
    rep = metrics.evaluate(A_d, Qd, Rd, POLICY_FP32.precision_bits)
    assert rep.all_ok, str(rep)
    row["d"] = {"call": "tsqr_sharded(A, mesh, local_leaves=8) 65536 x 64",
                "launches": cd, **triple(rep), "r_rel_vs_tsqr": d_rel,
                "ms": cuda_time_ms(
                    lambda: tsqr_sharded(A_d, mesh, local_leaves=8),
                    warmup=1, iters=5),
                "tsqr_ms": cuda_time_ms(lambda: tsqr(A_d, n_leaves=8),
                                        warmup=1, iters=5)}
    del Qd, Rd, Qt, Rt, A_d

    # (e) batched problems: a batch mesh, and a (1, 1) batch x rows mesh.
    def backward_each(A_, Q_, R_):
        return max(float(metrics.backward_error(a_, q_, r_))
                   for a_, q_, r_ in zip(A_, Q_, R_))

    bmesh = make_mesh((1,), ("batch",))
    A_e = torch.from_numpy(np.random.default_rng(0).random(
        (8, 1024, 512), dtype=np.float32) - 0.5).to(dev)
    (Qe, Re), ce = counted(lambda: block_qr_batched_sharded(A_e, bmesh))
    be = backward_each(A_e, Qe, Re)
    assert be < 1e-5, be
    ms_e = cuda_time_ms(lambda: block_qr_batched_sharded(A_e, bmesh),
                        warmup=1, iters=5)
    ms_e_loop = cuda_time_ms(
        lambda: [block_qr(a_, 128, POLICY_FP32, panel_method="cholqr2")
                 for a_ in A_e], warmup=1, iters=5)
    mesh2 = make_mesh((1, 1), ("batch", "rows"))
    A_f = torch.from_numpy(np.random.default_rng(0).random(
        (4, 16384, 64), dtype=np.float32) - 0.5).to(dev)
    # its default CholeskyQR2 leaves run no K6; Householder leaves run one
    # batched K6 for the rank's 4 leaves
    (Qf, Rf), cf = counted(lambda: tsqr_batched_sharded_2d(A_f, mesh2))
    assert "panel_factor_fused" not in cf, cf
    bf = backward_each(A_f, Qf, Rf)
    assert bf < 1e-5, bf
    (Qh, Rh), ch = counted(lambda: tsqr_batched_sharded_2d(
        A_f, mesh2, leaf_method="householder"))
    assert (ch.get("panel_factor_fused") == 1
            and ch.get("panel_factor_fused_members") == 4), ch
    bh = backward_each(A_f, Qh, Rh)
    assert bh < 1e-5, bh
    row["e"] = {"call": "block_qr_batched_sharded 8 x 1024 x 512 (batch "
                        "mesh); tsqr_batched_sharded_2d 4 x 16384 x 64 "
                        "((1, 1) batch x rows mesh), CholeskyQR2 leaves "
                        "(the default) and Householder leaves",
                "launches": ce, "launches_2d": cf,
                "ms_batched_sharded": ms_e,
                "ms_member_loop_block_qr": ms_e_loop,
                "launches_2d_householder": ch,
                "max_backward": be, "max_backward_2d": bf,
                "max_backward_2d_householder": bh,
                "ms_2d_householder": cuda_time_ms(
                    lambda: tsqr_batched_sharded_2d(
                        A_f, mesh2, leaf_method="householder"),
                    warmup=1, iters=5)}
    del Qh, Rh
    c20 = {k: total.get(k, 0) for k in keys}
    for k in keys:
        assert c20[k] > 0, f"{k} was not launched on the dist path"
    row["launches"] = c20
    row["tolerance"] = ("(a), (b) metric triple within 2^-8 m; (c) triple "
                        "within 2^-23 m, R 1e-4 relative of block_qr's "
                        "'householder' R, x 1e-4 relative of float64 "
                        "np.linalg.lstsq; (d) R 1e-4 of tsqr's, triple "
                        "within 2^-23 m; (e) backward < 1e-5 per problem; "
                        "times: CUDA events, median of 10 (a), 3 (b), "
                        "5 (c, d, e)")
    return row, c20


def phase_widths(A, A9, J, b, Jn, bn, head, polar, dev, card):
    """Phase 21: the calls that reached a kernel at a width it refused
    before every width ran, each with its launches (counts set to 0 just
    before the call, read just after) and the quality gate of its phase.
    ``head`` and ``polar`` are phase 4's and phase 9's ``(report, ms)`` on
    ``A`` and ``A9``; ``J``, ``b`` (on the card), ``Jn``, ``bn`` (numpy)
    phase 7's system.  Returns
    ``(row, launches)``: the phase's line and the launches of all its
    calls, by kernel."""
    from mixedprecisionblockqr_tpu_torch import (
        POLICY_MIXED_FAST,
        back_substitution,
        block_qr,
        lstsq,
        metrics,
        numerical_rank,
        pivoted_qr_qtb,
        qr,
    )
    from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
        resolve_panel_config,
    )
    from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32
    from mixedprecisionblockqr_tpu_torch.utils.datagen import (
        gauge_deficient_system,
    )
    from mixedprecisionblockqr_tpu_torch.utils.flops import qr_flops
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    bits = POLICY_MIXED_FAST.precision_bits
    counted, total = _counter()

    def fast(r):
        def call(x):
            return block_qr(x, r, POLICY_MIXED_FAST, mode="complete",
                            panel_method="auto", quality="fast",
                            check="defer")
        return call

    # (a) the headline call at block_size=256: bgs1 with g shrunk to 4
    # (8 panels), so K2 runs at r = 256 (the L2 route's chains).
    assert resolve_panel_config(
        2048, 2048, 256, POLICY_MIXED_FAST, "auto", "unroll", 4,
        mode="complete", on_gpu=True, quality="fast",
    ) == ("bgs1", "unroll", 8)
    (Qa, Ra), ca = counted(lambda: fast(256)(A))
    rep_a = metrics.evaluate(A, Qa, Ra, bits)
    assert ca.get("bgs_group_fused") == 2, ca
    assert rep_a.all_ok and rep_a.tight_ok, str(rep_a)
    assert rep_a.backward <= 2 * head[0].backward, (str(rep_a), head)
    assert rep_a.orthogonality <= 2 * head[0].orthogonality, str(rep_a)
    ms_a = cuda_time_ms(lambda: fast(256)(A), warmup=2, iters=20)
    row = {"a": {"call": "block_qr(A, 256, POLICY_MIXED_FAST, "
                         "mode='complete', panel_method='auto', "
                         "quality='fast', check='defer') 2048^2 (phase 4's "
                         "input)", "resolved": ["bgs1", "unroll", 8],
                 "group_panels_run": 4, "launches": ca, **triple(rep_a),
                 "ms": ms_a, "tflops": qr_flops(2048, 2048)
                 / (ms_a * 1e-3) / 1e12, "block_size_128_ms": head[1],
                 "block_size_128_backward": head[0].backward,
                 "block_size_128_orthogonality": head[0].orthogonality}}

    # (b) the reference's Euroc-MAV size, 2000^2, at blocks 100 and 125:
    # 128 does not divide 2000 (cholqr1); 100 and 125 do, and resolve to
    # bgs1 g8, so K2 runs at r = 100 and 125 (R = 128, zeros beyond r;
    # 125-wide rows are not 16-byte aligned).
    a2 = np.random.default_rng(0).random((2000, 2000), dtype=np.float32) - 0.5
    A2 = torch.from_numpy(a2).to(dev)
    row["b"] = {}
    for r in (100, 125):
        assert resolve_panel_config(
            2000, 2000, r, POLICY_MIXED_FAST, "auto", "unroll", 4,
            mode="complete", on_gpu=True, quality="fast",
        ) == ("bgs1", "unroll", 8), r
        (Qb, Rb), cb = counted(lambda: fast(r)(A2))
        rep_b = metrics.evaluate(A2, Qb, Rb, bits)
        assert cb.get("bgs_group_fused", 0) >= 2, (r, cb)
        assert rep_b.all_ok and rep_b.tight_ok, (r, str(rep_b))
        ms_b = cuda_time_ms(lambda: fast(r)(A2), warmup=2, iters=20)
        row["b"][str(r)] = {"launches": cb, **triple(rep_b), "ms": ms_b,
                            "tflops": qr_flops(2000, 2000)
                            / (ms_b * 1e-3) / 1e12}
    row["b"]["call"] = ("block_qr(A, r, POLICY_MIXED_FAST, "
                        "mode='complete', panel_method='auto', "
                        "quality='fast', check='defer') 2000^2, numpy "
                        "seed 0 uniform - 0.5, r = 100 and 125 "
                        "(bgs1, g8)")

    # (c) polar on phase 9's 4096 x 2048 input at r = 256: K1 and K4 at
    # 256, one each a panel.
    assert resolve_panel_config(
        4096, 2048, 256, POLICY_MIXED_FAST, "auto", "unroll", 4,
        mode="complete", on_gpu=True, quality="fast",
    ) == ("polar", "unroll", 8)
    (Qc, Rc), cc = counted(lambda: fast(256)(A9))
    rep_c = metrics.evaluate(A9, Qc, Rc, bits)
    assert cc.get("ns_chain") == 8 and cc.get("ninv_chain") == 8, cc
    assert rep_c.all_ok, str(rep_c)
    assert rep_c.backward <= 2 * polar[0].backward, (str(rep_c), polar)
    assert rep_c.orthogonality <= 2 * polar[0].orthogonality, str(rep_c)
    ms_c = cuda_time_ms(lambda: fast(256)(A9), warmup=1, iters=10)
    row["c"] = {"call": "block_qr(A9, 256, ...) as phase 9, 4096 x 2048",
                "resolved": ["polar", "unroll", 8], "launches": cc,
                **triple(rep_c), "ms": ms_c,
                "tflops": qr_flops(4096, 2048) / (ms_c * 1e-3) / 1e12,
                "block_size_128_ms": polar[1],
                "block_size_128_backward": polar[0].backward,
                "block_size_128_orthogonality": polar[0].orthogonality}

    # (d) lstsq(J, -b, block_size=96) on phase 7's gauge-deficient
    # Jacobian: block_qr_qtb's Householder panels at w = 96 (K6), then the
    # tripwire's lstsq_pivoted, whose RQRCP keeps its own block of 128 in
    # both packages (K3, K7).  Phase 7's gate.
    x_d, cd = counted(lambda: lstsq(J, -b, block_size=96))
    err_d = solve_errors(Jn, -bn, x_d)
    assert err_d["rank_oracle"] == 1984, err_d
    assert err_d["x_rel_err"] <= 1e-4 and err_d["resid_rel"] <= 1e-5, err_d
    assert cd.get("panel_factor_fused", 0) > 0, cd
    assert cd.get("panel_qr_fused", 0) > 0, cd
    ms_d = cuda_time_ms(lambda: lstsq(J, -b, block_size=96),
                        warmup=1, iters=5)
    row["d"] = {"call": "lstsq(J, -b, block_size=96), J = phase 7's "
                        "4096 x 2048 gauge-deficient Jacobian",
                "launches": cd, **err_d, "ms": ms_d}

    # (d2) RQRCP itself at block_size=96: a gauge-deficient system whose
    # 1920 columns are 20 panels of 96, pivoted_qr_qtb(method='rqrcp',
    # block_size=96) (K3, with its chains and combine, and K7 at r = 96),
    # then lstsq_pivoted's min-norm solve on that factor.
    Jn2, bn2 = gauge_deficient_system(4096, 1920, 64)
    J2 = torch.from_numpy(Jn2).to(dev)
    b2 = torch.from_numpy(bn2).to(dev)

    def solve96():
        R, qtb, perm = pivoted_qr_qtb(J2, -b2, method="rqrcp",
                                      block_size=96)
        k = numerical_rank(R, m=4096)
        Z, T = qr(R[:k, :].T, mode="reduced", panel_method="householder")
        y = mm_f32(Z, back_substitution(T.T, qtb[:k, None], lower=True))
        x = torch.zeros_like(y)
        x[perm] = y
        return x[:, 0], k

    (x_e, k_e), ce = counted(solve96)
    err_e = solve_errors(Jn2, -bn2, x_e)
    assert k_e == err_e["rank_oracle"] == 1856, (k_e, err_e)
    assert err_e["x_rel_err"] <= 1e-4 and err_e["resid_rel"] <= 1e-5, err_e
    assert ce.get("panel_qr_fused") == 20, ce
    assert ce.get("sketch_qrcp_ranks", 0) > 0, ce
    ms_e = cuda_time_ms(lambda: solve96(), warmup=1, iters=5)
    row["d2"] = {"call": "pivoted_qr_qtb(J2, -b2, method='rqrcp', "
                         "block_size=96) and lstsq_pivoted's min-norm solve, "
                         "J2, b2 = gauge_deficient_system(4096, 1920, 64)",
                 "launches": ce, "rank": k_e, **err_e, "ms": ms_e}
    row["launches"] = total
    row["tolerance"] = (
        "(a) metric triple all_ok and tight_ok, backward and orthogonality "
        "at most 2x phase 4's (block 128); (b) all_ok and tight_ok; (c) "
        "all_ok, backward and orthogonality at most 2x phase 9's; (d), "
        "(d2) rank equal to float64 np.linalg.lstsq's, residual 1e-5 and x "
        "1e-4 relative; times: CUDA events, median of 20 (a, b), 10 (c), "
        "5 (d)")
    return row, total


def phase_dist2d(A, row20, dev):
    """Phase 22: ``dist_block_qr_2d`` on a (1, 1) mesh of the one-rank NCCL
    group phase 20 started, each case beside the 1-D ``dist_block_qr`` on
    the same input.  Returns ``(row, launches)``: the phase's line and the
    K1 / K4 / K6 launches of its three cases."""
    from mixedprecisionblockqr_tpu_torch import (
        POLICY_FP32,
        POLICY_MIXED_FAST,
        back_substitution,
        dist_block_qr,
        make_mesh,
        metrics,
    )
    from mixedprecisionblockqr_tpu_torch.parallel import dist_block_qr_2d
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    keys = ("ns_chain", "ninv_chain", "panel_factor_fused")
    counted, total = _counter()

    def timed(fn):
        return cuda_time_ms(fn, warmup=1, iters=5)

    mesh2 = make_mesh((1, 1), ("rows", "cols"))
    mesh1 = make_mesh()
    row = {"mesh": dict(zip(mesh2.mesh_dim_names, mesh2.shape)),
           "backend": dist.get_backend()}

    # (a) bgs1 on phase 4's input: 14 plain panels (one K1 each) and the 2
    # robust tail panels (three K1 each).
    def bgs1_2d():
        return dist_block_qr_2d(A, mesh2, 128, POLICY_MIXED_FAST,
                                panel_method="bgs1", mode="reduced")

    def bgs1_1d():
        return dist_block_qr(A, mesh1, 128, POLICY_MIXED_FAST,
                             mode="reduced", panel_method="bgs1")

    (Qa, Ra), ca = counted(bgs1_2d)
    assert ca == {"ns_chain": 20}, ca
    rep = metrics.evaluate(A, Qa, Ra, POLICY_MIXED_FAST.precision_bits)
    ref = row20["a"]
    assert rep.all_ok, str(rep)
    assert rep.backward <= 2 * ref["backward"], (rep.backward, ref)
    assert rep.orthogonality <= 2 * ref["orthogonality"], (
        rep.orthogonality, ref)
    del Qa, Ra
    row["a"] = {
        "call": "dist_block_qr_2d(A, mesh (1, 1), 128, POLICY_MIXED_FAST, "
                "panel_method='bgs1', mode='reduced') 2048^2 (phase 4's "
                "input)", "launches": ca, **triple(rep),
        "phase20_a": {"backward": ref["backward"],
                      "orthogonality": ref["orthogonality"]},
        "ms": timed(bgs1_2d), "dist_block_qr_ms": timed(bgs1_1d),
        "dist_block_qr_call": "dist_block_qr(A, mesh, 128, "
                              "POLICY_MIXED_FAST, mode='reduced', "
                              "panel_method='bgs1')"}

    # (b) the reflector tier on phase 9's input with b: K6 and K4 once a
    # panel; x against float64.
    a9 = np.random.default_rng(0).random((4096, 2048), dtype=np.float32) - 0.5
    b9 = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    A9, B9 = torch.from_numpy(a9).to(dev), torch.from_numpy(b9).to(dev)

    def refl_2d():
        return dist_block_qr_2d(A9, mesh2, 128, POLICY_FP32, b=B9)

    def refl_1d():
        return dist_block_qr(A9, mesh1, 128, POLICY_FP32, mode="r", b=B9,
                             panel_method="householder")

    (Rb, qtb), cb = counted(refl_2d)
    assert cb == {"panel_factor_fused": 16, "ninv_chain": 16}, cb
    sol = solve_errors(a9, b9, back_substitution(Rb, qtb[:2048, 0]))
    assert sol["x_rel_err"] <= 1e-4, sol
    r_rel = rel_fro(Rb, refl_1d()[0])
    assert r_rel <= 1e-4, r_rel
    row["b"] = {
        "call": "dist_block_qr_2d(A, mesh (1, 1), 128, POLICY_FP32, b=b) "
                "(householder, mode='r') 4096 x 2048 (phase 9's input; b "
                "default_rng(1))", "launches": cb, **sol,
        "r_rel_vs_dist_block_qr": r_rel,
        "ms": timed(refl_2d), "dist_block_qr_ms": timed(refl_1d),
        "dist_block_qr_call": "dist_block_qr(A, mesh, 128, POLICY_FP32, "
                              "mode='r', b=b, panel_method='householder')"}
    del Rb, qtb, A9, B9

    # (c) shifted CholeskyQR2 leaves, the full-width scan loop and the
    # complete Q^T: one K4 a panel, one K6 for the last (Householder) panel.
    a_c = np.random.default_rng(0).random((2048, 1024), dtype=np.float32) - 0.5
    A_c = torch.from_numpy(a_c).to(dev)

    def scan_2d():
        return dist_block_qr_2d(A_c, mesh2, 128, POLICY_FP32,
                                panel_method="cholqr2s", loop_mode="scan",
                                mode="complete")

    def scan_1d():
        return dist_block_qr(A_c, mesh1, 128, POLICY_FP32, mode="complete",
                             panel_method="cholqr2s", loop_mode="scan")

    (Qt, Rc), cc = counted(scan_2d)
    assert cc == {"ninv_chain": 8, "panel_factor_fused": 1}, cc
    Q = Qt.T
    back = float(metrics.backward_error(A_c, Q[:, :1024], Rc))
    orth = float(metrics.orthogonality_error(Q))
    assert back < 1e-5 and orth < 1e-5, (back, orth)
    del Qt, Q, Rc
    row["c"] = {
        "call": "dist_block_qr_2d(A, mesh (1, 1), 128, POLICY_FP32, "
                "panel_method='cholqr2s', loop_mode='scan', "
                "mode='complete') 2048 x 1024 (default_rng(0) uniform - "
                "0.5)", "launches": cc, "backward": back,
        "orthogonality_max_QtQ_minus_I": orth,
        "ms": timed(scan_2d), "dist_block_qr_ms": timed(scan_1d),
        "dist_block_qr_call": "dist_block_qr(A, mesh, 128, POLICY_FP32, "
                              "mode='complete', panel_method='cholqr2s', "
                              "loop_mode='scan')"}
    del A_c
    c22 = {k: total.get(k, 0) for k in keys}
    for k in keys:
        assert c22[k] > 0, f"{k} was not launched on the 2-D path"
    row["launches"] = c22
    row["tolerance"] = (
        "(a) all_ok, backward and orthogonality at most 2x phase 20 (a)'s; "
        "(b) x 1e-4 relative of float64 np.linalg.lstsq (phase 20 (c)'s "
        "gate), R 1e-4 relative of dist_block_qr's; (c) backward and "
        "max|Q^T Q - I| below 1e-5; times: CUDA events, median of 5")
    return row, c22


def phase_cli(ms_headline):
    """Phase 23: the command-line interface, in-process through
    ``cli.main`` and once through ``python -m``.  Returns ``(row,
    launches)``: the phase's line and the kernel launches of its calls."""
    from mixedprecisionblockqr_tpu_torch import cli
    from mixedprecisionblockqr_tpu_torch.native import euroc_native
    from mixedprecisionblockqr_tpu_torch.native.build import build

    counted, total = _counter()
    with tempfile.TemporaryDirectory(prefix="mpbqr_cli_") as tmp:
        row = _cli_calls(tmp, counted, ms_headline, cli, euroc_native, build)
    c23 = dict(total)
    for k in ("ns_chain", "bgs_group_fused", "panel_factor_fused"):
        assert c23.get(k, 0) > 0, f"{k} was not launched through the CLI"
    row["launches"] = c23
    row["tolerance"] = ("every call exits 0 and its JSON lines parse; bench "
                        "criteria_ok; tsqr-bench backward < 1e-5; the "
                        "Euroc file read by the native parser")
    return row, c23


def _cli_calls(tmp, counted, ms_headline, cli, euroc_native, build):
    """Phase 23's calls, their files under ``tmp``."""
    import contextlib
    import io

    log = os.path.join(tmp, "log")
    row = {"calls": []}

    def call(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, c = counted(lambda: cli.main(list(argv)))
        out = buf.getvalue()
        assert rc == 0, (argv, rc, out[-2000:])
        js = [json.loads(line) for line in out.splitlines()
              if line.startswith("{")]
        row["calls"].append({"argv": list(argv), "rc": rc, "launches": c,
                             "json": js, "wall_s": time.perf_counter() - t0,
                             "stdout_tail": out.splitlines()[-4:]})
        return js, c

    _, c = call("qr", "--n", "2048", "--policy", "mixed_fast", "--quality",
                "fast", "--log-dir", log)
    assert c.get("bgs_group_fused") == 2, c
    (bench,), c = call("bench", "--sizes", "2048", "--policy", "mixed_fast",
                       "--quality", "fast", "--log-dir", log)
    assert bench["criteria_ok"] and c.get("bgs_group_fused", 0) > 0, (
        bench, c)
    row["bench_vs_phase4"] = {"seconds": bench["seconds"],
                              "tflops": bench["tflops"],
                              "phase4_ms": ms_headline}
    (solve,), c = call("solve", "--m", "4096", "--n", "2048")
    assert c.get("panel_factor_fused", 0) > 0, c
    row["solve"] = solve
    _, c = call("dist", "--n", "2048", "--log-dir", log)
    assert c.get("ns_chain", 0) > 0, c
    assert not dist.is_initialized()
    (tsq,), _ = call("tsqr-bench", "--m", "65536", "--n", "64")
    assert tsq["backward_error"] < 1e-5, tsq
    jac = os.path.join(tmp, "jac")
    call("dataset", "--out", jac)
    assert build() is not None, "the native Euroc parser did not build"
    parsed = []
    parse = euroc_native.parse_file

    def recording_parse(path):
        out = parse(path)
        parsed.append(path)  # only once the native parser has succeeded
        return out

    euroc_native.parse_file = recording_parse
    try:
        call("qr", "--file", os.path.join(jac, "A_000000100.txt"),
             "--log-dir", log)
    finally:
        euroc_native.parse_file = parse
    assert len(parsed) == 1, parsed
    row["native_parser"] = {"files": parsed, "library": build()}
    call("precision-study", "--sizes", "128", "--out",
         os.path.join(tmp, "study"))
    logs = sorted(os.path.join(log, f) for f in os.listdir(log))
    call("plot", *logs, "--out", os.path.join(tmp, "plots"))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "mixedprecisionblockqr_tpu_torch", "qr",
         "--n", "1024", "--log-dir", log],
        capture_output=True, text=True, env=env, cwd=here, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    row["python_m"] = {"argv": "python -m mixedprecisionblockqr_tpu_torch "
                               "qr --n 1024", "rc": run.returncode,
                       "wall_s": time.perf_counter() - t0,
                       "stdout_tail": run.stdout.splitlines()[-4:]}
    return row


def phase_k6_widths(A, R64, Jn17, bn17, row17, dev):
    """Phase 24: K6 above 128 columns.  (k) the wide route alone on seven
    panels against the plain version; then the calls that reach it, each
    with the counts set to 0 just before it and read just after: (a)
    'householder_pallas' and (b) 'householder' at block 256 on phase 4's
    input ``A`` (R against phase 8's POLICY_FP64 ``R64``), (c) 'cholqr1'
    at block 256 (its square last panel), (d) lstsq(J, b, method='tsqr') on
    phase 17's full-rank system (one 4096 x 2048 leaf), (e) tsqr on
    65536 x 256 (64 leaves and 63 tree nodes, all 256 wide).  Returns
    ``(row, launches, wide)``: the phase's line, the kernel launches of
    (a)-(e) and their wide-route counts."""
    from mixedprecisionblockqr_tpu_torch import (
        POLICY_FP32,
        POLICY_MIXED,
        block_qr,
        lstsq,
        metrics,
        tsqr,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import WIDE_LAUNCHES
    from mixedprecisionblockqr_tpu_torch.parallel import tsqr as tsqr_mod
    from mixedprecisionblockqr_tpu_torch.utils.flops import qr_flops
    from mixedprecisionblockqr_tpu_torch.utils.panel_probe import (
        k6_row,
        layouts_of,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    counted_all, launches = _counter()
    wide = {"calls": 0, "products": 0}

    def counted(fn):
        """``(out, K6 launches, wide-route counts)`` of one call of fn."""
        out, c = counted_all(fn)
        w = dict(WIDE_LAUNCHES)
        for k in wide:
            wide[k] += w[k]
        return out, c.get("panel_factor_fused", 0), w

    # (k) the wide route on its own: two sub-panels in shared memory
    # (2048 x 256, and 2000 x 200 with a 72-wide last one), four (4096 x
    # 512), sub-panels taller than 16 CTAs hold (8192 x 256, in place),
    # (d)'s one leaf (4096 x 2048: 16 sub-panels, T merges up to 1920
    # columns), (e)'s leaves (1024 x 256) and (c)'s square last panel
    # (256 x 256, whose last sub-panel is 128 x 128)
    gen = torch.Generator(device=dev).manual_seed(24)
    krows = {}
    for m, w in ((2048, 256), (2000, 200), (4096, 512), (8192, 256),
                 (4096, 2048), (1024, 256), (256, 256)):
        P = torch.rand((m, w), generator=gen, device=dev) - 0.5
        krows[f"{m}x{w}"] = row = k6_row(P)
        assert row["ok"] and row["route"] == "wide", (m, w, row)
    assert all(s.endswith("in_place")
               for s in krows["8192x256"]["sub_panels"]), krows["8192x256"]
    out = {"k": krows}

    # (a), (b): the reflector tiers at block 256, every panel through the
    # wide route (two K6 sub-panels each)
    for key, pm in (("a", "householder_pallas"), ("b", "householder")):
        def call(pm=pm):
            return block_qr(A, 256, POLICY_FP32, panel_method=pm)

        (Q, R), c, w = counted(call)
        rep = metrics.evaluate(A, Q, R, POLICY_FP32.precision_bits)
        rel = float(torch.linalg.norm(R.double() - R64)
                    / torch.linalg.norm(R64))
        assert c == 16 and w["calls"] == 8, (pm, c, w)
        assert rel <= 1e-4, (pm, rel)
        assert rep.all_ok and rep.tight_ok, (pm, str(rep))
        ms = cuda_time_ms(call, warmup=1, iters=5)
        out[key] = {"call": f"block_qr(A, 256, POLICY_FP32, panel_method="
                            f"'{pm}') 2048^2 (phase 4's input)",
                    "k6_launches": c, "wide": w, "rel_R_vs_fp64_loop": rel,
                    "backward": rep.backward,
                    "orthogonality": rep.orthogonality,
                    "all_ok": rep.all_ok, "tight_ok": rep.tight_ok,
                    "ms": ms,
                    "tflops": qr_flops(2048, 2048) / (ms * 1e-3) / 1e12}
        del Q, R

    # (c) cholqr1 at block 256: its square last panel (256 x 256) takes the
    # Householder panel under the hybrid rule, K6's wide route
    def chol_call():
        return block_qr(A, 256, POLICY_MIXED, mode="complete",
                        panel_method="cholqr1")

    (Q, R), c, w = counted(chol_call)
    rep = metrics.evaluate(A, Q, R, POLICY_MIXED.precision_bits)
    assert c == 2 and w["calls"] == 1, (c, w)
    assert rep.all_ok, str(rep)
    out["c"] = {"call": "block_qr(A, 256, POLICY_MIXED, mode='complete', "
                        "panel_method='cholqr1') 2048^2",
                "k6_launches": c, "wide": w, "backward": rep.backward,
                "orthogonality": rep.orthogonality, "all_ok": rep.all_ok,
                "ms": cuda_time_ms(chol_call, warmup=1, iters=5)}
    del Q, R

    # (d) lstsq(J, b, method='tsqr') on phase 17's full-rank system: one
    # leaf (4096 x 2048), factored by the wide route's 16 sub-panels
    J, b = torch.from_numpy(Jn17).to(dev), torch.from_numpy(bn17).to(dev)
    assert tsqr_mod._pick_leaves(4096, 2048, None) == 1
    x, c, w = counted(lambda: lstsq(J, b, method="tsqr"))
    err = solve_errors(Jn17, bn17, x)
    assert c == 16 and w["calls"] == 1, (c, w)
    assert err["resid_rel"] <= 1e-5 and err["x_rel_err"] <= 1e-4, err
    out["d"] = {"call": "lstsq(J, b, method='tsqr'), J = slam_jacobian("
                        "4096, 2048, seed=0) (phase 17's)",
                "k6_launches": c, "wide": w, **err,
                "ms": cuda_time_ms(lambda: lstsq(J, b, method="tsqr"),
                                   warmup=1, iters=3),
                "phase17_refine_ms": row17["ms"],
                "phase17_blocked_ms": row17["blocked_ms"]}
    del J, b

    # (e) tsqr on 65536 x 256: the 64 leaves of 1024 x 256 in one wide
    # batched call, then one for each of the 6 tree levels' nodes of 512 x
    # 256 (127 panels), each call two batched K6 launches and 6 product
    # launches (3 for the trailing update, 3 for T's merge), each over the
    # call's members
    a = np.random.default_rng(0).random((65536, 256), dtype=np.float32) - 0.5
    At = torch.from_numpy(a).to(dev)
    leaves = tsqr_mod._pick_leaves(65536, 256, None)
    assert leaves == 64, leaves
    (Q, R), c, w = counted(lambda: tsqr(At))
    be = batched_counts()
    rep = metrics.evaluate(At, Q, R, POLICY_FP32.precision_bits)
    levels = leaves.bit_length()
    assert w["calls"] == levels == 7 and c == 2 * w["calls"] == 14, (c, w)
    assert w["products"] == 6 * levels == 42, w
    assert be == {"launches": c, "members": 2 * leaves - 1}, be
    assert rep.all_ok, str(rep)
    out["e"] = {"call": "tsqr(A) 65536 x 256 fp32 (seed 0 uniform - 0.5)",
                "leaves": leaves, "k6_launches": c, "wide": w,
                "k6_batched": be,
                "backward": rep.backward, "orthogonality": rep.orthogonality,
                "lower_trapezoid": rep.lower_trapezoid,
                "all_ok": rep.all_ok, "tight_ok": rep.tight_ok,
                "ms": cuda_time_ms(lambda: tsqr(At), warmup=1, iters=5),
                "device_ms": device_ms_by(
                    lambda: tsqr(At), k6=("panel_factor_kernel",),
                    products=("gemm_tn", "gemm_nt")),
                "k6_layouts": layouts_of(lambda: tsqr(At), dev),
                "library_qr_ms": cuda_time_ms(lambda: torch.linalg.qr(At),
                                              warmup=1, iters=5)}
    del Q, R, At
    out["tolerance"] = (
        "(k) V, T and R's upper triangle within 1e-4 * max|plain| of "
        "panel_factor_fused_plain, two calls bitwise equal (phase 3's); "
        "(a), (b) 16 K6 launches, R within 1e-4 relative (Frobenius) of "
        "phase 8's POLICY_FP64 loop, all_ok and tight_ok; (c) 2 K6, all_ok; "
        "(d) residual 1e-5 and x 1e-4 relative of float64 np.linalg.lstsq; "
        "(e) 7 wide batched calls, 14 K6 launches, 42 product launches, "
        "127 panels, metric triple within 2^-23 m; times: CUDA events, "
        "median of 5 ((d) 3); K6's and the products' device ms and "
        "launches: torch.profiler")
    return out, launches, wide


def phase_bgs_batched(dev):
    """Phase 25: the BGS tiers on the whole stack, as the JAX package vmaps
    them (``block_qr_batched`` / ``block_qr_batched_sharded``): one batched
    K2 entry a group and one batched K1 launch a chain, no single K1 / K2.
    Each case counts from 0 just before its call.  Returns ``(row,
    launches)``: the phase's line and the launches of (a)-(d), summed."""
    from mixedprecisionblockqr_tpu_torch import (
        POLICY_FP32,
        POLICY_MIXED,
        POLICY_MIXED_FAST,
        block_qr,
        block_qr_batched,
        block_qr_batched_sharded,
        make_mesh,
        metrics,
    )
    from mixedprecisionblockqr_tpu_torch.utils.datagen import slam_jacobian
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    counted, total = _counter()
    row = {}

    def quality(A_, Q_, R_, bits):
        return [metrics.evaluate(a_, q_, r_, bits)
                for a_, q_, r_ in zip(A_, Q_, R_)]

    def only_batched(c, k2, k1):
        """Exactly k2 batched K2 entries and k1 batched K1 launches, and no
        single launch of either."""
        return (c.get("bgs_group_fused", 0) == c.get(
                    "bgs_group_fused_batched", 0) == k2
                and c.get("ns_chain", 0) == c.get("ns_chain_batched", 0)
                == k1)

    def stack_of(make, n):
        return torch.from_numpy(np.stack([make(i) for i in range(n)])).to(dev)

    # (a) the headline's tier on 8 members (member 0 the headline's input),
    # reduced: 2 groups of 4 panels a member, 4 batched K2 for 32 groups.
    A8 = stack_of(lambda i: np.random.default_rng(i).random(
        (2048, 2048), dtype=np.float32) - 0.5, 8)

    def fast(x):
        return block_qr_batched(x, 128, POLICY_MIXED_FAST,
                                panel_method="bgs1")

    def fast_single(x):
        return block_qr(x, 128, POLICY_MIXED_FAST, panel_method="bgs1")

    (Qa, Ra), ca = counted(lambda: fast(A8))
    assert only_batched(ca, 4, 0) and ca["bgs_group_fused_members"] == 32, ca
    reps = quality(A8, Qa, Ra, 8)
    singles = [metrics.evaluate(A8[i], *fast_single(A8[i]), 8)
               for i in range(8)]
    assert all(r.all_ok for r in reps), [str(r) for r in reps]
    for r_b, r_s in zip(reps, singles):
        assert r_b.backward <= 2 * r_s.backward, (r_b.backward, r_s.backward)
        assert r_b.orthogonality <= 2 * r_s.orthogonality, (
            r_b.orthogonality, r_s.orthogonality)
    del Qa, Ra
    An = A8.clone()
    An[3, 100, 200] = float("nan")
    Qn, Rn = fast(An)
    assert bool(torch.isnan(Rn[3, 0, 0])), "member 3 not poisoned"
    others = [i for i in range(8) if i != 3]
    assert bool(torch.isfinite(Rn[others]).all()
                and torch.isfinite(Qn[others]).all()), "poison spread"
    del Qn, Rn, An
    row["a"] = {"call": "block_qr_batched(A, 128, POLICY_MIXED_FAST, "
                        "panel_method='bgs1') reduced, A 8 x 2048 x 2048, "
                        "member i default_rng(i) - 0.5",
                "launches": ca,
                "backward": [r.backward for r in reps],
                "orthogonality": [r.orthogonality for r in reps],
                "backward_single": [r.backward for r in singles],
                "orthogonality_single": [r.orthogonality for r in singles],
                "all_ok": True,
                "nan_member_3": "R[3, 0, 0] NaN, the other 7 finite",
                "ms": cuda_time_ms(lambda: fast(A8), warmup=2, iters=10),
                "member_loop_ms": cuda_time_ms(
                    lambda: [fast_single(a_) for a_ in A8], warmup=1,
                    iters=5),
                "library_ms": cuda_time_ms(lambda: torch.linalg.qr(A8),
                                           warmup=1, iters=3),
                "library_call": "torch.linalg.qr(A) on the stack"}
    del A8

    # (b) phase 17's 8 SLAM Jacobians under the reorth tiers: 2 batched K2
    # (groups of 2 panels) and the robust tail's rescrub, 1 batched K1.
    J8 = stack_of(lambda i: slam_jacobian(2048, 512, seed=i), 8)
    row["b"] = {"call": "block_qr_batched(J, 128, policy, panel_method) "
                        "reduced, J 8 x slam_jacobian(2048, 512, seed=i)"}
    for name, pol, pm in (("fp32_bgs", POLICY_FP32, "bgs"),
                          ("mixed_bgs2", POLICY_MIXED, "bgs2")):
        def call(pol=pol, pm=pm):
            return block_qr_batched(J8, 128, pol, panel_method=pm)

        def single(x, pol=pol, pm=pm):
            return block_qr(x, 128, pol, panel_method=pm)

        (Qb, Rb), cb = counted(call)
        assert only_batched(cb, 2, 1) and cb["ns_chain_members"] == 8, cb
        outs = [single(J8[i]) for i in range(8)]
        reps = quality(J8, Qb, Rb, pol.precision_bits)
        reps1 = [metrics.evaluate(J8[i], *outs[i], pol.precision_bits)
                 for i in range(8)]
        assert all(r.all_ok for r in reps), [str(r) for r in reps]
        rel = [rel_fro(Rb[i], outs[i][1]) for i in range(8)]
        if pol is POLICY_FP32:
            assert max(rel) <= 1e-4, rel
        else:
            for r_b, r_s in zip(reps, reps1):
                assert r_b.backward <= 2 * r_s.backward, (r_b, r_s)
                assert r_b.orthogonality <= 2 * r_s.orthogonality, (r_b, r_s)
        row["b"][name] = {
            "launches": cb, "rel_R_vs_single_max": max(rel),
            "backward_max": max(r.backward for r in reps),
            "orthogonality_max": max(r.orthogonality for r in reps),
            "backward_single_max": max(r.backward for r in reps1),
            "orthogonality_single_max": max(r.orthogonality for r in reps1),
            "ms": cuda_time_ms(call, warmup=1, iters=5),
            "member_loop_ms": cuda_time_ms(
                lambda: [single(j_) for j_ in J8], warmup=1, iters=5)}
        del Qb, Rb, outs
    del J8

    # (c) m > 5120: the per-panel route, one batched K1 a chain (3 plain
    # panels, then the robust tail's three passes), no K2.
    A3 = stack_of(lambda i: np.random.default_rng(i).random(
        (6144, 512), dtype=np.float32) - 0.5, 3)
    (Qc, Rc), cc = counted(lambda: fast(A3))
    assert only_batched(cc, 0, 6) and cc["ns_chain_members"] == 18, cc
    reps = quality(A3, Qc, Rc, 8)
    assert all(r.all_ok for r in reps), [str(r) for r in reps]
    del Qc, Rc
    row["c"] = {"call": "block_qr_batched(A, 128, POLICY_MIXED_FAST, "
                        "panel_method='bgs1') reduced, A 3 x 6144 x 512 "
                        "(m > 5120: per-panel chains)",
                "launches": cc,
                "backward_max": max(r.backward for r in reps),
                "orthogonality_max": max(r.orthogonality for r in reps),
                "ms": cuda_time_ms(lambda: fast(A3), warmup=1, iters=5),
                "member_loop_ms": cuda_time_ms(
                    lambda: [fast_single(a_) for a_ in A3], warmup=1,
                    iters=5)}
    del A3

    # (d) the sharded entry on one NCCL rank, 'auto' under the mixed policy
    # (resolves to bgs1; 4 panels: 2 groups of 2, 2 batched K2).
    A_d = torch.from_numpy(np.random.default_rng(0).random(
        (8, 1024, 512), dtype=np.float32) - 0.5).to(dev)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        bmesh = make_mesh((1,), ("batch",))

        def sharded():
            return block_qr_batched_sharded(A_d, bmesh, panel_method="auto",
                                            policy=POLICY_MIXED_FAST)

        (Qd, Rd), cd = counted(sharded)
        assert only_batched(cd, 2, 0) and cd[
            "bgs_group_fused_members"] == 16, cd
        reps = quality(A_d, Qd, Rd, 8)
        assert all(r.all_ok for r in reps), [str(r) for r in reps]
        del Qd, Rd
        row["d"] = {"call": "block_qr_batched_sharded(A, batch mesh, "
                            "panel_method='auto', policy=POLICY_MIXED_FAST)"
                            ", A 8 x 1024 x 512, one NCCL rank",
                    "launches": cd,
                    "backward_max": max(r.backward for r in reps),
                    "orthogonality_max": max(r.orthogonality for r in reps),
                    "ms": cuda_time_ms(sharded, warmup=1, iters=5),
                    "member_loop_ms": cuda_time_ms(
                        lambda: [fast_single(a_) for a_ in A_d], warmup=1,
                        iters=5)}
    finally:
        dist.destroy_process_group()
    row["tolerance"] = ("(a) every member all_ok at 2^-8, backward and "
                        "orthogonality at most 2x its single block_qr; (b) "
                        "fp32 R 1e-4 relative of each single call, mixed "
                        "quality at most 2x; (c), (d) all_ok; each case "
                        "only batched K1 / K2 launches, counted; times: "
                        "CUDA events, median of 10 ((a)) or 5")
    return row, total


def phase_polar_batched(dev):
    """Phase 26: the ``polar`` tier on the whole stack, as the JAX package
    vmaps it (``block_qr_batched`` / ``block_qr_batched_sharded``): one
    batched K1 launch a panel (three on a robust tail panel) and one
    batched K4 launch a panel, no single K1 / K4.  Each case counts from 0
    just before its call.  Returns ``(row, launches)``: the phase's line
    and the launches of (a)-(c), summed."""
    from mixedprecisionblockqr_tpu_torch import (
        POLICY_FP32,
        POLICY_MIXED_FAST,
        block_qr,
        block_qr_batched,
        block_qr_batched_sharded,
        make_mesh,
        metrics,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    counted, total = _counter()
    row = {}

    def quality(A_, Q_, R_, bits):
        return [metrics.evaluate(a_, q_, r_, bits)
                for a_, q_, r_ in zip(A_, Q_, R_)]

    def only_batched(c, k1, k4):
        """Exactly k1 batched K1 and k4 batched K4 launches, no single
        launch of either, and no other kernel."""
        return (c.get("ns_chain", 0) == c.get("ns_chain_batched", 0) == k1
                and c.get("ninv_chain", 0) == c.get("ninv_chain_batched", 0)
                == k4 and set(c) <= {"ns_chain", "ns_chain_batched",
                                     "ns_chain_members", "ninv_chain",
                                     "ninv_chain_batched",
                                     "ninv_chain_members"})

    def stack_of(shape, n):
        return torch.from_numpy(np.stack([
            np.random.default_rng(i).random(shape, dtype=np.float32) - 0.5
            for i in range(n)])).to(dev)

    # (a) phase 9's tier on 8 members (member 0 phase 9's input), complete:
    # 16 tall panels a member, 16 batched K1 and 16 batched K4 launches.
    A8 = stack_of((4096, 2048), 8)

    def fast(x):
        return block_qr_batched(x, 128, POLICY_MIXED_FAST, mode="complete",
                                panel_method="polar")

    def fast_single(x):
        return block_qr(x, 128, POLICY_MIXED_FAST, mode="complete",
                        panel_method="polar")

    (Qa, Ra), ca = counted(lambda: fast(A8))
    assert only_batched(ca, 16, 16), ca
    assert ca["ns_chain_members"] == ca["ninv_chain_members"] == 128, ca
    reps = quality(A8, Qa, Ra, 8)
    del Qa, Ra
    singles = [metrics.evaluate(A8[i], *fast_single(A8[i]), 8)
               for i in range(8)]
    assert all(r.all_ok for r in reps), [str(r) for r in reps]
    for r_b, r_s in zip(reps, singles):
        assert r_b.backward <= 2 * r_s.backward, (r_b.backward, r_s.backward)
        assert r_b.orthogonality <= 2 * r_s.orthogonality, (
            r_b.orthogonality, r_s.orthogonality)
    An = A8.clone()
    An[3, 100, 200] = float("nan")
    Qn, Rn = fast(An)
    assert bool(torch.isnan(Rn[3, 0, 0])), "member 3 not poisoned"
    others = [i for i in range(8) if i != 3]
    assert bool(torch.isfinite(Rn[others]).all()
                and torch.isfinite(Qn[others]).all()), "poison spread"
    del Qn, Rn, An
    row["a"] = {"call": "block_qr_batched(A, 128, POLICY_MIXED_FAST, "
                        "mode='complete', panel_method='polar'), A 8 x 4096 "
                        "x 2048, member i default_rng(i) - 0.5",
                "launches": ca,
                "backward": [r.backward for r in reps],
                "orthogonality": [r.orthogonality for r in reps],
                "backward_single": [r.backward for r in singles],
                "orthogonality_single": [r.orthogonality for r in singles],
                "all_ok": True,
                "nan_member_3": "R[3, 0, 0] NaN, the other 7 finite",
                "ms": cuda_time_ms(lambda: fast(A8), warmup=1, iters=5),
                "member_loop_ms": cuda_time_ms(
                    lambda: [fast_single(a_) for a_ in A8], warmup=1,
                    iters=3),
                "library_ms": cuda_time_ms(
                    lambda: torch.linalg.qr(A8, mode="complete"), warmup=1,
                    iters=3),
                "library_call": "torch.linalg.qr(A, mode='complete') on "
                                "the stack"}
    del A8

    # (b) fp32 on 8 x 1024^2: 6 tall panels (the last two of aspect < 4,
    # the LU fallback armed), the robust tail panel (three chains) and the
    # square final panel (no K4): 10 batched K1 and 7 batched K4.
    A1 = stack_of((1024, 1024), 8)

    def fp32(x):
        return block_qr_batched(x, 128, POLICY_FP32, mode="complete",
                                panel_method="polar")

    def fp32_single(x):
        return block_qr(x, 128, POLICY_FP32, mode="complete",
                        panel_method="polar")

    (Qb, Rb), cb = counted(lambda: fp32(A1))
    assert only_batched(cb, 10, 7), cb
    assert cb["ns_chain_members"] == 80 and cb[
        "ninv_chain_members"] == 56, cb
    outs = [fp32_single(A1[i]) for i in range(8)]
    reps = quality(A1, Qb, Rb, POLICY_FP32.precision_bits)
    reps1 = [metrics.evaluate(A1[i], *outs[i], POLICY_FP32.precision_bits)
             for i in range(8)]
    rel = [rel_fro(Rb[i], outs[i][1]) for i in range(8)]
    assert all(r.all_ok for r in reps), [str(r) for r in reps]
    assert max(rel) <= 1e-4, rel
    for r_b, r_s in zip(reps, reps1):
        assert r_b.orthogonality <= 2 * r_s.orthogonality, (r_b, r_s)
    del Qb, Rb, outs
    row["b"] = {"call": "block_qr_batched(A, 128, POLICY_FP32, "
                        "mode='complete', panel_method='polar'), A 8 x 1024 "
                        "x 1024, member i default_rng(i) - 0.5",
                "launches": cb, "rel_R_vs_single_max": max(rel),
                "backward_max": max(r.backward for r in reps),
                "orthogonality_max": max(r.orthogonality for r in reps),
                "orthogonality_single_max": max(r.orthogonality
                                                for r in reps1),
                "ms": cuda_time_ms(lambda: fp32(A1), warmup=1, iters=5),
                "member_loop_ms": cuda_time_ms(
                    lambda: [fp32_single(a_) for a_ in A1], warmup=1,
                    iters=3)}
    del A1

    # (c) the sharded entry on one NCCL rank, 'polar' under the mixed
    # policy on phase 25 (d)'s stack: 4 tall panels, 4 batched K1 + 4 K4.
    A_d = torch.from_numpy(np.random.default_rng(0).random(
        (8, 1024, 512), dtype=np.float32) - 0.5).to(dev)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        bmesh = make_mesh((1,), ("batch",))

        def sharded():
            return block_qr_batched_sharded(A_d, bmesh, panel_method="polar",
                                            policy=POLICY_MIXED_FAST)

        (Qd, Rd), cd = counted(sharded)
        assert only_batched(cd, 4, 4), cd
        reps = quality(A_d, Qd, Rd, 8)
        assert all(r.all_ok for r in reps), [str(r) for r in reps]
        del Qd, Rd
        row["c"] = {"call": "block_qr_batched_sharded(A, batch mesh, "
                            "panel_method='polar', policy=POLICY_MIXED_FAST)"
                            ", A 8 x 1024 x 512, one NCCL rank",
                    "launches": cd,
                    "backward_max": max(r.backward for r in reps),
                    "orthogonality_max": max(r.orthogonality for r in reps),
                    "ms": cuda_time_ms(sharded, warmup=1, iters=5)}
    finally:
        dist.destroy_process_group()
    row["tolerance"] = ("(a) every member all_ok at 2^-8, backward and "
                        "orthogonality at most 2x its single block_qr; (b) "
                        "fp32 R 1e-4 relative of each single call, "
                        "orthogonality at most 2x; (c) all_ok; each case "
                        "only batched K1 / K4 launches, counted; times: "
                        "CUDA events, median of 5 (the loops: of 3)")
    return row, total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch import (
        POLICY_FP32,
        POLICY_FP64,
        POLICY_MIXED,
        POLICY_MIXED_FAST,
        RLSState,
        back_substitution,
        block_qr,
        block_qr_resumable,
        givens_qr,
        lstsq,
        lstsq_autodiff,
        lstsq_batched,
        metrics,
        numerical_rank,
        pivoted_qr,
        pivoted_qr_qtb,
        qr,
        qr_append_row,
        qr_autodiff,
        qr_delete_col,
        qr_delete_row,
        qr_insert_col,
        qr_rank1_update,
        rls_init,
        rls_solve,
        rls_update,
        tsqr,
    )
    from mixedprecisionblockqr_tpu_torch.ops import pivoted
    from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
        resolve_panel_config,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
    from mixedprecisionblockqr_tpu_torch.ops import blockqr as bq
    from mixedprecisionblockqr_tpu_torch.ops.kernels.chol import (
        chol_layout,
        chol_rinv,
        chol_rinv_plain,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels import gemm as gemm_mod
    from mixedprecisionblockqr_tpu_torch.ops.kernels.gemm import (
        matmul_bf16_accum_f32,
        matmul_int8_accum_i32,
        matmul_uint8_accum_i32,
        tiled_matmul,
        tiled_matmul_plain,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        LAUNCHES,
        ROUTE_LAUNCHES,
        bgs_group_fused,
        bgs_group_fused_plain,
        bgs_group_fused_proj,
        bgs_group_fused_proj_plain,
        group_layout,
        ninv_chain,
        ninv_chain_batched,
        ninv_layout,
        ninv_resident_clusters,
        ns_chain,
        ns_chain_plain,
        ns_resident_clusters,
        panel_qr_fused,
        panel_qr_fused_plain,
        reset_launches,
        robust_products,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (
        max_cluster as panel_max_cluster,
        panel_factor_fused,
        panel_layout,
    )
    from mixedprecisionblockqr_tpu_torch.ops.policy import mm_bf16, mm_f32
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        chol_rinv_bound,
        group_bound,
        matmul_bound,
        ninv_chain_bound,
        ns_chain_bound,
        panel_factor_bound,
        panel_qr_bound,
        sketch_bound,
    )
    from mixedprecisionblockqr_tpu_torch.parallel import caqr as caqr_mod
    from mixedprecisionblockqr_tpu_torch.parallel import tsqr as tsqr_mod
    from mixedprecisionblockqr_tpu_torch.parallel.caqr import (
        apply_qt,
        caqr_factor,
    )
    from mixedprecisionblockqr_tpu_torch.utils.datagen import (
        gauge_deficient_system,
        slam_jacobian,
    )
    from mixedprecisionblockqr_tpu_torch.utils import givens_probe
    from mixedprecisionblockqr_tpu_torch.utils import ninv_probe
    from mixedprecisionblockqr_tpu_torch.utils import ns_probe
    from mixedprecisionblockqr_tpu_torch.utils import width_probe
    from mixedprecisionblockqr_tpu_torch.utils.flops import qr_flops
    from mixedprecisionblockqr_tpu_torch.utils.ninv_probe import (
        combine_row,
        k4_inputs,
        k4_row,
    )
    from mixedprecisionblockqr_tpu_torch.utils import panel_probe
    from mixedprecisionblockqr_tpu_torch.utils.panel_probe import (
        k6_batched_row,
        k6_row,
        layouts_of,
    )
    from mixedprecisionblockqr_tpu_torch.utils.batched_probe import (
        K1_CASES,
        K2_CASES,
        K4_CASES,
        k1_batched_row,
        k1_stack,
        k2_batched_row,
        k2_stack,
        k4_batched_row,
        k4_stack,
    )
    from mixedprecisionblockqr_tpu_torch.utils.sketch_probe import (
        k7_row,
        k7_sketches,
    )
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
    # K1 at every panel width, with every option combination the QR tiers
    # use, on a well-conditioned Gram, on one graded over three decades
    # (condition ~1e6, shifted chains only, as in the tiers) and on the
    # near-identity Gram of an orthonormalized panel (refine).  Two
    # launches on the same input must agree bitwise.
    ns_all, ns_err = {}, 0.0
    for r1 in (128, 64, 32):
        Pw = P[:, :r1]
        Gr = mm_f32(Pw.T, Pw).contiguous()
        Pill = Pw * torch.logspace(0, -3, r1, device=dev)
        G_ill = mm_f32(Pill.T, Pill).contiguous()
        X0, _, _ = ns_chain_plain(Gr, iters=10)
        Qn = mm_f32(Pw, X0)
        G_ref = mm_f32(Qn.T, Qn).contiguous()
        modes = {
            "plain": (Gr, dict(iters=10)),
            "shift": (G_ill, dict(iters=14, shift=1e-3)),
            "shift_mid": (G_ill, dict(iters=14, shift=1e-3, omega=False,
                                      chain_mid=True)),
            "pass2_mid": (Gr, dict(iters=12, omega=False, chain_mid=True)),
            "refine": (G_ref, dict(iters=4, refine=True)),
            "chain_mid": (Gr, dict(iters=6, chain_mid=True)),
            "chain_mid10": (Gr, dict(iters=10, chain_mid=True)),
            "classic": (Gr, dict(iters=10, fuse_xw=False)),
        }
        rows = {}
        for name, (Gm, kw) in modes.items():
            X, t, res = ns_chain(Gm, **kw)
            X2, t2, res2 = ns_chain(Gm, **kw)
            Xp, tp, resp = ns_chain_plain(Gm, **kw)
            torch.cuda.synchronize()
            ex, et = max_abs(X, Xp), max_abs(t, tp)
            lim_x = TOL_F32 * float(Xp.abs().max())
            lim_t = TOL_F32 * float(tp.abs().max())
            same_bits = bool(torch.equal(X, X2) and torch.equal(t, t2)
                             and torch.equal(res, res2))
            ok = (ex <= lim_x and et <= lim_t and same_bits
                  and (float(res) < 1e-4) == (float(resp) < 1e-4))
            rows[name] = {"err_X": ex, "lim_X": lim_x, "err_t": et,
                          "lim_t": lim_t, "resid": float(res),
                          "resid_plain": float(resp),
                          "bitwise_repeatable": same_bits, "ok": ok,
                          "ms": cuda_time_ms(lambda: ns_chain(Gm, **kw))}
            if r1 == 128:
                rows[name]["plain_ms"] = cuda_time_ms(
                    lambda: ns_chain_plain(Gm, **kw))
            ns_err = max(ns_err, ex, et)
            assert ok, (r1, name, rows[name])
        # A NaN in G must reach the residual; an indefinite G must fail the
        # canary as the plain version does.
        G_nan = Gr.clone()
        G_nan[3, 5] = float("nan")
        G_ind = Gr.clone()
        G_ind[r1 // 2, r1 // 2] = -1.0
        canary = {}
        for cname, kw in (("chain_mid", dict(iters=6, chain_mid=True)),
                          ("refine", dict(iters=4, refine=True)),
                          ("shift", dict(iters=14, shift=1e-3))):
            res_nan = float(ns_chain(G_nan, **kw)[2])
            res_ind = float(ns_chain(G_ind, **kw)[2])
            res_ind_p = float(ns_chain_plain(G_ind, **kw)[2])
            canary[cname] = {"nan_resid": res_nan, "indefinite": res_ind,
                             "indefinite_plain": res_ind_p}
            assert res_nan != res_nan, (r1, cname, canary)
            assert (res_ind < 1e-4) == (res_ind_p < 1e-4), (r1, cname, canary)
        rows["canary"] = canary
        ns_all[r1] = rows
    ns_rows = ns_all[128]
    lib_k1 = cuda_time_ms(lambda: torch.linalg.cholesky(G))
    # K1 forms X = R^-1, not only the factor: the yardstick beside
    # cholesky alone is cholesky and the triangular inverse.
    lib_k1_inv = cuda_time_ms(lambda: ns_probe.cholesky_inverse(G))
    # K1's clock build (-DMPBQR_NS_PROF, ns_chain.cu alone; utils/
    # ns_probe.py --phases): one launch of each option set of the probe,
    # on Grams from a generator of its own (the later phases' draws stay
    # as they were); its outputs equal the library's bit for bit, every
    # slot is named, and one cluster exchange as it measured gives each
    # option set's serial floor.
    # The L2 route's clock (r = 256 chain_mid, 16 CTAs) runs once from the
    # same build, each of its slots asserted with every CTA's record.
    gen_k1 = torch.Generator(device=dev).manual_seed(27)
    smem_sets = [n for n, (r_k1, _, _) in ns_probe.OPTION_SETS.items()
                 if r_k1 <= 128]
    with _build.instrumented_library(*ns_probe.PROF_BUILD) as prof:
        k1_grams = ns_probe.grams(gen_k1, dev)
        mhz = ns_probe._sm_mhz()
        k1_phases = ns_probe.phase_rows(prof, k1_grams, mhz, smem_sets)
        k1_l2_phases = ns_probe.phase_rows(prof, k1_grams, mhz,
                                           ["l2_chain_mid"])
    k1_floor = {}
    for name, row in {**k1_phases, **k1_l2_phases}.items():
        assert row["same_as_library"] and row["launch_cycles"] > 0, (name,
                                                                     row)
        slots = ns_probe.L2_SLOTS if row["route"] == "l2" else ns_probe.SLOTS
        assert set(row["slots"]) == set(slots), (name, row)
        assert row["exchange_cycles"] > 0, (name, row)
        r_k1, _, kw = ns_probe.OPTION_SETS[name]
        if row["route"] == "l2":
            assert row["ctas"] == 16 and r_k1 == 256, (name, row)
            for slot in ("launch", *slots):
                assert len(row["per_cta"][slot]) == 16, (name, slot)
            assert all(c > 0 for c in row["per_cta"]["launch"]), row
            for slot in ("setup", "correction", "x_update", "barrier",
                         "close_t"):
                assert row["slots"][slot]["cycles"] > 0, (name, slot, row)
        k1_floor[name] = ns_chain_bound(
            r_k1, kw["iters"], kw.get("chain_mid", False),
            kw.get("refine", False), shift=bool(kw.get("shift")),
            exchange_ms=row["exchange_us"] * 1e-3)["serial_floor_ms"]
    emit({"phase": "kernels", "kernel": "ns_chain",
          "tolerance": "max|diff| <= 1e-4 * max|plain| for X and t; same "
                       "canary class (resid < 1e-4); two launches bitwise "
                       "equal; NaN in G gives a NaN resid",
          "r128": ns_all[128], "r64": ns_all[64], "r32": ns_all[32],
          "bound_chain_mid_6": ns_chain_bound(128, 6, chain_mid=True),
          "bound_shift_mid_14": ns_chain_bound(128, 14, chain_mid=True),
          "phases": k1_phases, "l2_phases": k1_l2_phases,
          "serial_floor_ms": k1_floor,
          "library_call": "torch.linalg.cholesky(G)",
          "library_ms": lib_k1,
          "library_inverse_call": "torch.linalg.cholesky(G) + "
                                  "solve_triangular(L^T, I)",
          "library_inverse_ms": lib_k1_inv, "card": card})

    Pg = torch.rand((2048, 1024), generator=gen, device=dev) - 0.5
    iters = (12, 6, 6, 6, 6, 6, 6, 10)
    grp_rows, grp_err = {}, 0.0
    for bf in (True, False):
        for rob in (False, True):
            robust = (False,) * 7 + (rob,)
            kw = dict(bf16_dots=bf, chain_mid=bf)
            Q, R, w = bgs_group_fused(Pg, 128, iters, robust, **kw)
            again = bgs_group_fused(Pg, 128, iters, robust, **kw)
            Qp, Rp, wp = bgs_group_fused_plain(Pg, 128, iters, robust, **kw)
            torch.cuda.synchronize()
            # The tail panel's diagonal block alone, where the robust
            # three-pass chain writes its R block.
            row = {"max_abs_Q": max_abs(Q, Qp), "rel_Q": rel_fro(Q, Qp),
                   "rel_R": rel_fro(R, Rp),
                   "rel_R_tail": rel_fro(R[-128:, -128:], Rp[-128:, -128:]),
                   "resid": float(w), "resid_plain": float(wp),
                   "bitwise_repeatable": bitwise_equal((Q, R, w), again)}
            tol = TOL_BF16 if bf else TOL_F32
            ok = (row["rel_R"] <= tol and row["rel_R_tail"] <= tol
                  and row["bitwise_repeatable"])
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
            row.update(device_kernels(
                lambda: bgs_group_fused(Pg, 128, iters, robust, **kw)))
            grp_rows[f"{'bgs1' if bf else 'bgs2'}_robust={rob}"] = row
            grp_err = max(grp_err, row["max_abs_Q"])
            assert row["ok"], (bf, rob, row)
    lib_k2 = cuda_time_ms(lambda: torch.linalg.qr(Pg))
    emit({"phase": "kernels", "kernel": "bgs_group_fused",
          "shape": [2048, 1024], "r": 128, "g": 8,
          "layout": group_layout(2048, 128)._asdict(),
          "tolerance": "fp32 flags: max|dQ| <= 1e-4, ||dR||/||R|| <= 1e-4; "
                       "bf16 flags: ||dQ||/||Q||, ||dR||/||R|| <= 5e-3; two "
                       "launches bitwise equal",
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
            again = panel_qr_fused(Pm, **kw)
            Qp, tp, resp = panel_qr_fused_plain(Pm, **kw)
            torch.cuda.synchronize()
            robust = kw.get("robust", False)

            def canary(x):  # the drivers' scaling of the raw residual
                return (0.01 * x if robust else x * x) < 1e-4

            eq, lim_q = max_abs(Q, Qp), TOL_F32 * float(Qp.abs().max())
            row = {"max_abs_Q": eq, "lim_Q": lim_q, "rel_t": rel_fro(t, tp),
                   "resid": float(res), "resid_plain": float(resp),
                   "bitwise_repeatable": bitwise_equal((Q, t, res), again)}
            row["ok"] = (eq <= lim_q and row["rel_t"] <= TOL_F32
                         and row["bitwise_repeatable"]
                         and canary(row["resid"]) == canary(
                             row["resid_plain"]))
            row["ms"] = cuda_time_ms(lambda: panel_qr_fused(Pm, **kw))
            row["plain_ms"] = cuda_time_ms(
                lambda: panel_qr_fused_plain(Pm, **kw))
            row.update(device_kernels(lambda: panel_qr_fused(Pm, **kw)))
            k3_rows[f"{pname}_{mname}"] = row
            k3_err = max(k3_err, eq)
            assert row["ok"], (pname, mname, row)
    lib_k3 = cuda_time_ms(lambda: torch.linalg.qr(Pk))
    emit({"phase": "kernels", "kernel": "panel_qr_fused",
          "shape": [4096, 128], "layout": group_layout(4096, 128)._asdict(),
          "tolerance": "max|dQ| <= 1e-4 * max|Q|, ||dt||/||t|| <= 1e-4; "
                       "same canary class (0.01 resid < 1e-4 robust, "
                       "resid^2 < 1e-4 plain); two launches bitwise equal",
          "modes": k3_rows, "library_call": "torch.linalg.qr(P)",
          "library_ms": lib_k3, "card": card})

    # The combine that closes K2's and K3's robust panels, on its own, on
    # the t1, t2, t3 of a robust K3 call on the RQRCP panel (the plain
    # route's values), launched twice.
    cmb = combine_row(*robust_products(Pk))
    assert cmb["ok"], cmb
    emit({"phase": "kernels", "kernel": "tri_combine", "shape": [128, 128],
          "tolerance": "max|d| <= 1e-4 * max|out|; two launches bitwise "
                       "equal",
          **cmb, "card": card})

    # K4 on utils/ninv_probe.py::k4_inputs: Yamamoto S matrices of a 4096 x
    # 128 panel (5 iterations, the polar phase's) and a 256 x 128 one (12,
    # the cholqr scan's), and a near-singular S (12); each launched twice.
    # A NaN in S must reach the residual.
    k4_in = k4_inputs(gen, dev)
    k4_rows, k4_err = {}, 0.0
    for name, (S, it) in k4_in.items():
        row = k4_row(S, it)
        k4_rows[name] = row
        k4_err = max(k4_err, row["max_abs_X"])
        assert row["ok"], (name, row)
    S_nan = k4_in["panel4096_it5"][0].clone()
    S_nan[4, 9] = float("nan")
    k4_nan = float(ninv_chain(S_nan, 5)[1])
    assert k4_nan != k4_nan, k4_nan
    emit({"phase": "kernels", "kernel": "ninv_chain", "r": 128,
          "cluster": ninv_layout(128).ctas,
          "tolerance": "max|dX| <= 1e-4 * max|X|; same fallback class "
                       "(resid < 1e-3); two launches bitwise equal; NaN in "
                       "S gives a NaN resid",
          "library_call": "torch.linalg.inv(S)", "inputs": k4_rows,
          "nan_in_S_resid": k4_nan, "card": card})

    # K4's L2 route's clock build (-DMPBQR_NINV_PROF, ninv_chain.cu alone;
    # utils/ninv_probe.py --phases --l2): one launch at r = 256, 5
    # iterations, on the probe's own input (a generator of its own, so the
    # later kernels' draws stay as they were): every slot of the probe's
    # table recorded by each of the 16 CTAs, and the clock build's X and
    # resid equal to the library's bit for bit.
    with _build.instrumented_library(*ninv_probe.PROF_BUILD) as prof:
        k4_clock = ninv_probe.l2_phase_rows(
            prof, {256: ninv_probe.l2_inputs(256, dev)},
            ninv_probe._sm_mhz("clocks.max.sm"),
            ["r256_it5"])["r256_it5"]
    assert k4_clock["same_as_library"] and k4_clock["ctas"] == 16, k4_clock
    assert tuple(k4_clock["slots"]) == ninv_probe.L2_SLOTS, k4_clock
    for slot in ("launch", *ninv_probe.L2_SLOTS):
        assert len(k4_clock["per_cta"][slot]) == 16, (slot, k4_clock)
    assert all(c > 0 for c in k4_clock["per_cta"]["launch"]), k4_clock
    for slot in ("setup", "prod_sx", "prod_xe", "barrier", "residual",
                 "cluster_max"):
        assert k4_clock["slots"][slot]["cycles"] > 0, (slot, k4_clock)
    emit({"phase": "kernels", "kernel": "ninv_chain_l2_clock",
          "check": "every slot named, 16 CTA rows each, the clock build's "
                   "outputs bitwise equal to the library's",
          **k4_clock, "card": card})

    # K6 at the paths' panel shapes (utils/panel_probe.py::k6_row):
    # lstsq's panels (4096, 3072 and 2176 x 128 in its first stage, 2048 x
    # 128 in both), householder_pallas's square last panel (128 x 128), the
    # cholqr hybrid's tails at 2000^2 (208 x 128, 80 x 80), 8192 x 128 (the
    # in-place route), and a 2048 x 128 panel with a zero column and one
    # with a NaN.  Each row has its cluster, rows per CTA and route.  The
    # 3072 and 2176 panels come from a generator of their own, so that the
    # later kernels' inputs stay the draws they were.
    k6_inputs = {f"{m}x{w}": torch.rand((m, w), generator=gen, device=dev)
                 - 0.5 for m, w in ((2048, 128), (128, 128), (208, 128),
                                    (80, 80), (4096, 128), (8192, 128))}
    Pz = torch.rand((2048, 128), generator=gen, device=dev) - 0.5
    Pz[:, 5] = 0.0
    k6_inputs["2048x128_zero_column"] = Pz
    Pn = torch.rand((2048, 128), generator=gen, device=dev) - 0.5
    Pn[300, 9] = float("nan")
    k6_inputs["2048x128_nan"] = Pn
    gen6 = torch.Generator(device=dev).manual_seed(6)
    for m in (3072, 2176):
        k6_inputs[f"{m}x128"] = torch.rand((m, 128), generator=gen6,
                                           device=dev) - 0.5
    # The shared-memory route's row limit at w = 128 (16 CTAs of 405 rows):
    # one panel at it, one just over (in place), from a generator of their
    # own.
    gen30 = torch.Generator(device=dev).manual_seed(30)
    for m in (6480, 6481):
        k6_inputs[f"{m}x128"] = torch.rand((m, 128), generator=gen30,
                                           device=dev) - 0.5
    k6_rows = {name: k6_row(Pm, nan_input=name.endswith("nan"))
               for name, Pm in k6_inputs.items()}
    k6_err = max(max(row[f"max_abs_{x}"] for x in "VTR")
                 for row in k6_rows.values())
    for name, row in k6_rows.items():
        assert row["ok"], (name, row)
    for name in ("4096x128", "3072x128", "2176x128", "2048x128",
                 "6480x128"):
        assert k6_rows[name]["route"] == "smem", (name, k6_rows[name])
    for name in ("8192x128", "6481x128"):
        assert k6_rows[name]["route"] == "in_place", (name, k6_rows[name])
    # K6's clock build (-DMPBQR_PANEL_PROF, panel_factor.cu alone;
    # utils/panel_probe.py --phases): one launch at 2048 x 128 (shared
    # memory) and 8192 x 128 (in place) on the probe's own draws; every
    # slot of the probe's table recorded by every CTA, one exchange a
    # column, and the clock build's V, T and R bit for bit the library's.
    gen_pf = torch.Generator(device=dev).manual_seed(30)
    with _build.instrumented_library(*panel_probe.PROF_BUILD) as prof:
        k6_phases = {f"{m}x128": panel_probe.phase_row(
            prof, torch.rand((m, 128), generator=gen_pf, device=dev) - 0.5,
            panel_probe._sm_mhz()) for m in (2048, 8192)}
    for name, row in k6_phases.items():
        assert row["same_as_library"] and row["cluster"] == 16, (name, row)
        assert set(row["per_cta_us"]) == set(panel_probe.PHASES), row
        for slot, per_cta in row["per_cta_us"].items():
            assert len(per_cta) == 16, (name, slot, row)
        assert all(v > 0 for v in row["per_cta_us"]["exchange"]), row
        for slot in ("scalars", "x_subpass", "fused_pass", "push",
                     "outputs", "t_build"):
            assert row["cta0_us"][slot] > 0, (name, slot, row)
    emit({"phase": "kernels", "kernel": "panel_factor_fused",
          "max_cluster": panel_max_cluster(dev),
          "tolerance": "V, T and R's upper triangle each within 1e-4 * "
                       "max|plain| over finite entries (the kernel writes "
                       "exact zeros below R's diagonal, the plain version "
                       "residue); two launches bitwise equal; the NaN "
                       "reaches R, in the plain version's places; plain "
                       "ms: median of 3",
          "library_call": "torch.geqrf(P)", "inputs": k6_rows,
          "phases": k6_phases, "card": card})

    # K6's batched entry (utils/panel_probe.py::k6_batched_row): tsqr
    # 100000 x 64's 64 leaves, the refine lstsq's 8 leaves of 512 x 128, a
    # wide batch, the batched solve's first panel step (8 x 2048 x 128) and
    # tsqr 65536 x 256's 64 leaves (the wide route), each against the
    # batched plain version at K6's tolerance, each member bit for bit a
    # single launch at the batch's layout, with the clusters the card keeps
    # resident, the waves and a wide call's product launches, beside the
    # loop of single calls and torch.geqrf of the stack.  A generator of
    # its own keeps the later kernels' inputs the draws they were.
    gen21 = torch.Generator(device=dev).manual_seed(21)
    k6b_rows = {}
    for B, m, w in ((64, 1563, 64), (8, 512, 128), (4, 1024, 256),
                    (8, 2048, 128), (64, 1024, 256)):
        Pb = torch.rand((B, m, w), generator=gen21, device=dev) - 0.5
        # the plain version of 64 wide panels takes ~10 s a call: its time
        # is the one call the error check makes
        k6b_rows[f"{B}x{m}x{w}"] = row = k6_batched_row(
            Pb, plain_iters=0 if (B, w) == (64, 256) else 3)
        assert row["ok"], (B, m, w, row)
    assert k6b_rows["4x1024x256"]["route"] == "wide", k6b_rows
    # the batched layout by the clusters the card keeps resident: the 8
    # panels of 2048 x 128 in one wave; a wide call's products one launch
    # each for all its members, 6 for its two sub-panels
    assert k6b_rows["8x2048x128"]["waves"] == [1], k6b_rows["8x2048x128"]
    for name in ("4x1024x256", "64x1024x256"):
        assert k6b_rows[name]["products"] == 6, (name, k6b_rows[name])
    k6b_err = max(max(row[f"max_abs_{x}"] for x in "VTR")
                  for row in k6b_rows.values())
    emit({"phase": "kernels", "kernel": "panel_factor_fused_batched",
          "tolerance": "V, T and R's upper triangle each within 1e-4 * "
                       "max|plain| of panel_factor_fused_batched_plain; two "
                       "batched calls bitwise equal; each member bit for "
                       "bit a single launch at the batch's layout; 8 x "
                       "2048 x 128 in one wave; plain ms: median of 3 "
                       "(64 x 1024 x 256: one call), the loop of single "
                       "calls: of 5",
          "library_call": "torch.geqrf(P) on the (B, m, w) stack",
          "inputs": k6b_rows, "card": card})

    # K1's and K2's batched entries (utils/batched_probe.py): K1 on 8 Grams
    # of r = 128 (plain, shift, refine, chain_mid) and on 4 of r = 256 (the
    # L2 route); K2 on 8 groups of 2048 x 512 (g4, r = 128, a robust last
    # panel) under the bf16 and the fp32 flags, on 16 (two waves of
    # chains) and on 2 of 2048 x 1024 at r = 256, all on the stack route;
    # each against the batched plain version at this phase's tolerances,
    # two batched calls bit for bit, each member bit for bit its single
    # call at the batch's layout, beside the loop of single calls, the
    # library call on the stack and both floors, with K2's device time by
    # kind and K1's resident clusters and waves.  A
    # generator of its own keeps the later kernels' inputs as they were.
    gen23 = torch.Generator(device=dev).manual_seed(23)
    k1b_rows = {}
    for name, B, r1, kind, kw in K1_CASES:
        k1b_rows[f"{name}_{B}x{r1}"] = row = k1_batched_row(
            k1_stack(kind, B, r1, gen23, dev), kw)
        assert row["ok"], (name, row)
    k1b_err = max(row["max_abs_err"] for row in k1b_rows.values())
    k1b_res = {r1: ns_resident_clusters(dev, r1) for r1 in (128, 256)}
    emit({"phase": "kernels", "kernel": "ns_chain_batched",
          "tolerance": "X and t within 1e-4 * max|plain| of ns_chain_plain "
                       "on the stack; the same canary class a member; two "
                       "batched calls bitwise equal; each member bit for "
                       "bit its single launch; plain ms: median of 3, the "
                       "loop of single launches: of 10",
          "library_call": "torch.linalg.cholesky(G) on the (B, r, r) stack",
          "resident_clusters": k1b_res,
          "waves_B8_B16": {r1: [-(-B // max(1, n)) for B in (8, 16)]
                           for r1, n in k1b_res.items()},
          "inputs": k1b_rows, "card": card})
    k2b_rows = {}
    for name, B, m, r1, g, bf in K2_CASES:
        k2b_rows[name] = row = k2_batched_row(
            k2_stack(B, m, g * r1, gen23, dev), r1, bf)
        assert row["ok"], (name, row)
    k2b_err = max(row["max_abs_err"] for row in k2b_rows.values())
    emit({"phase": "kernels", "kernel": "bgs_group_fused_batched",
          "tolerance": "fp32 flags: max|dQ| <= 1e-4, ||dR||/||R|| <= 1e-4 "
                       "(and the robust tail block's); bf16 flags: "
                       "||dQ||/||Q||, ||dR||/||R|| <= 5e-3, a member each, "
                       "against bgs_group_fused_plain on the stack; two "
                       "batched calls bitwise equal; each member bit for "
                       "bit its single call at the batch's layout "
                       "(group_layout for the B members: the stack route's "
                       "products at r = 128 / 256); plain ms: median of 3, "
                       "the loop of single calls: of 10",
          "library_call": "torch.linalg.qr(Pg) on the (B, m, g r) stack",
          "routes": {name: row["layout"]["product_route"]
                     for name, row in k2b_rows.items()},
          "kinds_ms": {name: {k: v["ms"] for k, v in (
              row.get("kinds") or {}).items() if isinstance(v, dict)}
              for name, row in k2b_rows.items()},
          "floors_ms": {name: [row["member_floor_ms"],
                               row["products_floor_ms"]]
                        for name, row in k2b_rows.items()},
          "inputs": k2b_rows, "card": card})

    # K4's batched entry (utils/batched_probe.py::K4_CASES): Yamamoto S
    # stacks built as the K4 row's (utils/ninv_probe.py::yamamoto_s): 8 x
    # 128 at 5 and at 12 iterations, 16 x 128 (two waves if 15 clusters are
    # resident), 3 x 100 (the padded instantiation), 4 x 256 and 8 x 256
    # (the L2 route; two waves if 7 clusters of 16 are resident); each
    # against ninv_chain_plain on the stack at K4's tolerance,
    # two batched calls bit for bit, each member bit for bit its single
    # launch, beside the loop of single launches, torch.linalg.inv on the
    # stack and the bound, with resident clusters and waves.  A NaN in
    # member 2's S gives member 2 a NaN resid and leaves the others' bits.
    # A generator of its own keeps the later kernels' inputs as they were.
    gen24 = torch.Generator(device=dev).manual_seed(24)
    k4b_rows, k4b_stacks = {}, {}
    for name, B, m, r1, it in K4_CASES:
        k4b_stacks[name] = S_b = k4_stack(B, m, r1, gen24, dev)
        k4b_rows[f"{name}_{B}x{r1}"] = row = k4_batched_row(S_b, it)
        assert row["ok"], (name, row)
    k4b_err = max(row["max_abs_err"] for row in k4b_rows.values())
    S_b = k4b_stacks["panel4096_it5"]
    S_bn = S_b.clone()
    S_bn[2, 4, 9] = float("nan")
    X_b, res_b = ninv_chain_batched(S_b, 5)
    X_bn, res_bn = ninv_chain_batched(S_bn, 5)
    keep = [i for i in range(S_b.shape[0]) if i != 2]
    assert bool(torch.isnan(res_bn[2])), res_bn
    assert bool(torch.equal(res_bn[keep], res_b[keep])
                and torch.equal(X_bn[keep], X_b[keep])), res_bn
    k4b_res = {r1: ninv_resident_clusters(dev, r1) for r1 in (128, 256)}
    emit({"phase": "kernels", "kernel": "ninv_chain_batched",
          "tolerance": "X within 1e-4 * max|plain| of ninv_chain_plain on "
                       "the stack; the same fallback class (resid < 1e-3) a "
                       "member; two batched calls bitwise equal; each member "
                       "bit for bit its single launch; plain ms: median of "
                       "3, the loop of single launches: of 10",
          "library_call": "torch.linalg.inv(S) on the (B, r, r) stack",
          "resident_clusters": k4b_res,
          "waves_B8_B16": {r1: [-(-B // max(1, n)) for B in (8, 16)]
                           for r1, n in k4b_res.items()},
          "nan_in_member_2": {"resid": res_bn.tolist(),
                              "others_bitwise_unchanged": True},
          "inputs": k4b_rows, "card": card})

    # K7 on the sketches of utils/sketch_probe.py::k7_sketches: d = 128 + 8
    # at the RQRCP panels' widths (2048, 1920, 200), a zero and a
    # duplicated column, at 8192 (in place), 72 x 1024 with r = 64, rows
    # not a multiple of 4 (138 x 2048, 73 x 300), 700 rows in shared memory
    # and in place, a NaN column, an inf entry and a 6-wide one; the ranks
    # of two launches bitwise equal and equal to the plain version's, with
    # each sketch's cluster and route.  The sketches past zero_dup come from
    # a generator of their own, so that the later inputs stay as they were.
    k7_rows = {sname: k7_row(S, r7) for sname, (S, r7) in k7_sketches(
        gen, dev, torch.Generator(device=dev).manual_seed(1)).items()}
    k7_err = max(row["max_abs_rank"] for row in k7_rows.values())
    for sname, row in k7_rows.items():
        assert row["ok"], (sname, row)
    emit({"phase": "kernels", "kernel": "sketch_qrcp_ranks",
          "tolerance": "ranks equal to the plain version's; two launches "
                       "bitwise equal",
          "sketches": k7_rows, "card": card})

    # K5 at the proj_entry route's shape at 2048^2 g8: the second group's
    # raw columns (2048 x 1024) and the 1024 columns of Q written before
    # it, a column slice of the 2048-wide Q buffer (leading dimension 2048)
    # in fp32 and, as under the compact policies, in bf16.  After the scrub
    # the group spans the 1024-dimensional complement of Qprev: effectively
    # a square matrix, whose later panels are ill-conditioned.
    Qfull = torch.linalg.qr(
        torch.rand((2048, 2048), generator=gen, device=dev) - 0.5
    )[0].contiguous()
    robust_tail = (False,) * 7 + (True,)
    eye_w = torch.eye(1024, device=dev)
    k5_rows, k5_err = {}, 0.0
    for bf in (False, True):
        Qprev = Qfull.to(torch.bfloat16 if bf else torch.float32)[:, :1024]
        kw = dict(bf16_dots=bf, chain_mid=bf)

        def contract(Qg, Rprev, Rg):
            """Reconstruction, orthogonality and cross-orthogonality."""
            rec = rel_fro(mm_f32(Qprev, Rprev) + mm_f32(Qg, Rg), Pg)
            return (rec, max_abs(mm_f32(Qg.T, Qg), eye_w),
                    float(mm_f32(Qprev.T, Qg).abs().max()))

        Qg, Rprev, Rg, w = bgs_group_fused_proj(Pg, Qprev, 128, iters,
                                                robust_tail, **kw)
        again = bgs_group_fused_proj(Pg, Qprev, 128, iters, robust_tail,
                                     **kw)
        Qp, Rprevp, Rgp, wp = bgs_group_fused_proj_plain(
            Pg, Qprev, 128, iters, robust_tail, **kw)
        torch.cuda.synchronize()
        ck, cp = contract(Qg, Rprev, Rg), contract(Qp, Rprevp, Rgp)
        row = {"max_abs_Q": max_abs(Qg, Qp), "rel_Q": rel_fro(Qg, Qp),
               "rel_Q_panels": [rel_fro(Qg[:, j:j + 128], Qp[:, j:j + 128])
                                for j in range(0, 1024, 128)],
               "rel_Rprev": rel_fro(Rprev, Rprevp),
               "rel_Rg": rel_fro(Rg, Rgp),
               "reconstruction": ck[0], "reconstruction_plain": cp[0],
               "orthogonality": ck[1], "orthogonality_plain": cp[1],
               "cross": ck[2], "cross_plain": cp[2],
               "resid": float(w), "resid_plain": float(wp),
               "bitwise_repeatable": bitwise_equal((Qg, Rprev, Rg, w), again)}
        tol = TOL_BF16 if bf else TOL_F32
        ok = (row["rel_Rprev"] <= tol and row["rel_Rg"] <= tol
              and row["bitwise_repeatable"])
        if bf:
            # bf16 roundings that flip between the two versions are
            # amplified by the later panels' conditioning, so Q is held
            # entry-wise on the first panel and by the factorization's
            # contract on the whole group: within 2x of the plain version's.
            ok = ok and row["rel_Q_panels"][0] <= TOL_BF16 and all(
                a <= 2 * b for a, b in zip(ck, cp))
        else:
            ok = ok and row["max_abs_Q"] <= TOL_F32
        row["ok"] = ok and (row["resid"] < 1e-4) == (
            row["resid_plain"] < 1e-4)
        row["ms"] = cuda_time_ms(lambda: bgs_group_fused_proj(
            Pg, Qprev, 128, iters, robust_tail, **kw))
        row["plain_ms"] = cuda_time_ms(lambda: bgs_group_fused_proj_plain(
            Pg, Qprev, 128, iters, robust_tail, **kw), warmup=1, iters=5)

        def library_k5():
            C2 = torch.matmul(Qprev.float().T, Pg)
            return torch.linalg.qr(Pg - torch.matmul(Qprev.float(), C2))

        row["library_ms"] = cuda_time_ms(library_k5)
        row.update(device_kernels(lambda: bgs_group_fused_proj(
            Pg, Qprev, 128, iters, robust_tail, **kw)))
        k5_rows["bf16" if bf else "fp32"] = row
        k5_err = max(k5_err, row["max_abs_Q"])
        assert not Qprev.is_contiguous() and Qprev.stride(0) == 2048
        assert row["ok"], (bf, row)
    emit({"phase": "kernels", "kernel": "bgs_group_fused_proj",
          "shape": [2048, 1024], "r": 128, "g": 8, "p": 1024,
          "tolerance": "fp32: max|dQ| <= 1e-4, ||dRprev||, ||dRg|| <= 1e-4 "
                       "relative; bf16 (bf16 Qprev): ||dRprev||, ||dRg|| "
                       "and the first panel's ||dQ|| <= 5e-3 relative, and "
                       "reconstruction, orthogonality and |Qprev^T Qg| "
                       "within 2x of the plain version's; two launches "
                       "bitwise equal; plain ms: median of 5",
          "configs": k5_rows,
          "library_call": "two torch.matmul and torch.linalg.qr of the "
                          "scrubbed group", "card": card})

    # K8 at 2048^3, on a ragged shape whose row strides TMA can describe
    # (1000 x 520 x 776) and on one it cannot (1000 x 777 x 513: bf16 rows
    # of 1,026 bytes), every type combination, with the route each call
    # took: bf16 (wgmma) and f32 (fp32 FMA) are fed by TMA where base and
    # strides allow it, everything else goes through the predicated loaders.  int8 and uint8
    # against the exact integer product: float64 on the card (every partial
    # sum is an integer below 2^53) and, at the ragged shapes, int64 on the
    # host as well.
    def exact_product(x, y):
        return torch.matmul(x.double(), y.double()).long()

    def bf16_ulp_ok(c, ref, slack):
        """One bf16 ulp apart at most, beyond the fp32 sums' own
        difference (``slack``: sums that cancel to near zero differ by
        many ulps of their small result)."""
        ulp = ref.float().abs() * 2.0 ** -7
        return bool(((c.float() - ref.float()).abs() <= ulp + slack).all())

    combos = {"f32": (torch.float32, torch.float32),
              "bf16_f32": (torch.bfloat16, torch.float32),
              "bf16_bf16": (torch.bfloat16, torch.bfloat16)}
    k8_rows, k8_err = {}, 0.0
    for m8, kk8, n8, float_route in ((2048, 2048, 2048, "tma"),
                                     (1000, 520, 776, "tma"),
                                     (1000, 777, 513, "predicated")):
        a8 = torch.rand((m8, kk8), generator=gen, device=dev) - 0.5
        b8 = torch.rand((kk8, n8), generator=gen, device=dev) - 0.5
        for cname, (dt, od) in combos.items():
            x, y = a8.to(dt), b8.to(dt)
            c = tiled_matmul(x, y, od)
            route = gemm_mod.last_route
            cp = tiled_matmul_plain(x, y, od)
            torch.cuda.synchronize()
            err = max_abs(c.float(), cp.float())
            lim = TOL_F32 * float(cp.float().abs().max())
            row = {"max_abs": err, "lim": lim, "route": route}
            assert route == float_route, (cname, row)
            if od == torch.bfloat16:
                # the kernel's own fp32 result, rounded once
                row["one_rounding"] = bool(torch.equal(
                    c, tiled_matmul(x, y, torch.float32).bfloat16()))
                row["ok"] = row["one_rounding"] and bf16_ulp_ok(c, cp, lim)
            else:
                row["ok"] = err <= lim
                k8_err = max(k8_err, err)
            row["ms"] = cuda_time_ms(lambda: tiled_matmul(x, y, od))
            row["plain_ms"] = cuda_time_ms(
                lambda: tiled_matmul_plain(x, y, od))
            row["library_ms"] = (
                cuda_time_ms(lambda: torch.mm(x, y)) if dt == od else
                cuda_time_ms(lambda: torch.mm(x, y, out_dtype=od)))
            k8_rows[f"{m8}x{kk8}x{n8}_{cname}"] = row
            assert row["ok"], (cname, row)
        ai = torch.randint(-128, 128, (m8, kk8), generator=gen, device=dev,
                           dtype=torch.int8)
        bi = torch.randint(-128, 128, (kk8, n8), generator=gen, device=dev,
                           dtype=torch.int8)
        au = torch.randint(0, 256, (m8, kk8), generator=gen, device=dev,
                           dtype=torch.uint8)
        bu = torch.randint(0, 256, (kk8, n8), generator=gen, device=dev,
                           dtype=torch.uint8)
        ci = matmul_int8_accum_i32(ai, bi)
        assert gemm_mod.last_route == "predicated"
        cu = matmul_uint8_accum_i32(au, bu)
        torch.cuda.synchronize()
        row = {"route": "predicated",
               "int8_exact": bool(torch.equal(ci.long(),
                                              exact_product(ai, bi))),
               "uint8_exact": bool(torch.equal(cu.long(),
                                               exact_product(au, bu))),
               "int8_equals_plain": bool(torch.equal(
                   ci, tiled_matmul_plain(ai, bi, torch.int32))),
               "ms": cuda_time_ms(lambda: matmul_int8_accum_i32(ai, bi)),
               "plain_ms": cuda_time_ms(
                   lambda: tiled_matmul_plain(ai, bi, torch.int32)),
               "uint8_ms": cuda_time_ms(
                   lambda: matmul_uint8_accum_i32(au, bu))}
        # torch._int_mm takes k and n in multiples of 8 only
        row["library_ms"] = (cuda_time_ms(lambda: torch._int_mm(ai, bi))
                             if kk8 % 8 == 0 and n8 % 8 == 0 else None)
        if m8 != 2048:
            row["int8_exact_host"] = bool(torch.equal(
                ci.cpu().long(), ai.cpu().long() @ bi.cpu().long()))
            row["uint8_exact_host"] = bool(torch.equal(
                cu.cpu().long(), au.cpu().long() @ bu.cpu().long()))
        row["ok"] = all(v for k, v in row.items() if "exact" in k
                        or k == "int8_equals_plain")
        k8_rows[f"{m8}x{kk8}x{n8}_int8"] = row
        assert row["ok"], row
    # Column slices of a wider row-major bf16 buffer, read in place: at a
    # 16-byte offset the TMA route, at an odd one the predicated route;
    # m = 1 and n = 1; k = 0 gives zeros in every combination.
    wide = (torch.rand((512, 1024), generator=gen, device=dev)
            - 0.5).bfloat16()
    edge = {}
    for off, want in ((8, "tma"), (3, "predicated")):
        x, y = wide[:, off:off + 256], wide[:256, off:off + 384]
        c = tiled_matmul(x, y, torch.float32)
        route = gemm_mod.last_route
        cp = tiled_matmul_plain(x, y, torch.float32)
        edge[f"slice_offset_{off}"] = {
            "route": route, "max_abs": max_abs(c, cp),
            "lim": TOL_F32 * float(cp.abs().max())}
        assert route == want and max_abs(c, cp) <= TOL_F32 * float(
            cp.abs().max()), edge
    # The route rule lives in gemm.py alone: the C entry, asked for TMA on
    # the odd-offset slices, is refused by the tensor-map encoder and
    # launches nothing.
    c = torch.empty((512, 384), device=dev)
    edge["tma_refused_code"] = _build.library().mpbqr_tiled_matmul(
        x.data_ptr(), y.data_ptr(), c.data_ptr(), 512, 384, 256, 1024, 1024,
        384, 1, 1, torch.cuda.current_stream().cuda_stream)
    assert edge["tma_refused_code"] != 0, edge
    for ename, (em, ek, en) in (("m1", (1, 512, 384)), ("n1", (256, 512, 1)),
                                ("k0", (300, 0, 200))):
        a1 = torch.rand((em, ek), generator=gen, device=dev) - 0.5
        b1 = torch.rand((ek, en), generator=gen, device=dev) - 0.5
        row = {}
        for cname, (dt, od) in combos.items():
            x, y = a1.to(dt), b1.to(dt)
            c = tiled_matmul(x, y, od)
            cp = tiled_matmul_plain(x, y, od)
            row[cname] = {"route": gemm_mod.last_route,
                          "max_abs": max_abs(c.float(), cp.float())}
            lim = TOL_F32 * float(cp.float().abs().max()) if ek else 0.0
            if od == torch.bfloat16:
                assert bf16_ulp_ok(c, cp, lim), (ename, row)
            else:
                assert row[cname]["max_abs"] <= lim, (ename, row)
        ai = torch.randint(-128, 128, (em, ek), generator=gen, device=dev,
                           dtype=torch.int8)
        bi = torch.randint(-128, 128, (ek, en), generator=gen, device=dev,
                           dtype=torch.int8)
        row["int8_exact"] = bool(torch.equal(
            matmul_int8_accum_i32(ai, bi).long(), exact_product(ai, bi)))
        assert row["int8_exact"], (ename, row)
        edge[ename] = row
    assert edge["m1"]["bf16_f32"]["route"] == "tma", edge
    assert edge["m1"]["f32"]["route"] == "tma", edge
    assert edge["n1"]["f32"]["route"] == "predicated", edge
    assert edge["k0"]["bf16_f32"]["route"] == "predicated", edge
    emit({"phase": "kernels", "kernel": "tiled_matmul",
          "tolerance": "f32 and bf16 -> f32: max|diff| <= 1e-4 * max|plain| "
                       "(summation order); bf16 -> bf16: equal to the bf16 "
                       "-> f32 result rounded once, and within one bf16 ulp "
                       "plus that limit of the plain version; int8 and uint8: torch.equal with the "
                       "exact integer product",
          "routes": "bf16 and f32 with 16-byte-aligned bases and row strides "
                    "and k > 0: wgmma / fp32 FMA fed by TMA; everything "
                    "else: predicated loaders (mma.sync for bf16 and int8, "
                    "fp32 FMA for f32)",
          "edges": edge,
          "library_call": "torch.mm (out_dtype=float32 for bf16 -> f32), "
                          "torch._int_mm",
          "shapes": k8_rows, "card": card})

    # K9 on Grams of a seeded 2048 x r panel (extra columns for r = 1024
    # from a generator of their own, so that the later phases' inputs stay
    # as they were), on a Gram of condition 1e6 and on an indefinite one.
    P9 = torch.rand((2048, 512), generator=gen, device=dev) - 0.5
    gen9 = torch.Generator(device=dev).manual_seed(9)
    P9 = torch.cat([P9, torch.rand((2048, 512), generator=gen9,
                                   device=dev) - 0.5], dim=1)

    eyes = {}

    def library_k9(Gl):
        n = Gl.shape[0]
        if n not in eyes:
            eyes[n] = torch.eye(n, device=dev)
        Rl = torch.linalg.cholesky_ex(Gl, upper=True)[0]
        return Rl, torch.linalg.solve_triangular(Rl, eyes[n], upper=True)

    k9_rows, k9_err = {}, 0.0
    for r9 in (32, 96, 128, 256, 320, 512, 1024):
        G9 = mm_f32(P9[:, :r9].T, P9[:, :r9]).contiguous()
        eye9 = torch.eye(r9, device=dev)
        R9, Ri9 = chol_rinv(G9)
        R9b, Ri9b = chol_rinv(G9)
        Rp9, Rip9 = chol_rinv_plain(G9)
        torch.cuda.synchronize()
        lay9 = chol_layout(r9)
        row = {"cluster": lay9.cluster, "stripe": lay9.stripe,
               "route": "smem" if lay9.in_smem else "in_place",
               "max_abs_R": max_abs(R9, Rp9),
               "lim_R": TOL_F32 * float(Rp9.abs().max()),
               "max_abs_Rinv": max_abs(Ri9, Rip9),
               "lim_Rinv": TOL_F32 * float(Rip9.abs().max()),
               "factor": max_abs(mm_f32(R9.T, R9), G9)
               / float(G9.abs().max()),
               "inverse": max_abs(mm_f32(R9, Ri9), eye9),
               "lower_zero": bool((torch.tril(R9, -1) == 0).all()
                                  and (torch.tril(Ri9, -1) == 0).all()),
               "bitwise_repeatable": bool(torch.equal(R9, R9b)
                                          and torch.equal(Ri9, Ri9b))}
        row["ok"] = (row["max_abs_R"] <= row["lim_R"]
                     and row["max_abs_Rinv"] <= row["lim_Rinv"]
                     and row["factor"] <= 1e-5 and row["inverse"] <= 1e-4
                     and row["lower_zero"] and row["bitwise_repeatable"])
        row["ms"] = cuda_time_ms(lambda: chol_rinv(G9))
        row["plain_ms"] = cuda_time_ms(lambda: chol_rinv_plain(G9),
                                       warmup=1, iters=3)
        row["library_ms"] = cuda_time_ms(lambda: library_k9(G9))
        row.update(chol_rinv_bound(r9))
        k9_rows[f"r{r9}"] = row
        k9_err = max(k9_err, row["max_abs_R"], row["max_abs_Rinv"])
        assert row["ok"], (r9, row)
    # Condition 1e3 panel (singular values logspace(0, -3)): the factor's
    # and the inverse's residuals (float64, Frobenius) within 2x of the
    # plain version's on the same G.
    Uc = torch.linalg.qr(torch.rand((2048, 256), generator=gen9,
                                    device=dev) - 0.5)[0]
    Vc = torch.linalg.qr(torch.rand((256, 256), generator=gen9,
                                    device=dev) - 0.5)[0]
    Pc = mm_f32(Uc * torch.logspace(0, -3, 256, device=dev), Vc.T)
    Gc = mm_f32(Pc.T, Pc).contiguous()
    Gd, eye_d = Gc.double(), torch.eye(256, dtype=torch.float64, device=dev)

    def residuals(Rr, Rri):
        Rr, Rri = Rr.double(), Rri.double()
        return (float(torch.linalg.norm(Rr.T @ Rr - Gd) / torch.linalg.norm(Gd)),
                float(torch.linalg.norm(Rr @ Rri - eye_d)))

    Rc, Ric = chol_rinv(Gc)
    Rc2, Ric2 = chol_rinv(Gc)
    fk, ik = residuals(Rc, Ric)
    fp, ip = residuals(*chol_rinv_plain(Gc))
    cond_row = {"factor": fk, "factor_plain": fp, "inverse": ik,
                "inverse_plain": ip,
                "bitwise_repeatable": bool(torch.equal(Rc, Rc2)
                                           and torch.equal(Ric, Ric2))}
    cond_row["ok"] = (fk <= 2 * fp and ik <= 2 * ip
                      and cond_row["bitwise_repeatable"])
    k9_rows["cond1e3_r256"] = cond_row
    assert cond_row["ok"], cond_row
    G9 = mm_f32(P9[:, :512].T, P9[:, :512]).contiguous()
    G9[300, 300] = -1.0
    Rn, Rin = chol_rinv(G9)
    Rnp, _ = chol_rinv_plain(G9)
    torch.cuda.synchronize()
    k9_rows["indefinite_r512"] = {
        "nan_in_R": bool(torch.isnan(Rn).any()),
        "nan_in_Rinv": bool(torch.isnan(Rin).any()),
        "finite_before_the_pivot": bool(torch.isfinite(Rn[:288]).all()),
        "same_nan_rows_as_plain": bool(torch.equal(
            torch.isnan(Rn).any(dim=1), torch.isnan(Rnp).any(dim=1)))}
    assert all(k9_rows["indefinite_r512"].values()), k9_rows
    emit({"phase": "kernels", "kernel": "chol_rinv",
          "tolerance": "R and Rinv within 1e-4 * max|plain|; max|R^T R - G| "
                       "<= 1e-5 max|G|; max|R Rinv - I| <= 1e-4; exact "
                       "zeros below both diagonals; two calls bitwise "
                       "equal; condition 1e3 panel: ||R^T R - G||/||G|| and "
                       "||R Rinv - I|| within 2x of the plain version's; an "
                       "indefinite G gives NaN from its bad pivot on, in "
                       "the plain version's rows; plain ms: median of 3",
          "library_call": "torch.linalg.cholesky_ex(upper=True) + "
                          "solve_triangular against I",
          "sizes": k9_rows, "card": card})

    # G1-G3, the rotation chains of the streaming family (no pallas_call
    # behind them: the JAX package's lax.scan / fori_loop loops), through
    # utils/givens_probe.py: at phase 3's shapes (every G1 row-slot layout,
    # G3 with H on one CTA and on several) each launched twice, bit for
    # bit, G1 and G3 also bit for bit with their plain versions, timed
    # beside the plain version and a refactorization; at phase 19's
    # main-path shapes (n = 2048) checked once, the plain version not
    # timed.  A generator of their own keeps the later phases' draws.
    gen_g = torch.Generator(device=dev).manual_seed(15)
    g_rows = givens_probe.rows(givens_probe.PHASE3_SHAPES, gen_g)
    g_main = givens_probe.rows(givens_probe.MAIN_SHAPES, gen_g,
                               timed_plain=False)
    for name, row in {**g_rows, **g_main}.items():
        assert row["ok"], (name, row)
    g_step = givens_probe.chain_step(gen_g)
    assert g_step["step_ms"] > 0, g_step
    # G1's and G3's clock build (-DMPBQR_GIVENS_PROF, givens.cu alone) at
    # the main shapes, fresh and in place: every launch finishes, the
    # fresh one's outputs equal the library's bit for bit, and each summary
    # names its step phases (utils/givens_probe.py --phases).
    with _build.instrumented_library(*givens_probe.PROF_BUILD) as prof:
        g_phases = givens_probe.phase_rows(prof, gen_g,
                                           givens_probe._sm_mhz())
    for name, row in g_phases.items():
        assert row["kernel_us"] > 0 and row["front"]["warp_steps"] > 0, (
            name, row)
        assert row.get("same_as_library", True), (name, row)
    emit({"phase": "kernels", "kernel": "givens_fold_rows, givens_chain, "
          "givens_hessenberg",
          "tolerance": "every output within 1e-5 * max|plain| (R's upper "
                       "triangle for G1 and G3); two launches bitwise equal; "
                       "G1 and G3 bitwise equal to their plain versions; "
                       "times: CUDA events, median of 20 in place and on "
                       "fresh inputs (plain: median of 3)",
          "library_call": "G1: torch.linalg.qr(cat([Raug, rows]), "
                          "mode='r'); G2, G3: torch.linalg.qr(A + u v^T), "
                          "the refactorization",
          "rows": g_rows, "main_path_shapes": g_main,
          "chain_step": g_step, "phases": g_phases,
          "serial_floor_ms": {name: row["serial_steps"] * g_step["step_ms"]
                              for name, row in {**g_rows, **g_main}.items()},
          "card": card})

    # K1, K4, the combine, K3, K2 and K5 at panel widths other than 32, 64
    # and 128 (utils/width_probe.py): r = 48, 100, 125 on the shared-memory
    # route of the instantiation that holds them, 192 and 256 on the L2
    # route, each against its plain version with its r = 128 row's
    # tolerance, launched twice and compared bit for bit, with its route,
    # CTAs and time.  Each width draws from a generator of its own, so the
    # later phases' inputs stay the draws they were.
    wrows = width_probe.width_rows(dev)
    # K1, K4 and the combine alone at the L2 route's edges (r = 129, 200,
    # 512, 1024: the narrowest, a width of ragged tiles, and the widest
    # two) with the same tolerances and bitwise repeat (K4: a NaN in S
    # gives a NaN resid at every width, 256 included), and K1's batched 4
    # x 256 stack above, each member bit for bit its single launch.
    for name, rows_l2 in width_probe.l2_edge_rows(dev).items():
        wrows[name].update(rows_l2)
    k1_l2_stack = k1b_rows["l2_chain_mid_4x256"]
    assert k1_l2_stack["ok"] and k1_l2_stack["members_bitwise_single_launch"]
    for name, by_r in wrows.items():
        for r_w, row in by_r.items():
            assert row["ok"], (name, r_w, row)
        extra = ({"batched_4x256": {k: k1_l2_stack[k] for k in (
            "ok", "members_bitwise_single_launch", "bitwise_repeatable",
            "max_abs_err", "resident_clusters", "waves", "loop_ms")}}
            if name == "ns_chain" else {})
        emit({"phase": "kernels_widths", "kernel": name, **extra,
              "tolerance": "as the kernel's r = 128 row: fp32 1e-4 of the "
                           "plain version's scale, bf16 flags 5e-3 "
                           "relative; the same canary / fallback class; "
                           "two launches bitwise equal; plain ms: median "
                           "of 5",
              "widths": {str(r_w): row for r_w, row in by_r.items()},
              "card": card})

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
    # 16 K6 per Householder stage: block_qr_qtb's 16 panels of the
    # 4096 x 2048 J (4096 down to 2176 rows), then lstsq_pivoted's
    # qr(R[:1984].T), 2048 x 1984: 15 panels of 128 columns and one of 64.
    assert c7["panel_qr_fused"] == 16 and c7["sketch_qrcp_ranks"] == 16, c7
    assert c7["panel_factor_fused"] == 32, c7
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
    for k in ("panel_qr_fused", "sketch_qrcp_ranks", "panel_factor_fused"):
        assert c7[k] > 0, f"{k} was not launched on the lstsq path"

    # 8. the robust Householder tier on the 2048^2 input: 16 K6 panels,
    # held against the metric triple and against R of a POLICY_FP64
    # 'householder' run on the card (float64 panels stay on panel_factor's
    # column loop, no K6)
    torch.cuda.synchronize()
    reset_launches()
    Q8, R8 = block_qr(A, 128, POLICY_FP32, panel_method="householder")
    torch.cuda.synchronize()
    c8 = dict(LAUNCHES)
    rep8 = metrics.evaluate(A, Q8, R8, POLICY_FP32.precision_bits)
    assert c8["panel_factor_fused"] == 16, c8
    assert rep8.all_ok and rep8.tight_ok, str(rep8)
    reset_launches()
    t0 = time.perf_counter()
    R64 = block_qr(A.double(), 128, POLICY_FP64, mode="r",
                   panel_method="householder")
    torch.cuda.synchronize()
    fp64_s = time.perf_counter() - t0
    assert LAUNCHES["panel_factor_fused"] == 0, dict(LAUNCHES)
    rel8 = float(torch.linalg.norm(R8.double() - R64)
                 / torch.linalg.norm(R64))
    assert rel8 <= 1e-4, rel8
    R64_8 = R64  # phase 24 holds its block-256 R against it
    ms8 = cuda_time_ms(
        lambda: block_qr(A, 128, POLICY_FP32, panel_method="householder"),
        warmup=1, iters=5)
    emit({"phase": "robust", "call": "block_qr 2048^2 POLICY_FP32 "
          "householder reduced", "launches": c8,
          "rel_R_vs_fp64_loop": rel8, "fp64_loop_seconds": fp64_s,
          "tolerance": "metric triple all_ok and tight_ok; R within 1e-4 "
                       "relative (Frobenius) of the POLICY_FP64 plain "
                       "loop's", "backward": rep8.backward,
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

    # 10. householder_pallas: every panel through K6.  Phase 8's
    # 'householder' runs K6 on the card too, so R against phase 8's is K6
    # against K6; phase 8 holds K6 against the float64 loop.
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
          "rel_R_vs_householder_note": "K6 against K6: phase 8's "
                                       "'householder' runs K6 on the card",
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

    # 13. proj_entry: the headline factorization with the inter-group
    # projection inside the second group's kernel (K5), beside the default
    # route with the projection between the groups.
    def bgs_headline(pe):
        return bq._block_qr_bgs(A, 128, POLICY_MIXED_FAST, True,
                                group_panels=8, reorth=False, chain_mid=True,
                                proj_entry=pe)

    torch.cuda.synchronize()
    reset_launches()
    R13, Q13, _ = bgs_headline(True)
    torch.cuda.synchronize()
    c13 = dict(LAUNCHES)
    R13d, Q13d, _ = bgs_headline(False)
    rep13 = metrics.evaluate(A, Q13, R13, POLICY_MIXED_FAST.precision_bits)
    rel13 = rel_fro(R13, R13d)
    assert (c13["bgs_group_fused"], c13["bgs_group_fused_proj"]) == (1, 1), c13
    assert rep13.all_ok, str(rep13)
    assert rep13.backward <= 2 * rep.backward, (rep13.backward, rep.backward)
    assert rep13.orthogonality <= 2 * rep.orthogonality, str(rep13)
    assert rel13 <= TOL_BF16, rel13
    # alternating, so that neither arm always runs on the warmer card
    ms13, ms13d = [], []
    for _ in range(2):
        ms13.append(cuda_time_ms(lambda: bgs_headline(True), warmup=1,
                                 iters=10))
        ms13d.append(cuda_time_ms(lambda: bgs_headline(False), warmup=1,
                                  iters=10))
    emit({"phase": "proj_entry", "call": "_block_qr_bgs 2048^2 "
          "POLICY_MIXED_FAST g8 bgs1 proj_entry=True", "launches": c13,
          "backward": rep13.backward, "orthogonality": rep13.orthogonality,
          "all_ok": rep13.all_ok, "tight_ok": rep13.tight_ok,
          "rel_R_vs_default": rel13, "ms": min(ms13), "ms_runs": ms13,
          "default_ms": min(ms13d), "default_ms_runs": ms13d,
          "tolerance": "backward and orthogonality within 2x of phase 4's; "
                       "R within 5e-3 (relative Frobenius) of the default "
                       "route's", "card": card})

    # 14. scan: (a) the auto-dispatched large call; (b) the all-robust bgs
    # scan tier through K3; (c) the same factorization checkpointed,
    # stopped and resumed.
    assert resolve_panel_config(
        16384, 16384, 128, POLICY_MIXED_FAST, "auto", "unroll", 4,
        mode="complete", on_gpu=True, quality="fast",
    ) == ("bgs1", "scan", 4)
    a14 = np.random.default_rng(0).random((16384, 16384),
                                          dtype=np.float32) - 0.5
    A14 = torch.from_numpy(a14).to(dev)
    del a14
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    Q14, R14 = headline(A14)
    torch.cuda.synchronize()
    c14 = dict(LAUNCHES)
    peak14 = torch.cuda.max_memory_allocated()
    assert c14["ns_chain"] == 3 * 128 and c14["panel_qr_fused"] == 0, c14
    rep14 = metrics.evaluate(A14, Q14, R14, POLICY_MIXED_FAST.precision_bits)
    assert rep14.all_ok, str(rep14)
    del Q14, R14
    ms14 = cuda_time_ms(lambda: headline(A14), warmup=1, iters=3)
    del A14
    torch.cuda.empty_cache()
    row14 = {"a": {"call": "block_qr 16384^2 POLICY_MIXED_FAST complete "
                   "auto fast defer", "resolved": ["bgs1", "scan", 4],
                   "launches": c14, "backward": rep14.backward,
                   "orthogonality": rep14.orthogonality,
                   "lower_trapezoid": rep14.lower_trapezoid,
                   "all_ok": rep14.all_ok, "tight_ok": rep14.tight_ok,
                   "ms": ms14, "timing": "median of 3",
                   "tflops": qr_flops(16384, 16384) / (ms14 * 1e-3) / 1e12,
                   "peak_bytes": peak14}}

    def bgs_scan(x):
        return block_qr(x, 128, POLICY_FP32, panel_method="bgs",
                        loop_mode="scan")

    torch.cuda.synchronize()
    reset_launches()
    Q14b, R14b = bgs_scan(A4)
    torch.cuda.synchronize()
    c14b = dict(LAUNCHES)
    rep14b = metrics.evaluate(A4, Q14b, R14b, POLICY_FP32.precision_bits)
    assert c14b["panel_qr_fused"] == 32, c14b
    assert rep14b.all_ok and rep14b.tight_ok, str(rep14b)
    row14["b"] = {"call": "block_qr 4096^2 POLICY_FP32 bgs scan",
                  "launches": c14b, "backward": rep14b.backward,
                  "orthogonality": rep14b.orthogonality,
                  "all_ok": rep14b.all_ok, "tight_ok": rep14b.tight_ok,
                  "ms": cuda_time_ms(lambda: bgs_scan(A4), warmup=1, iters=3),
                  "timing": "median of 3"}

    with tempfile.TemporaryDirectory() as ckdir:
        kw14 = dict(block_size=128, policy=POLICY_FP32, segment_groups=8)
        t0 = time.perf_counter()
        stopped = block_qr_resumable(A4, ckdir, max_segments=3, **kw14)
        left_mid = sorted(os.listdir(ckdir))
        Q14c, R14c = block_qr_resumable(A4, ckdir, **kw14)
        torch.cuda.synchronize()
        resumable_s = time.perf_counter() - t0
        left_end = sorted(os.listdir(ckdir))
    row14["c"] = {"call": "block_qr_resumable 4096^2 POLICY_FP32, 8 steps "
                  "per segment, stopped after 3 segments and resumed",
                  "stopped_returned_none": stopped is None,
                  "checkpoints_when_stopped": left_mid,
                  "checkpoints_at_end": left_end,
                  "q_equal": bool(torch.equal(Q14c, Q14b)),
                  "r_equal": bool(torch.equal(R14c, R14b)),
                  "seconds": resumable_s}
    assert stopped is None and left_mid == ["step_24"], row14["c"]
    assert left_end == ["step_32"], row14["c"]
    assert row14["c"]["q_equal"] and row14["c"]["r_equal"], row14["c"]
    emit({"phase": "scan", **row14, "card": card})
    del Q14b, R14b, Q14c, R14c

    # 15. exported: K8 and K9 have no driver above them, in the JAX package
    # either; their path is their own entry point.  One CholeskyQR2 panel
    # built from them: Gram by tiled_matmul, chol_rinv, Q = P Rinv, twice.
    P15 = torch.rand((4096, 256), generator=gen, device=dev) - 0.5
    torch.cuda.synchronize()
    reset_launches()
    Qc, Rc = P15, None
    for _ in range(2):
        G15 = tiled_matmul(Qc.T.contiguous(), Qc)
        Rk, Rik = chol_rinv(G15)
        Qc = tiled_matmul(Qc, Rik)
        Rc = Rk if Rc is None else tiled_matmul(Rk, Rc)
    C15 = matmul_bf16_accum_f32(A, A)
    torch.cuda.synchronize()
    c15 = dict(LAUNCHES)
    routes15 = dict(ROUTE_LAUNCHES)
    orth15 = max_abs(mm_f32(Qc.T, Qc), torch.eye(256, device=dev))
    rec15 = rel_fro(mm_f32(Qc, Rc), P15)
    mm15 = rel_fro(C15, torch.mm(A.bfloat16(), A.bfloat16(),
                                 out_dtype=torch.float32))
    assert c15["tiled_matmul"] == 6 and c15["chol_rinv"] == 2, c15
    # five fp32 products and one bf16 product, all fed by TMA
    assert routes15 == {"tma": 6, "predicated": 0}, routes15
    assert orth15 <= 1e-5 and rec15 <= 1e-5 and mm15 <= 1e-5, (
        orth15, rec15, mm15)

    def cholqr2_panel(chol):
        # cholesky_ex(upper=True) and solve_triangular return column-major
        # factors; tiled_matmul takes row-major operands (a no-op for
        # chol_rinv's).
        Qp, Rp = P15, None
        for _ in range(2):
            Rk, Rik = (x.contiguous()
                       for x in chol(tiled_matmul(Qp.T.contiguous(), Qp)))
            Qp = tiled_matmul(Qp, Rik)
            Rp = Rk if Rp is None else tiled_matmul(Rk, Rp)
        return Qp, Rp

    panel_ms = cuda_time_ms(lambda: cholqr2_panel(chol_rinv))
    panel_library_ms = cuda_time_ms(lambda: cholqr2_panel(library_k9))
    emit({"phase": "exported", "call": "CholeskyQR2 of a 4096 x 256 panel "
          "through tiled_matmul and chol_rinv; matmul_bf16_accum_f32 at "
          "2048^3", "launches": c15, "tiled_matmul_routes": routes15,
          "orthogonality": orth15,
          "reconstruction": rec15, "bf16_matmul_rel_vs_torch": mm15,
          "panel_ms": panel_ms, "panel_with_library_chol_ms": panel_library_ms,
          "tolerance": "max|Q^T Q - I|, ||QR - P||/||P|| and the bf16 "
                       "product's relative distance from torch.mm <= 1e-5; "
                       "panel times: CUDA events, median of 20",
          "card": card})

    # 16. tsqr: the tall-skinny cell, 100000 x 64 (seed 0, uniform - 0.5):
    # 64 leaves of 1563 rows in one batched K6 launch, then one for each of
    # the 6 tree levels' 32, 16, ..., 1 nodes of 128 x 64 (127 panels).
    a16 = np.random.default_rng(0).random((100000, 64),
                                          dtype=np.float32) - 0.5
    A16 = torch.from_numpy(a16).to(dev)
    leaves16 = tsqr_mod._pick_leaves(100000, 64, None)
    assert leaves16 == 64, leaves16
    levels16 = 1 + leaves16.bit_length() - 1
    torch.cuda.synchronize()
    reset_launches()
    Q16, R16 = tsqr(A16)
    torch.cuda.synchronize()
    c16 = dict(LAUNCHES)
    b16c = batched_counts(main_path=True)
    assert c16["panel_factor_fused"] == levels16 == 7, c16
    assert b16c == {"launches": levels16, "members": 2 * leaves16 - 1}, b16c
    rep16 = metrics.evaluate(A16, Q16, R16, POLICY_FP32.precision_bits)
    assert rep16.all_ok, str(rep16)
    b16n = np.random.default_rng(1).standard_normal(100000).astype(
        np.float32)
    b16 = torch.from_numpy(b16n).to(dev)
    reset_launches()
    x16 = lstsq(A16, b16, method="tsqr")
    torch.cuda.synchronize()
    c16_lstsq = dict(LAUNCHES)
    b16c_lstsq = batched_counts(main_path=True)
    assert c16_lstsq["panel_factor_fused"] == levels16, c16_lstsq
    assert b16c_lstsq == b16c, b16c_lstsq
    row16 = solve_errors(a16, b16n, x16)
    assert row16["resid_rel"] <= 1e-5 and row16["x_rel_err"] <= 1e-4, row16
    row16.update({
        "k6_batched": b16c,
        "ms": cuda_time_ms(lambda: tsqr(A16), warmup=1, iters=5),
        "k6_device_ms": k6_device_ms(lambda: tsqr(A16)),
        "library_qr_ms": cuda_time_ms(lambda: torch.linalg.qr(A16),
                                      warmup=1, iters=5),
        "one_k6_whole_panel_ms": cuda_time_ms(
            lambda: panel_factor_fused(A16), warmup=1, iters=5),
        "one_k6_whole_panel_layout": list(panel_layout(
            100000, 64, panel_max_cluster(dev))),
        "k6_layouts": layouts_of(lambda: tsqr(A16), dev),
        "lstsq_tsqr_ms": cuda_time_ms(
            lambda: lstsq(A16, b16, method="tsqr"), warmup=1, iters=5)})
    emit({"phase": "tsqr", "call": "tsqr(A) 100000 x 64 fp32 (seed 0 "
          "uniform - 0.5); lstsq(A, b, method='tsqr')", "leaves": leaves16,
          "launches": c16, "lstsq_launches": c16_lstsq,
          "backward": rep16.backward, "orthogonality": rep16.orthogonality,
          "lower_trapezoid": rep16.lower_trapezoid, "all_ok": rep16.all_ok,
          "tight_ok": rep16.tight_ok, **row16,
          "tolerance": "metric triple within 2^-23 m; lstsq residual 1e-5 "
                       "and x 1e-4 relative of float64 np.linalg.lstsq; "
                       "times: CUDA events, median of 5", "card": card})
    del Q16, R16, A16

    # 17. refine: lstsq(J, b, refine_steps=2) on the full-rank SLAM Jacobian
    # (rank 2048, condition 18.5 in float64): stored-factor CAQR at 128
    # columns a panel, no reroute; then lstsq_batched on 8 systems.
    Jn17 = slam_jacobian(4096, 2048, seed=0)
    bn17 = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    J17 = torch.from_numpy(Jn17).to(dev)
    b17 = torch.from_numpy(bn17).to(dev)
    w17 = min(128, max(2048 // 2, 1))
    blocks17 = [caqr_mod._pick_row_blocks(4096 - lam, w17, None)
                for lam in range(0, 2048, w17)]
    # one batched K6 for a panel's leaves and one for each tree level
    k6_17 = sum(L.bit_length() for L in blocks17)
    members17 = sum(2 * L - 1 for L in blocks17)
    torch.cuda.synchronize()
    reset_launches()
    x17 = lstsq(J17, b17, refine_steps=2)
    torch.cuda.synchronize()
    c17 = dict(LAUNCHES)
    b17c = batched_counts(main_path=True)
    # the CAQR path ran: K6 only, one launch a level of each panel's tree,
    # over all its leaves and nodes; a reroute to lstsq_pivoted would
    # launch K3 and K7
    assert (c17["panel_factor_fused"] == k6_17
            and c17["panel_qr_fused"] == 0
            and c17["sketch_qrcp_ranks"] == 0), (c17, k6_17)
    assert b17c == {"launches": k6_17, "members": members17}, (b17c,
                                                                members17)
    row17 = solve_errors(Jn17, bn17, x17)
    assert row17["rank_oracle"] == 2048, row17
    assert row17["resid_rel"] <= 1e-5 and row17["x_rel_err"] <= 1e-4, row17
    factors17, Rc17 = caqr_factor(J17, block_size=w17)
    x17_caqr = back_substitution(Rc17, apply_qt(factors17, b17[:, None])
                                 [:2048, :])[:, 0]
    row17["x_rel_err_caqr_no_sweeps"] = solve_errors(
        Jn17, bn17, x17_caqr)["x_rel_err"]
    row17["x_rel_err_blocked"] = solve_errors(
        Jn17, bn17, lstsq(J17, b17))["x_rel_err"]
    row17["k6_batched"] = b17c
    row17["ms"] = cuda_time_ms(lambda: lstsq(J17, b17, refine_steps=2),
                               warmup=1, iters=3)
    row17["k6_device_ms"] = k6_device_ms(
        lambda: lstsq(J17, b17, refine_steps=2))
    row17["k6_layouts"] = layouts_of(
        lambda: lstsq(J17, b17, refine_steps=2), dev)
    row17["blocked_ms"] = cuda_time_ms(lambda: lstsq(J17, b17), warmup=1,
                                       iters=3)
    row17["device_events"] = device_kernels(
        lambda: lstsq(J17, b17, refine_steps=2))["device_events"]
    row17["replay_device_events"] = device_kernels(
        lambda: apply_qt(factors17, b17[:, None]))["device_events"]
    del factors17, Rc17
    Abn = np.stack([slam_jacobian(2048, 512, seed=i) for i in range(8)])
    bbn = np.random.default_rng(2).standard_normal((8, 2048)).astype(
        np.float32)
    Ab = torch.from_numpy(Abn).to(dev)
    bb = torch.from_numpy(bbn).to(dev)
    torch.cuda.synchronize()
    reset_launches()
    xb = lstsq_batched(Ab, bb)
    torch.cuda.synchronize()
    cb = dict(LAUNCHES)
    bcb = batched_counts(main_path=True)
    # the Householder driver on the whole stack: one batched K6 a panel
    # step for the 8 systems, 4 launches for 32 panels
    assert (cb["panel_factor_fused"] == 4
            and bcb == {"launches": 4, "members": 32}), (cb, bcb)
    errs_b = [solve_errors(Abn[i], bbn[i], xb[i]) for i in range(8)]
    assert all(e["resid_rel"] <= 1e-5 and e["x_rel_err"] <= 1e-4
               for e in errs_b), errs_b

    def lstsq_loop():  # each system through the same driver, one by one
        out = []
        for i in range(8):
            R_i, _, qtb_i = bq._driver(Ab[i], 128, POLICY_FP32, False,
                                       bb[i][:, None], "householder",
                                       "unroll")
            out.append(back_substitution(R_i[:512], qtb_i[:512]))
        return out

    row_lb = {"call": "lstsq_batched on slam_jacobian(2048, 512, seed=i), "
                      "i < 8", "launches": cb, "k6_batched": bcb,
              "x_rel_err_max": max(e["x_rel_err"] for e in errs_b),
              "resid_rel_max": max(e["resid_rel"] for e in errs_b),
              "ms": cuda_time_ms(lambda: lstsq_batched(Ab, bb), warmup=1,
                                 iters=5),
              "member_loop_ms": cuda_time_ms(lstsq_loop, warmup=1, iters=5),
              "library_ms": cuda_time_ms(
                  lambda: torch.linalg.lstsq(Ab, bb[..., None]), warmup=1,
                  iters=5),
              "library_call": "torch.linalg.lstsq(Ab, bb[..., None])",
              "k6_device_ms": k6_device_ms(lambda: lstsq_batched(Ab, bb)),
              "k6_layouts": layouts_of(lambda: lstsq_batched(Ab, bb), dev)}

    # block_qr_batched on the same stack: the Householder tier on the
    # whole stack, one batched K6 a panel step; each member against its
    # single block_qr call; a NaN in member 3 poisons member 3 only.
    def qr_batched(x):
        return bq.block_qr_batched(x, 128, POLICY_FP32,
                                   panel_method="householder")

    def qr_single(x):
        return block_qr(x, 128, POLICY_FP32, panel_method="householder")

    torch.cuda.synchronize()
    reset_launches()
    Qbb, Rbb = qr_batched(Ab)
    torch.cuda.synchronize()
    cbq = dict(LAUNCHES)
    bbq = batched_counts(main_path=True)
    assert (cbq["panel_factor_fused"] == 4
            and bbq == {"launches": 4, "members": 32}), (cbq, bbq)
    reps_b = [metrics.evaluate(Ab[i], Qbb[i], Rbb[i],
                               POLICY_FP32.precision_bits) for i in range(8)]
    assert all(r.all_ok for r in reps_b), [str(r) for r in reps_b]
    rel_r = [rel_fro(Rbb[i], qr_single(Ab[i])[1]) for i in range(8)]
    assert max(rel_r) <= 1e-5, rel_r
    An = Ab.clone()
    An[3, 100, 200] = float("nan")
    Qn, Rn = qr_batched(An)
    assert bool(torch.isnan(Rn[3, 0, 0])), "member 3 not poisoned"
    others = [i for i in range(8) if i != 3]
    assert bool(torch.isfinite(Rn[others]).all()
                and torch.isfinite(Qn[others]).all()), "poison spread"
    del Qn, Rn, An
    # 3-D bf16 products (the batched drivers' under mixed policies): one
    # torch.bmm with fp32 output against each member's torch.mm
    gen17 = torch.Generator(device=dev).manual_seed(17)
    Xs = torch.randn((8, 2048, 128), generator=gen17, device=dev)
    Ys = torch.randn((8, 128, 384), generator=gen17, device=dev)
    each = torch.stack([mm_bf16(Xs[i], Ys[i]) for i in range(8)])
    bf16_err = max_abs(mm_bf16(Xs, Ys), each) / float(each.abs().max())
    assert bf16_err <= 1e-6, bf16_err
    del Xs, Ys, each
    row_qb = {"call": "block_qr_batched(A, 128, POLICY_FP32, "
                      "panel_method='householder') reduced, A the 8 x 2048 "
                      "x 512 stack above", "launches": cbq,
              "k6_batched": bbq,
              "backward_max": max(r.backward for r in reps_b),
              "orthogonality_max": max(r.orthogonality for r in reps_b),
              "all_ok": True, "rel_R_vs_single_max": max(rel_r),
              "nan_member_3": "R[3, 0, 0] NaN, the other 7 finite",
              "mm_bf16_3d_rel_err": bf16_err,
              "ms": cuda_time_ms(lambda: qr_batched(Ab), warmup=1, iters=5),
              "member_loop_ms": cuda_time_ms(
                  lambda: [qr_single(Ab[i]) for i in range(8)], warmup=1,
                  iters=5),
              "library_ms": cuda_time_ms(lambda: torch.linalg.qr(Ab),
                                         warmup=1, iters=5),
              "library_call": "torch.linalg.qr(A) on the stack",
              "k6_device_ms": k6_device_ms(lambda: qr_batched(Ab)),
              "k6_layouts": layouts_of(lambda: qr_batched(Ab), dev)}
    del Qbb, Rbb
    emit({"phase": "refine", "call": "lstsq(J, b, refine_steps=2), J = "
          "slam_jacobian(4096, 2048, seed=0), b from default_rng(2)",
          "caqr_panel_width": w17, "launches": c17, **row17,
          "batched": row_lb, "block_qr_batched": row_qb,
          "tolerance": "residual 1e-5 and x 1e-4 relative of float64 "
                       "np.linalg.lstsq (rcond = eps_f32 * m); "
                       "block_qr_batched: each member all_ok at 2^-23, R "
                       "1e-5 relative of its single block_qr; 3-D bf16 "
                       "products 1e-6 of each member's; times: CUDA "
                       "events, median of 3 (batched: 5); device events: "
                       "torch.profiler, one call", "card": card})
    del J17, b17, Ab, bb

    # 18. autodiff: qr_autodiff forward and backward on the first 1024
    # columns of the 2048^2 headline input, POLICY_FP32, against float64
    # torch.linalg.qr autograd on sign-canonicalized factors.
    A18 = A[:, :1024].contiguous()
    cfg18 = resolve_panel_config(2048, 1024, 128, POLICY_FP32, "auto",
                                 "unroll", 4, mode="reduced", on_gpu=True)
    gen18 = torch.Generator(device=dev).manual_seed(18)
    wq18 = torch.randn((2048, 1024), generator=gen18, device=dev)
    wr18 = torch.randn((1024, 1024), generator=gen18, device=dev)

    def loss18(Q, R, canon=True):
        d = torch.ones(R.shape[0], dtype=R.dtype, device=dev)
        if canon:
            d = torch.where(torch.diagonal(R) < 0, -d, d)
        return ((wq18.to(Q.dtype) * (Q * d[None, :])).sum()
                + (wr18.to(R.dtype) * (R * d[:, None])).sum())

    X18 = A18.clone().requires_grad_()
    torch.cuda.synchronize()
    reset_launches()
    Q18, R18 = qr_autodiff(X18, 128, POLICY_FP32)
    torch.cuda.synchronize()
    c18 = dict(LAUNCHES)
    loss18(Q18, R18).backward()
    torch.cuda.synchronize()
    c18_backward = {k: LAUNCHES[k] - c18[k] for k in LAUNCHES}
    assert cfg18[0] == "bgs" and c18["bgs_group_fused"] > 0, (cfg18, c18)
    assert not any(c18_backward.values()), c18_backward
    X64 = A18.double().requires_grad_()
    loss18(*torch.linalg.qr(X64)).backward()
    row18 = {"gA_rel_vs_fp64": rel_fro(X18.grad.double(), X64.grad)}
    Xn = A18.clone()
    Xn[5, 7] = float("nan")
    Xn.requires_grad_()
    Qn, Rn = qr_autodiff(Xn, 128, POLICY_FP32)
    (Qn.sum() + Rn.sum()).backward()
    row18["nan_in_nan_gA"] = bool(torch.isnan(Xn.grad).any())
    b18 = torch.randn(2048, generator=gen18, device=dev)
    t18 = torch.randn(1024, generator=gen18, device=dev)
    Xa, ba = A18.clone().requires_grad_(), b18.clone().requires_grad_()
    xa = lstsq_autodiff(Xa, ba, 128, POLICY_FP32)
    ((xa - t18) ** 2).sum().backward()
    Xa64, ba64 = A18.double().requires_grad_(), b18.double().requires_grad_()
    Q64, R64 = torch.linalg.qr(Xa64)
    xa64 = torch.linalg.solve_triangular(R64, (Q64.T @ ba64)[:, None],
                                         upper=True)[:, 0]
    ((xa64 - t18.double()) ** 2).sum().backward()
    row18.update({"lstsq_x_rel_vs_fp64": rel_fro(xa.detach().double(),
                                                 xa64.detach()),
                  "lstsq_gA_rel_vs_fp64": rel_fro(Xa.grad.double(),
                                                  Xa64.grad),
                  "lstsq_gb_rel_vs_fp64": rel_fro(ba.grad.double(),
                                                  ba64.grad)})
    assert row18["gA_rel_vs_fp64"] <= 1e-4 and row18["nan_in_nan_gA"], row18
    assert max(row18[k] for k in ("lstsq_x_rel_vs_fp64",
                                  "lstsq_gA_rel_vs_fp64",
                                  "lstsq_gb_rel_vs_fp64")) <= 1e-4, row18

    def fwd_bwd(qr_fn):
        X = A18.clone().requires_grad_()
        loss18(*qr_fn(X), canon=False).backward()

    row18.update({
        "forward_ms": cuda_time_ms(
            lambda: qr_autodiff(A18, 128, POLICY_FP32), warmup=1, iters=5),
        "forward_backward_ms": cuda_time_ms(
            lambda: fwd_bwd(lambda X: qr_autodiff(X, 128, POLICY_FP32)),
            warmup=1, iters=5),
        "library_forward_backward_ms": cuda_time_ms(
            lambda: fwd_bwd(torch.linalg.qr), warmup=1, iters=5)})
    emit({"phase": "autodiff", "call": "qr_autodiff(A[:, :1024], 128, "
          "POLICY_FP32) forward and backward of a seeded weighted loss; "
          "lstsq_autodiff on the same A", "resolved": list(cfg18),
          "forward_launches": c18, **row18,
          "tolerance": "gA, and lstsq_autodiff's x, gA and gb, within 1e-4 "
                       "relative (Frobenius) of float64 torch.linalg.qr "
                       "autograd (sign-canonicalized for qr_autodiff); a NaN "
                       "in A gives NaN in gA; times: CUDA events, median "
                       "of 5 (library: fp32 torch.linalg.qr + autograd)",
          "card": card})
    del Q18, R18, X18, X64, Xn, Xa, Xa64

    # 19. streaming: experiments/r10_incremental.py's cell on the port (its
    # inputs rebuilt with numpy; the script itself imports JAX): the
    # complete factors of default_rng(0).random((n, n)) - 0.5, the sanity
    # checks at n = 1024 with the script's thresholds, the streaming calls
    # beside the refactorizations at n = 1024 and 2048, the SLAM update
    # (rls_init on phase 17's system, 16 rows, rls_solve) against float64
    # and beside lstsq of the stacked system, givens_qr at 512^2.
    G_KEYS = ("givens_fold_rows", "givens_chain", "givens_hessenberg")

    def g_count(fn):
        """fn() and the G1-G3 launches it made."""
        torch.cuda.synchronize()
        before = {k: LAUNCHES[k] for k in G_KEYS}
        out = fn()
        torch.cuda.synchronize()
        return out, {k: LAUNCHES[k] - before[k] for k in G_KEYS}

    def g_expect(got, g1=0, g2=0, g3=0):
        want = dict(zip(G_KEYS, (g1, g2, g3)))
        assert got == want, (got, want)

    def factors19(n):
        a = np.random.default_rng(0).random((n, n), dtype=np.float32) - 0.5
        q, r = np.linalg.qr(a, mode="complete")
        return (a, torch.from_numpy(q.astype(np.float32)).to(dev),
                torch.from_numpy(r.astype(np.float32)).to(dev))

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    def sanity_row(A2, Qp, Rp):
        A2 = torch.from_numpy(A2).to(dev)
        Qd, Rd = Qp.double(), Rp.double()
        back = float(torch.linalg.norm(A2 - Qd @ Rd)
                     / max(float(torch.linalg.norm(A2)), 1e-30))
        orth = float(torch.linalg.norm(
            Qd.T @ Qd - torch.eye(Qd.shape[1], dtype=torch.float64,
                                  device=dev)))
        assert back < 1e-5 and orth < 1e-4, (back, orth)
        return {"backward": back, "orth": orth}

    a19, Q19, R19 = factors19(1024)
    a64 = a19.astype(np.float64)
    rng19 = np.random.default_rng(1)
    u19 = rng19.standard_normal(1024).astype(np.float32)
    v19 = rng19.standard_normal(1024).astype(np.float32)
    sanity = {}
    (Qp, Rp), c = g_count(lambda: qr_rank1_update(Q19, R19, on_dev(u19),
                                                   on_dev(v19)))
    g_expect(c, g2=1, g3=1)
    sanity["rank1_update"] = sanity_row(
        a64 + np.outer(u19.astype(np.float64), v19), Qp, Rp)
    # The script inserts into the square factor first, which qr_insert_col
    # refuses (n >= m: no free row, in the JAX package too); the pair runs
    # the other way round: delete column 7, then insert u there.
    (Qp, Rp), c = g_count(lambda: qr_delete_col(Q19, R19, 7))
    g_expect(c, g3=1)
    a_del = np.delete(a64, 7, axis=1)
    sanity["delete_col"] = sanity_row(a_del, Qp, Rp)
    (Qp2, Rp2), c = g_count(lambda: qr_insert_col(Qp, Rp, 7, on_dev(u19)))
    g_expect(c, g2=1)
    sanity["insert_col"] = sanity_row(np.insert(a_del, 7, u19, axis=1), Qp2,
                                      Rp2)
    (Qp, Rp), c = g_count(lambda: qr_delete_row(Q19, R19, 0))
    g_expect(c, g2=1)
    sanity["delete_row"] = sanity_row(a64[1:], Qp, Rp)
    Rp, c = g_count(lambda: qr_append_row(R19, on_dev(u19)))
    g_expect(c, g1=1)
    a_app = np.vstack([a64, u19[None, :].astype(np.float64)])
    gram = a_app.T @ a_app
    Rp64 = Rp.double().cpu().numpy()
    sanity["append_row"] = {"gram_err": float(
        np.linalg.norm(gram - Rp64.T @ Rp64) / np.linalg.norm(gram))}
    assert sanity["append_row"]["gram_err"] < 1e-5, sanity
    del Qp, Rp, Qp2, Rp2

    K_RLS = 16
    timing19 = {}
    main19 = None
    for n19 in (1024, 2048):
        a19, Q19, R19 = factors19(n19)
        rng19 = np.random.default_rng(2)
        u = on_dev(rng19.standard_normal(n19).astype(np.float32) * 1e-3)
        v = on_dev(rng19.standard_normal(n19).astype(np.float32) * 1e-3)
        rows19 = on_dev(rng19.standard_normal((K_RLS, n19)).astype(
            np.float32) * 1e-3)
        betas19 = on_dev(rng19.standard_normal(K_RLS).astype(np.float32))
        qtb19 = on_dev(rng19.standard_normal(n19).astype(np.float32))
        A19 = torch.from_numpy(a19).to(dev)
        calls = {
            "rank1_update": lambda: qr_rank1_update(Q19, R19, u, v),
            "append_row": lambda: qr_append_row(R19, u, qtb=qtb19,
                                                beta=1.0),
            "rls_update_k16": lambda: rls_update(RLSState(R19, qtb19),
                                                 rows19, betas19),
            "delete_plus_insert_col": lambda: qr_insert_col(
                *qr_delete_col(Q19, R19, 5), 5, u),
            "delete_row": lambda: qr_delete_row(Q19, R19, 0),
        }
        expect = {"rank1_update": (0, 1, 1), "append_row": (1, 0, 0),
                  "rls_update_k16": (1, 0, 0),
                  "delete_plus_insert_col": (0, 1, 1),
                  "delete_row": (0, 1, 0)}
        if n19 == 2048:
            # The phase's main path: each streaming call once, the counts
            # set to 0 just before and read just after.
            torch.cuda.synchronize()
            reset_launches()
            for fn in calls.values():
                fn()
            torch.cuda.synchronize()
            main19 = dict(LAUNCHES)
            g_expect({k: main19[k] for k in G_KEYS}, 2, 3, 2)
        row = {}
        for name, fn in calls.items():
            _, c = g_count(fn)
            g_expect(c, *expect[name])
            row[name + "_ms"] = cuda_time_ms(fn)
        row["rls_update_per_row_ms"] = row["rls_update_k16_ms"] / K_RLS
        for pname, pol in (("fp32", POLICY_FP32),
                           ("mixed_fast", POLICY_MIXED_FAST)):
            row[f"refactor_{pname}_ms"] = cuda_time_ms(
                lambda pol=pol: block_qr(A19, 128, pol, mode="complete",
                                         panel_method="auto",
                                         check="defer"), warmup=2, iters=10)
        timing19[n19] = row
        del Q19, R19, A19

    # The SLAM update: phase 17's full-rank system, 16 new rows.
    J19, b19 = on_dev(Jn17), on_dev(bn17)
    st19, c = g_count(lambda: rls_init(J19, b19))
    g_expect(c)
    rng4 = np.random.default_rng(4)
    rows4 = rng4.standard_normal((K_RLS, 2048)).astype(np.float32)
    betas4 = rng4.standard_normal(K_RLS).astype(np.float32)
    rows4d, betas4d = on_dev(rows4), on_dev(betas4)
    st19b, c = g_count(lambda: rls_update(st19, rows4d, betas4d))
    g_expect(c, g1=1)
    x19 = rls_solve(st19b)
    Js = np.vstack([Jn17, rows4])
    bs = np.concatenate([bn17, betas4])
    slam19 = solve_errors(Js, bs, x19)
    assert slam19["resid_rel"] <= 1e-5 and slam19["x_rel_err"] <= 1e-4, \
        slam19
    Jst, bst = on_dev(Js), on_dev(bs)
    slam19.update({
        "rls_init_ms": cuda_time_ms(lambda: rls_init(J19, b19), warmup=1,
                                    iters=5),
        "rls_update_k16_ms": cuda_time_ms(
            lambda: rls_update(st19, rows4d, betas4d)),
        "rls_solve_ms": cuda_time_ms(lambda: rls_solve(st19b)),
        "lstsq_stacked_ms": cuda_time_ms(lambda: lstsq(Jst, bst), warmup=1,
                                         iters=5)})
    slam19["rls_update_per_row_ms"] = slam19["rls_update_k16_ms"] / K_RLS
    del J19, b19, Jst, bst

    a512 = np.random.default_rng(0).random((512, 512),
                                           dtype=np.float32) - 0.5
    A512 = torch.from_numpy(a512).to(dev)
    (Qg, Rg), c = g_count(lambda: givens_qr(A512))
    g_expect(c)
    repg = metrics.evaluate(A512, Qg, Rg, 23)
    assert repg.all_ok, str(repg)
    gqr = {"backward": repg.backward, "orthogonality": repg.orthogonality,
           "lower_trapezoid": repg.lower_trapezoid, "all_ok": repg.all_ok,
           "ms": cuda_time_ms(lambda: givens_qr(A512), warmup=1, iters=3),
           "library_qr_ms": cuda_time_ms(lambda: torch.linalg.qr(A512))}
    emit({"phase": "streaming", "cell": "experiments/r10_incremental.py "
          "(factors of default_rng(0).random((n, n)) - 0.5; u, v, 16 rows "
          "x 1e-3, betas, qtb from default_rng(2))",
          "main_path_launches": main19, "sanity_n1024": sanity,
          "timing": timing19,
          "slam": {"call": "rls_init(slam_jacobian(4096, 2048, seed=0), b "
                           "default_rng(2)); rls_update of 16 rows from "
                           "default_rng(4); rls_solve", **slam19},
          "givens_qr_512": gqr,
          "tolerance": "sanity: backward < 1e-5, Frobenius orthogonality "
                       "< 1e-4, append_row Gram < 1e-5 (the script's); "
                       "SLAM x 1e-4 and residual 1e-5 relative of float64 "
                       "np.linalg.lstsq; givens_qr metric triple within "
                       "2^-23 m; one G1 per rls_update and append_row, one "
                       "G2 + one G3 per rank-1 update, one G2 per "
                       "insert_col and delete_row, one G3 per delete_col; "
                       "times: CUDA events, median of 20 (refactorizations "
                       "10, rls_init and lstsq 5, givens_qr 3)",
          "card": card})
    for k in G_KEYS:
        assert main19[k] > 0, f"{k} was not launched on the streaming path"

    # 20. dist: the distributed layer on a world of one rank over NCCL
    # (in-process store, no network); the multi-rank logic is proven on
    # the CPU (tests/test_torch_dist*.py).
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        row20, c20 = phase_dist(A, ms4, dev, card)
        emit({"phase": "dist", **row20, "card": card})

        # 21. widths: the calls that reach the kernels at r outside 32, 64,
        # 128 (no collective; the group stays up for phase 22)
        row21, c21 = phase_widths(A, A9, J, b, Jn, bn, (rep, ms4),
                                  (rep9, ms9), dev, card)
        emit({"phase": "widths", **row21, "card": card})

        # 22. dist2d: dist_block_qr_2d on a (1, 1) mesh of the same group
        row22, c22 = phase_dist2d(A, row20, dev)
        emit({"phase": "dist2d", **row22, "card": card})
    finally:
        dist.destroy_process_group()

    # 23. cli: the command-line interface (its dist call starts and ends a
    # one-rank NCCL group of its own)
    row23, c23 = phase_cli(ms4)
    emit({"phase": "cli", **row23, "card": card})

    # 24. k6_widths: K6 above 128 columns, alone and on the calls that
    # reach its wide route
    t24 = time.perf_counter()
    row24, c24, wide24 = phase_k6_widths(A, R64_8, Jn17, bn17, row17, dev)
    emit({"phase": "k6_widths", **row24, "launches": c24,
          "wide_launches": wide24,
          "seconds": time.perf_counter() - t24, "card": card})

    # 25. bgs_batched: the BGS tiers on the whole stack (batched K1 / K2)
    t25 = time.perf_counter()
    row25, c25 = phase_bgs_batched(dev)
    emit({"phase": "bgs_batched", **row25, "launches": c25,
          "seconds": time.perf_counter() - t25, "card": card})

    # 26. polar_batched: the polar tier on the whole stack (batched K1 / K4)
    t26 = time.perf_counter()
    row26, c26 = phase_polar_batched(dev)
    emit({"phase": "polar_batched", **row26, "launches": c26,
          "seconds": time.perf_counter() - t26, "card": card})

    for k, tot in BATCHED.items():
        assert 0 < tot["launches"] < tot["members"], (k, BATCHED)
    emit({"kernels": [
        {"name": "ns_chain", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/ns_chain.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:335",
         "launches": main_launches["ns_chain"] + c20["ns_chain"]
         + c21.get("ns_chain", 0) + c22["ns_chain"]
         + c23.get("ns_chain", 0)
         + c24.get("ns_chain", 0) + c25.get("ns_chain", 0)
         + c26.get("ns_chain", 0),
         "max_abs_err": max(ns_err, *(row["max_abs_err"] for row in
                                      wrows["ns_chain"].values())),
         "widths": [32, 64, 128, *wrows["ns_chain"]],
         "ms": ns_rows["chain_mid"]["ms"],
         "plain_ms": ns_rows["chain_mid"]["plain_ms"],
         **ns_chain_bound(128, 6, chain_mid=True),
         "serial_floor_ms": k1_floor["chain_mid"],
         "library_ms": lib_k1, "library_inverse_ms": lib_k1_inv},
        {"name": "bgs_group_fused", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/bgs_group.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:900",
         "launches": main_launches["bgs_group_fused"]
         + c21.get("bgs_group_fused", 0) + c23.get("bgs_group_fused", 0)
         + c24.get("bgs_group_fused", 0) + c25.get("bgs_group_fused", 0),
         "max_abs_err": max(grp_err, *(row["max_abs_err"] for row in
                                       wrows["bgs_group_fused"].values())),
         "widths": [128, *wrows["bgs_group_fused"]],
         "ms": grp_rows["bgs1_robust=True"]["ms"],
         "plain_ms": grp_rows["bgs1_robust=True"]["plain_ms"],
         **group_bound(2048, 128, iters, (False,) * 7 + (True,), True),
         "library_ms": lib_k2},
        {"name": "panel_qr_fused", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/panel_qr.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:501",
         "launches": c7["panel_qr_fused"] + c21.get("panel_qr_fused", 0)
         + c23.get("panel_qr_fused", 0)
         + c24.get("panel_qr_fused", 0),
         "max_abs_err": max(k3_err, *(row["max_abs_err"] for row in
                                      wrows["panel_qr_fused"].values())),
         "widths": [128, *wrows["panel_qr_fused"]],
         "combine_widths": [128, *wrows["tri_combine"]],
         "ms": k3_rows["uniform_robust"]["ms"],
         "plain_ms": k3_rows["uniform_robust"]["plain_ms"],
         **panel_qr_bound(4096, 128),
         "library_ms": lib_k3, "combine_ms": cmb["device_ms"],
         "combine_l2_route": {
             "kernel": "panel.cuh::combine_l2_kernel",
             "design": "32 x 16 blocks, a cluster the row blocks of a "
                       "column block; both products on 64-deep TMA stages "
                       "into a 3-slot mbarrier ring (T2 / T3 read row-major), "
                       "2 x 4 fp32 register tiles; blocks below the diagonal "
                       "written as zeros",
             **{str(r_c): {k: wrows["tri_combine"][r_c][k]
                           for k in ("ctas", "ms", "bound_ms",
                                     "cluster_bound_ms", "library_ms")}
                for r_c in (192, 256, 512, 1024)}}},
        {"name": "ninv_chain", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/ninv_chain.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:384",
         "launches": c9["ninv_chain"] + c20["ninv_chain"]
         + c21.get("ninv_chain", 0) + c22["ninv_chain"]
         + c23.get("ninv_chain", 0)
         + c24.get("ninv_chain", 0) + c26.get("ninv_chain", 0),
         "max_abs_err": max(k4_err, *(row["max_abs_err"] for row in
                                      wrows["ninv_chain"].values())),
         "widths": [128, *wrows["ninv_chain"]],
         "ms": k4_rows["panel4096_it5"]["ms"],
         "plain_ms": k4_rows["panel4096_it5"]["plain_ms"],
         **ninv_chain_bound(128, 5),
         "library_ms": k4_rows["panel4096_it5"]["library_ms"],
         "l2_route": {
             "kernel": "ninv_chain.cu::ninv_l2_kernel",
             "design": "S^T, X, X^T (twice) and E in a padded scratch; every "
                       "product on l2_tprod: 64-deep TMA stages into a "
                       "3-slot mbarrier ring, 4 x 4 fp32 register tiles",
             **{str(r_w): {k: wrows["ninv_chain"][r_w]["inputs"][
                 "panel4096_it5"][k] for k in ("ms", "bound_ms",
                                               "cluster_bound_ms",
                                               "library_ms")}
                for r_w in (192, 256, 512, 1024)},
             "clock_r256_it5_us": {k: v["us"] for k, v in
                                   k4_clock["slots"].items()}}},
        {"name": "bgs_group_fused_proj", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/bgs_group.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:1023",
         "launches": c13["bgs_group_fused_proj"]
         + c23.get("bgs_group_fused_proj", 0)
         + c24.get("bgs_group_fused_proj", 0),
         "max_abs_err": max(k5_err, *(
             row["max_abs_err"]
             for row in wrows["bgs_group_fused_proj"].values())),
         "widths": [128, *wrows["bgs_group_fused_proj"]],
         "ms": k5_rows["bf16"]["ms"],
         "plain_ms": k5_rows["bf16"]["plain_ms"],
         **group_bound(2048, 128, iters, robust_tail, True, proj_cols=1024),
         "library_ms": k5_rows["bf16"]["library_ms"]},
        {"name": "panel_factor_fused", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/panel_factor.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/panel.py:115",
         "launches": c7["panel_factor_fused"] + c20["panel_factor_fused"]
         + c21.get("panel_factor_fused", 0) + c22["panel_factor_fused"]
         + c23.get("panel_factor_fused", 0)
         + c24.get("panel_factor_fused", 0),
         "max_abs_err": max(k6_err, *(row[f"max_abs_{x}"] for row in
                                      row24["k"].values() for x in "VTR")),
         "widths": [128, 80, 64, 200, 256, 512, 2048],
         "ms": k6_rows["4096x128"]["ms"],
         "plain_ms": k6_rows["4096x128"]["plain_ms"],
         **panel_factor_bound(4096, 128, k6_rows["4096x128"]["cluster"]),
         "library_ms": k6_rows["4096x128"]["library_ms"],
         "phases": {name: row["share"] for name, row in k6_phases.items()},
         "wide_route": {"launches": wide24, **{
             name: {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}
             for name, row in row24["k"].items()}}},
        {"name": "panel_factor_fused_batched", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/panel_factor.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/panel.py:115 "
                     "under jax.vmap (parallel/tsqr.py:91, :141, "
                     ":190-193; parallel/caqr.py:178, :199; "
                     "ops/blockqr.py:1988; models/lstsq.py:130; "
                     "parallel/batched.py:56)",
         "launches": BATCHED["panel_factor_fused"]["launches"],
         "members": BATCHED["panel_factor_fused"]["members"],
         "max_abs_err": k6b_err,
         "shape": "64 x 1563 x 64",
         "ms": k6b_rows["64x1563x64"]["ms"],
         "plain_ms": k6b_rows["64x1563x64"]["plain_ms"],
         "single_loop_ms": k6b_rows["64x1563x64"]["single_loop_ms"],
         **{k: k6b_rows["64x1563x64"][k] for k in (
             "bound_ms", "bound_by", "member_floor_ms")},
         "library_ms": k6b_rows["64x1563x64"]["library_ms"],
         "stacks": {name: {k: row[k] for k in (
             "ms", "single_loop_ms", "plain_ms", "bound_ms", "bound_by",
             "member_floor_ms", "library_ms", "cluster", "waves")}
             for name, row in k6b_rows.items()}},
        {"name": "ns_chain_batched", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/ns_chain.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:335 under "
                     "jax.vmap (ops/blockqr.py:1988 -> _block_qr_bgs: "
                     ":1347, :1320, :895, :934)",
         "launches": BATCHED["ns_chain"]["launches"],
         "members": BATCHED["ns_chain"]["members"],
         "max_abs_err": k1b_err, "shape": "8 x 128 x 128, chain_mid 6 it",
         **{k: k1b_rows["chain_mid_8x128"][k] for k in (
             "ms", "plain_ms", "single_loop_ms", "bound_ms", "bound_by",
             "member_floor_ms", "library_ms", "waves")},
         "stacks": {name: {k: row[k] for k in (
             "ms", "single_loop_ms", "plain_ms", "bound_ms", "bound_by",
             "member_floor_ms", "library_ms", "route", "ctas", "waves")}
             for name, row in k1b_rows.items()}},
        {"name": "ninv_chain_batched", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/ninv_chain.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:384 under "
                     "jax.vmap (ops/blockqr.py:1988 -> _block_qr_grouped: "
                     ":741; parallel/batched.py:56)",
         "launches": BATCHED["ninv_chain"]["launches"],
         "members": BATCHED["ninv_chain"]["members"],
         "max_abs_err": k4b_err, "shape": "8 x 128 x 128, 5 it",
         **{k: k4b_rows["panel4096_it5_8x128"][k] for k in (
             "ms", "plain_ms", "single_loop_ms", "bound_ms", "bound_by",
             "member_floor_ms", "library_ms", "waves")},
         "stacks": {name: {k: row[k] for k in (
             "ms", "single_loop_ms", "plain_ms", "bound_ms", "bound_by",
             "member_floor_ms", "library_ms", "route", "ctas", "waves")}
             for name, row in k4b_rows.items()}},
        {"name": "bgs_group_fused_batched", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/bgs_group.cu",
         "products_source": "mixedprecisionblockqr_tpu_torch/csrc/"
                            "stack_gemm.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/ns.py:900 under "
                     "jax.vmap (ops/blockqr.py:1988 -> _block_qr_bgs: "
                     ":1258; parallel/batched.py:56)",
         "launches": BATCHED["bgs_group_fused"]["launches"],
         "members": BATCHED["bgs_group_fused"]["members"],
         "max_abs_err": k2b_err,
         "shape": "8 x 2048 x 512, g4, r 128, bf16, robust last panel",
         **{k: k2b_rows["bgs1_8x2048x512"][k] for k in (
             "ms", "plain_ms", "single_loop_ms", "bound_ms", "bound_by",
             "member_floor_ms", "products_floor_ms", "library_ms")},
         "stacks": {name: {**{k: row[k] for k in (
             "ms", "single_loop_ms", "plain_ms", "bound_ms", "bound_by",
             "member_floor_ms", "products_floor_ms", "library_ms")},
             "product_route": row["layout"]["product_route"],
             "products_ms": (row.get("kinds") or {}).get("products_ms")}
             for name, row in k2b_rows.items()}},
        {"name": "sketch_qrcp_ranks", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/sketch_qrcp.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/sketch.py:88",
         "launches": c7["sketch_qrcp_ranks"]
         + c21.get("sketch_qrcp_ranks", 0)
         + c23.get("sketch_qrcp_ranks", 0)
         + c24.get("sketch_qrcp_ranks", 0),
         "max_abs_err": k7_err, "widths": [128, 64],
         "ms": k7_rows["w2048"]["ms"],
         "plain_ms": k7_rows["w2048"]["plain_ms"],
         **sketch_bound(136, 2048, 128),
         "library_ms": None},
        {"name": "tiled_matmul", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/tiled_matmul.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/gemm.py:103",
         "launches": c15["tiled_matmul"] + c23.get("tiled_matmul", 0)
         + c24.get("tiled_matmul", 0),
         "max_abs_err": k8_err,
         "ms": k8_rows["2048x2048x2048_bf16_f32"]["ms"],
         "plain_ms": k8_rows["2048x2048x2048_bf16_f32"]["plain_ms"],
         **matmul_bound(2048, 2048, 2048, "bf16"),
         "library_ms": k8_rows["2048x2048x2048_bf16_f32"]["library_ms"]},
        {"name": "chol_rinv", "route": "cuda",
         "source": "mixedprecisionblockqr_tpu_torch/csrc/chol_rinv.cu",
         "replaces": "mixedprecisionblockqr_tpu/ops/pallas/chol.py:119",
         "launches": c15["chol_rinv"] + c23.get("chol_rinv", 0)
         + c24.get("chol_rinv", 0),
         "max_abs_err": k9_err,
         "widths": [32, 96, 128, 256, 320, 512, 1024],
         "ms": k9_rows["r256"]["ms"],
         "plain_ms": k9_rows["r256"]["plain_ms"],
         **chol_rinv_bound(256),
         "library_ms": k9_rows["r256"]["library_ms"]},
        *({"name": row["kernel"], "route": "cuda",
           "source": "mixedprecisionblockqr_tpu_torch/csrc/givens.cu",
           "replaces": replaces, "launches": main19[row["kernel"]],
           "max_abs_err": row["max_abs_err"], "ms": row["ms"],
           "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
           "bound_by": row["bound_by"],
           "library_ms": row["library_ms"], "shape": shape,
           "main_shape_ms": g_main[main_key]["ms"]}
          for row, replaces, shape, main_key in (
              (g_rows["fold_n256_k16"],
               "mixedprecisionblockqr_tpu/ops/givens.py:289 _fold_rows_run "
               "(lax.scan, no pallas_call)", "256 x 257, 16 rows",
               "fold_n2048_k16"),
              (g_rows["chain_m512"],
               "mixedprecisionblockqr_tpu/ops/givens.py:256 sweep_up "
               "(lax.fori_loop, no pallas_call; also :473, :536)",
               "R 512 x 512, Q^T 512 x 512", "chain_m2048"),
              (g_rows["hessenberg_m512"],
               "mixedprecisionblockqr_tpu/ops/givens.py:273 sweep_down "
               "(lax.fori_loop, no pallas_call; also :412)",
               "H 512 x 512, Q^T 512 x 512", "hessenberg_m2048"))),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
