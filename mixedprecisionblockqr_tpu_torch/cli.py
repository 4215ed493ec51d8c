"""Command-line interface (port of ``mixedprecisionblockqr_tpu/cli.py``).

Dtype policy, block size, panel method, dataset paths and benchmark
sweeps are flags; the nine subcommands, their flags, defaults, exit codes
and printed JSON keys are the JAX package's.

    python -m mixedprecisionblockqr_tpu_torch qr --m 1024 --n 1024 --policy mixed
    python -m mixedprecisionblockqr_tpu_torch suite
    python -m mixedprecisionblockqr_tpu_torch bench --sizes 256,512,1024
    python -m mixedprecisionblockqr_tpu_torch solve --m 2000 --n 1000
    python -m mixedprecisionblockqr_tpu_torch dataset --out data/jacobians
    python -m mixedprecisionblockqr_tpu_torch dist --n 2048
    python -m mixedprecisionblockqr_tpu_torch plot log/*.txt
    python -m mixedprecisionblockqr_tpu_torch --platform cpu qr --n 256

The commands that compute run on the card (``cuda``) unless
``--platform cpu`` is given; without a CUDA device they exit with code 2
and a message that names ``--platform cpu``.  ``dataset`` and ``plot`` run
no device code.  CSV log names start with the device's tag (``gpu_`` or
``cpu_``) where the JAX package writes ``tpu_``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

#: Subcommands that run device code, and so need a device.
_DEVICE_COMMANDS = ("qr", "bench", "suite", "solve", "dist", "tsqr-bench",
                    "precision-study")


def _load_matrix(args) -> np.ndarray:
    if getattr(args, "file", None):
        from mixedprecisionblockqr_tpu_torch.utils.euroc import (
            read_euroc_jacobian,
        )

        _, _, a = read_euroc_jacobian(args.file)
        return a
    if getattr(args, "cond", None):
        from mixedprecisionblockqr_tpu_torch.utils.datagen import (
            conditioned_matrix,
        )

        if getattr(args, "m", None) not in (None, args.n):
            # The generator is square-only: refuse a rectangular request.
            raise SystemExit(
                f"error: --cond generates a square n x n matrix; got "
                f"--m {args.m} --n {args.n} (drop --m or use --file)"
            )
        return conditioned_matrix(args.n, args.cond, seed=args.seed).astype(
            np.float32
        )
    rng = np.random.default_rng(args.seed)
    m = args.m if args.m is not None else args.n
    return (rng.random((m, args.n), dtype=np.float32) - 0.5)


def _common_flags(p: argparse.ArgumentParser, with_matrix: bool = True):
    if with_matrix:
        p.add_argument("--m", type=int, default=None,
                       help="rows (default: n, i.e. square)")
        p.add_argument("--n", type=int, default=1024)
        p.add_argument("--file", help="Euroc Jacobian text file")
        p.add_argument("--cond", type=float, help="target condition number")
        p.add_argument("--seed", type=int, default=0)
    p.add_argument("--policy", default="mixed",
                   choices=["fp32", "mixed", "mixed_fast", "bf16", "fp64"])
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument(
        "--panel-method",
        default="auto",
        choices=["auto", "householder", "householder_pallas", "cholqr1",
                 "cholqr2", "cholqr2s", "cholqr1x2", "polar", "bgs", "bgs1",
                 "bgs2"],
        help="auto = the per-size tier of ops/blockqr.py::"
             "resolve_panel_config on the GPU, householder on the CPU",
    )
    p.add_argument("--loop-mode", default="unroll",
                   choices=["unroll", "scan"],
                   help="scan = one panel step iterated (bounded program "
                        "size at large n/r)")
    p.add_argument(
        "--group-panels", type=int, default=4,
        help="reflector/panel aggregation factor for bgs/bgs1/polar "
             "(8 = the headline configuration at 2048^2)",
    )
    p.add_argument(
        "--quality", default=None,
        choices=["fast", "balanced", "high", "robust"],
        help="speed/orthogonality ladder for --panel-method auto "
             "(fast = bgs1, balanced = bgs2, high = bgs, robust = "
             "householder)",
    )
    p.add_argument("--log-dir", default="log")


def _tag(args) -> str:
    """The device tag that starts CSV log names: 'gpu' or 'cpu'."""
    return "cpu" if args.device == "cpu" else "gpu"


def _sync(args) -> None:
    if args.device != "cpu":
        torch.cuda.synchronize()


def cmd_qr(args) -> int:
    from mixedprecisionblockqr_tpu_torch.ops import metrics
    from mixedprecisionblockqr_tpu_torch.ops.blockqr import block_qr
    from mixedprecisionblockqr_tpu_torch.ops.policy import policy_by_name
    from mixedprecisionblockqr_tpu_torch.utils.flops import qr_flops
    from mixedprecisionblockqr_tpu_torch.utils.logging import ResultsLogger

    a = _load_matrix(args)
    A = torch.from_numpy(a).to(args.device)
    policy = policy_by_name(args.policy)
    if args.pivoted != "off":
        from mixedprecisionblockqr_tpu_torch.ops.pivoted import (
            numerical_rank,
            pivoted_qr,
        )

        # The pivoted tiers are fp32-only and pick their own method: refuse
        # knobs that cannot apply ('mixed', the default policy, runs fp32).
        if args.policy not in ("fp32", "mixed") or args.quality is not None:
            raise SystemExit(
                "qr --pivoted runs the fp32 rank-revealing tiers; "
                f"--policy {args.policy} / --quality do not apply — drop "
                "them (--panel-method/--loop-mode/--group-panels are "
                "likewise unused here)"
            )
        _sync(args)
        t0 = time.perf_counter()
        Q, R, perm = pivoted_qr(A, mode="reduced", method=args.pivoted,
                                block_size=args.block_size)
        _sync(args)
        dt = time.perf_counter() - t0
        rep = metrics.evaluate(A[:, perm.to(A.device)], Q, R,
                               precision_bits=23)
        rank = numerical_rank(R, m=a.shape[0])
        print(rep)
        print(json.dumps({"rank": int(rank), "method": args.pivoted,
                          "seconds_with_compile": dt}))
        ResultsLogger(args.log_dir).write_csv(
            f"{_tag(args)}_pivoted_{args.pivoted}", a.shape[0], a.shape[1],
            dt, qr_flops(*a.shape), rep.backward
        )
        return 0 if rep.all_ok else 1
    _sync(args)
    t0 = time.perf_counter()
    Q, R = block_qr(
        A, block_size=args.block_size, policy=policy, mode="complete",
        panel_method=args.panel_method, loop_mode=args.loop_mode,
        group_panels=args.group_panels, quality=args.quality,
        check="sync",  # the CLI materializes results: take the retry
    )
    _sync(args)
    dt = time.perf_counter() - t0  # first call: includes the kernel build
    rep = metrics.evaluate(A, Q, R, precision_bits=policy.precision_bits)
    print(rep)
    ResultsLogger(args.log_dir).write_csv(
        f"{_tag(args)}_block_{args.policy}", a.shape[0], a.shape[1], dt,
        qr_flops(*a.shape), rep.backward
    )
    return 0 if rep.all_ok else 1


def cmd_bench(args) -> int:
    from mixedprecisionblockqr_tpu_torch.ops import metrics
    from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
        block_qr,
        resolve_panel_config,
    )
    from mixedprecisionblockqr_tpu_torch.ops.policy import policy_by_name
    from mixedprecisionblockqr_tpu_torch.utils.flops import qr_flops
    from mixedprecisionblockqr_tpu_torch.utils.logging import ResultsLogger
    from mixedprecisionblockqr_tpu_torch.utils.timing import (
        time_step_amortized,
        trace,
    )

    policy = policy_by_name(args.policy)
    sizes = [int(s) for s in args.sizes.split(",")]
    logger = ResultsLogger(args.log_dir)
    for s in sizes:
        rng = np.random.default_rng(0)
        a = rng.random((s, s), dtype=np.float32) - 0.5
        A = torch.from_numpy(a).to(args.device)
        r_eff = min(args.block_size, s)
        Q, R = block_qr(
            A, block_size=r_eff, policy=policy, mode="complete",
            panel_method=args.panel_method, loop_mode=args.loop_mode,
            group_panels=args.group_panels, quality=args.quality,
            check="sync",
        )
        rep = metrics.evaluate(A, Q, R, precision_bits=policy.precision_bits)
        del Q, R

        # The timed call is the public block_qr on the tier the same
        # dispatch resolves (check='defer': no host read in the chain).
        pm, lm, gp = resolve_panel_config(
            s, s, args.block_size, policy, args.panel_method,
            args.loop_mode, args.group_panels, mode="complete",
            on_gpu=A.is_cuda, quality=args.quality,
        )

        def step(x, pm=pm, lm=lm, gp=gp):
            _, R_ = block_qr(x, block_size=r_eff, policy=policy,
                             mode="complete", panel_method=pm, loop_mode=lm,
                             group_panels=gp, check="defer")
            return x * (1.0 + 1e-12 * R_[0, 0])

        if args.profile_dir:
            with trace(f"blockqr_{s}", log_dir=args.profile_dir):
                sec = time_step_amortized(step, A, iters=args.iters)
        else:
            sec = time_step_amortized(step, A, iters=args.iters)
        tflops = qr_flops(s, s) / sec / 1e12
        logger.write_csv(
            f"{_tag(args)}_block_{args.policy}", s, s, sec,
            qr_flops(s, s), rep.backward,
        )
        print(
            json.dumps(
                {
                    "m": s, "n": s, "seconds": round(sec, 6),
                    "tflops": round(tflops, 3),
                    "backward_error": rep.backward,
                    "criteria_ok": rep.all_ok,
                }
            )
        )
    return 0


def cmd_suite(args) -> int:
    """The original CUDA code's full test / benchmark entry
    (``Cuda/main.cu:11-26``): the static random size table and the
    Jacobian dataset, each through the fp32 and mixed blocked drivers,
    CSV-logged."""
    from mixedprecisionblockqr_tpu_torch.models.slam import enumerate_jacobians
    from mixedprecisionblockqr_tpu_torch.ops import metrics
    from mixedprecisionblockqr_tpu_torch.ops.blockqr import block_qr
    from mixedprecisionblockqr_tpu_torch.ops.policy import (
        POLICY_FP32,
        POLICY_MIXED,
    )
    from mixedprecisionblockqr_tpu_torch.utils.datagen import STATIC_QR_SIZES
    from mixedprecisionblockqr_tpu_torch.utils.flops import qr_flops
    from mixedprecisionblockqr_tpu_torch.utils.logging import (
        ResultsLogger,
        read_csv_log,
    )

    tag = _tag(args)
    logger = ResultsLogger(args.log_dir)
    failures = 0
    done: dict = {}
    if args.resume:
        # Skip cases already in the CSV logs, counted per (name, m, n): the
        # table repeats shapes with different block sizes and the CSV does
        # not record r, so skipping the first K occurrences resumes exactly
        # where the log left off (cases run in table order).
        import glob as _glob

        for path in _glob.glob(os.path.join(args.log_dir, "*.txt")):
            name = os.path.splitext(os.path.basename(path))[0]
            try:
                for rec in read_csv_log(path):
                    key = (name, rec["rows"], rec["cols"])
                    done[key] = done.get(key, 0) + 1
            except Exception:
                pass

    def run_case(name, a, r, policy, bits):
        nonlocal failures
        key = (name, a.shape[0], a.shape[1])
        if done.get(key, 0) > 0:
            done[key] -= 1
            return
        A = torch.from_numpy(a).to(args.device)
        _sync(args)
        t0 = time.perf_counter()
        Q, R = block_qr(A, block_size=r, policy=policy, mode="complete",
                        panel_method="auto", check="sync")
        _sync(args)
        dt = time.perf_counter() - t0
        rep = metrics.evaluate(A, Q, R, precision_bits=bits)
        logger.write_csv(name, a.shape[0], a.shape[1], dt,
                         qr_flops(*a.shape), rep.backward)
        # Acceptance = the 2^-bits * m criterion; the sqrt(m) tightness
        # gate (ops/metrics.py::tight_limit) is the regression tripwire.
        ok = rep.all_ok and (rep.tight_ok or not args.strict)
        status = "ok" if ok else (
            "FAIL" if not rep.all_ok else "FAIL-tight"
        )
        print(f"{name} {a.shape[0]}x{a.shape[1]} r={r}: "
              f"err={rep.backward:.3e} [{status}]")
        failures += 0 if ok else 1

    rng = np.random.default_rng(0)
    table = STATIC_QR_SIZES if not args.quick else STATIC_QR_SIZES[:8]
    for m, n, r in table:
        a = rng.random((m, n), dtype=np.float32)
        run_case(f"{tag}_block_fp32", a, r, POLICY_FP32, 23)
        run_case(f"{tag}_block_mixed", a, r, POLICY_MIXED, 8)

    for case in enumerate_jacobians(args.data_dir)[: args.max_jacobians]:
        a = case.load()
        if a.shape[0] < a.shape[1]:
            continue
        run_case(f"{tag}_jacobian_fp32", a, 128, POLICY_FP32, 23)
        run_case(f"{tag}_jacobian_mixed", a, 128, POLICY_MIXED, 8)

    print(f"suite complete, {failures} failures")
    return 1 if failures else 0


def cmd_solve(args) -> int:
    from mixedprecisionblockqr_tpu_torch.models.lstsq import lstsq
    from mixedprecisionblockqr_tpu_torch.ops.policy import policy_by_name

    a = _load_matrix(args)
    rng = np.random.default_rng(args.seed + 1)
    xtrue = rng.random(a.shape[1]).astype(np.float32)
    b = a @ xtrue
    # --quality implies auto dispatch (the subcommand's default is the
    # robust 'householder', and lstsq refuses quality with another method).
    pm = ("auto" if args.quality and args.panel_method == "householder"
          else args.panel_method)
    x = lstsq(torch.from_numpy(a).to(args.device),
              torch.from_numpy(b).to(args.device),
              block_size=args.block_size,
              policy=policy_by_name(args.policy),
              panel_method=pm, quality=args.quality)
    x = x.double().cpu().numpy()
    resid = float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
    err = float(np.max(np.abs(x - xtrue)))
    print(json.dumps({"m": a.shape[0], "n": a.shape[1],
                      "rel_residual": resid, "max_x_error": err}))
    return 0 if resid < 1e-2 else 1


def cmd_dataset(args) -> int:
    from mixedprecisionblockqr_tpu_torch.utils.euroc import synthesize_dataset

    sizes = [tuple(map(int, s.split("x"))) for s in args.sizes.split(",")]
    paths = synthesize_dataset(args.out, sizes=sizes)
    print(f"wrote {len(paths)} files to {args.out}")
    return 0


def _dist_group(args):
    """Join or start the process group ``dist`` runs in: the started one;
    under ``torchrun`` (RANK and WORLD_SIZE set) the one its environment
    describes; else a group of one rank on an in-process store (NCCL on
    the card, gloo with ``--platform cpu``).  Returns whether this call
    started it (and must destroy it)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "gloo" if args.device == "cpu" else "nccl"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if args.device != "cpu":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def cmd_dist(args) -> int:
    """Distributed QR over every rank of the process group (a 1-D
    ``rows`` mesh)."""
    import torch.distributed as dist

    own = _dist_group(args)
    try:
        return _run_dist(args)
    finally:
        if own:
            dist.destroy_process_group()


def _run_dist(args) -> int:
    import torch.distributed as dist

    from mixedprecisionblockqr_tpu_torch.ops import metrics
    from mixedprecisionblockqr_tpu_torch.ops.blockqr import _QUALITY_BGS
    from mixedprecisionblockqr_tpu_torch.ops.policy import policy_by_name
    from mixedprecisionblockqr_tpu_torch.parallel.dist_qr import dist_block_qr
    from mixedprecisionblockqr_tpu_torch.parallel.mesh import (
        gather_cols,
        gather_rows,
        make_mesh,
    )

    a = _load_matrix(args)
    mesh = make_mesh(device_type="cpu" if args.device == "cpu" else "cuda")
    n_dev = dist.get_world_size()
    lead = dist.get_rank() == 0
    policy = policy_by_name(args.policy)
    if args.quality:
        if args.panel_method != "auto":
            if lead:
                print(
                    "error: --quality is the auto-dispatch ladder knob; it "
                    "cannot combine with --panel-method "
                    f"{args.panel_method!r}",
                    file=sys.stderr,
                )
            return 2
        args.panel_method = _QUALITY_BGS.get(args.quality, "householder")
        if (
            args.panel_method.startswith("bgs")
            and a.shape[1] % min(args.block_size, a.shape[1]) == 0
            and a.shape[1] // min(args.block_size, a.shape[1]) > 32
            and args.loop_mode == "unroll"
        ):
            args.loop_mode = "scan"
    if args.panel_method == "auto":
        m_, n_ = a.shape
        r_ = min(args.block_size, n_)
        per_dev_rows = m_ // max(1, n_dev)
        if n_ % r_ == 0 and n_ >= 2 * args.block_size and m_ == n_:
            # BGS: full-height panels, one all-reduce per Gram and
            # projection, Q by concatenation (complete Q needs m == n).
            args.panel_method = "bgs"
            if n_ // r_ > 32 and args.loop_mode == "unroll":
                # Many panels: the grouped inter-group-BCGS2 scan tier.
                args.loop_mode = "scan"
                args.panel_method = "bgs2"
        elif per_dev_rows >= 2 * args.block_size:
            args.panel_method = "cholqr2s"
        else:
            # Squarish per-rank leaves are CholeskyQR-hostile.
            args.panel_method = "householder"
    if args.panel_method not in (
        "householder", "cholqr2", "cholqr2s", "bgs", "bgs1", "bgs2"
    ):
        if lead:
            print(
                "error: dist supports --panel-method "
                "householder|cholqr2|cholqr2s|bgs|bgs1|bgs2, "
                f"got {args.panel_method!r}",
                file=sys.stderr,
            )
        return 2
    is_bgs = args.panel_method in ("bgs", "bgs1", "bgs2")
    # BGS materializes the reduced Q (m x n): evaluate reduced for m != n.
    mode = "reduced" if is_bgs and a.shape[0] != a.shape[1] else "complete"
    Q_loc, R = dist_block_qr(
        torch.from_numpy(a), mesh, block_size=args.block_size, policy=policy,
        mode=mode, panel_method=args.panel_method,
        loop_mode=args.loop_mode, group_panels=args.group_panels,
    )
    # Q comes back as this rank's slab: rows (BGS) or columns (reflector).
    Q = gather_rows(Q_loc, mesh) if is_bgs else gather_cols(Q_loc, mesh)
    rep = metrics.evaluate(torch.from_numpy(a).to(Q.device), Q, R,
                           precision_bits=policy.precision_bits)
    if lead:
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(
            f"devices={n_dev} mesh={shape} "
            f"panel_method={args.panel_method} loop_mode={args.loop_mode} "
            f"group_panels={args.group_panels}"
        )
        print(rep)
    return 0 if rep.all_ok else 1


def cmd_tsqr_bench(args) -> int:
    from mixedprecisionblockqr_tpu_torch.ops import metrics
    from mixedprecisionblockqr_tpu_torch.parallel.tsqr import tsqr
    from mixedprecisionblockqr_tpu_torch.utils.flops import tsqr_flops
    from mixedprecisionblockqr_tpu_torch.utils.timing import (
        time_step_amortized,
    )

    m, n = args.m, args.n
    A = torch.from_numpy(
        np.random.default_rng(0).random((m, n), dtype=np.float32)
    ).to(args.device)
    Q, R = tsqr(A, n_leaves=args.leaves, method=args.method)
    rep_b = float(metrics.backward_error(A, Q, R))
    rep_o = float(metrics.orthogonality_error(Q))
    del Q, R

    def step(x):
        # The timed program is the validated one: tsqr's own dispatch.
        _, R_ = tsqr(x, n_leaves=args.leaves, method=args.method)
        return x * (1.0 + 1e-12 * R_[0, 0])

    sec = time_step_amortized(step, A, iters=args.iters)
    print(json.dumps({
        "m": m, "n": n, "leaves": args.leaves, "method": args.method,
        "seconds": round(sec, 6),
        "tflops_2mn2": round(tsqr_flops(m, n) / sec / 1e12, 3),
        "backward_error": rep_b, "orthogonality_error": rep_o,
    }))
    return 0


def cmd_precision_study(args) -> int:
    from mixedprecisionblockqr_tpu_torch.models.precision_study import (
        write_study,
    )

    sizes = tuple(int(x) for x in args.sizes.split(","))
    conds = tuple(float(x) for x in args.conds.split(","))
    paths = write_study(args.out, sizes=sizes, condition_numbers=conds,
                        block_size=args.block_size, device=args.device)
    print("\n".join(paths))
    return 0


def cmd_plot(args) -> int:
    from mixedprecisionblockqr_tpu_torch.utils.plotting import plot_logs

    written = plot_logs(args.logs, out_dir=args.out)
    print("\n".join(written))
    return 0


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="mixedprecisionblockqr_tpu_torch",
        description="Mixed-precision block QR on the GPU (PyTorch + CUDA)",
    )
    parser.add_argument(
        "--platform",
        choices=["cpu", "gpu"],
        help="where the computing commands run (default: the GPU; without "
             "a CUDA device they exit unless --platform cpu is given)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("qr", help="factor one matrix, report error metrics")
    _common_flags(p)
    p.add_argument(
        "--pivoted", default="off", choices=["off", "auto", "exact",
                                             "rqrcp"],
        help="column-pivoted (rank-revealing) factorization instead of "
             "the blocked fast tiers; reports the numerical rank "
             "(ops/pivoted.py; 'rqrcp' = the sketch-pivoting tier)",
    )
    p.set_defaults(fn=cmd_qr)

    p = sub.add_parser("bench", help="amortized TFLOP/s sweep")
    _common_flags(p, with_matrix=False)
    p.add_argument("--sizes", default="256,512,1024,2048")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace here")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("suite", help="full test/bench suite (main.cu parity)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--max-jacobians", type=int, default=8)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip shapes already present in the CSV logs")
    p.add_argument("--log-dir", default="log")
    p.add_argument("--no-strict", dest="strict", action="store_false",
                   help="disable the 2^-bits*sqrt(m) tightness gate "
                        "(acceptance criterion only)")
    p.set_defaults(fn=cmd_suite, strict=True)

    p = sub.add_parser("solve", help="QR least-squares solve")
    _common_flags(p)
    # Solves keep the robust reflector default (lstsq's own); explicit
    # --panel-method / --quality are forwarded to lstsq.
    p.set_defaults(fn=cmd_solve, policy="fp32", panel_method="householder")

    p = sub.add_parser("dataset", help="synthesize Euroc-format Jacobians")
    p.add_argument("--out", default="data/jacobians")
    p.add_argument("--sizes", default="256x128,512x256,1024x512,2000x1000")
    p.set_defaults(fn=cmd_dataset)

    p = sub.add_parser("dist", help="distributed QR over all ranks")
    _common_flags(p)
    p.set_defaults(fn=cmd_dist)

    p = sub.add_parser("tsqr-bench", help="tall-skinny QR benchmark")
    p.add_argument("--m", type=int, default=100000)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--leaves", type=int, default=8)
    p.add_argument("--method", default="cholqr2",
                   choices=["householder", "cholqr2", "cholqr2s"])
    p.add_argument("--iters", type=int, default=16)
    p.set_defaults(fn=cmd_tsqr_bench)

    p = sub.add_parser("precision-study",
                       help="dtype x cond error/duration tables "
                            "(performance_test_result parity)")
    p.add_argument("--sizes", default="128,256,500")
    p.add_argument("--conds", default="1e3,1e4,1e5,1e6,1e7")
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--out", default="log/precision_study")
    p.set_defaults(fn=cmd_precision_study)

    p = sub.add_parser("plot", help="plot CSV logs")
    p.add_argument("logs", nargs="+")
    p.add_argument("--out", default="log/plots")
    p.set_defaults(fn=cmd_plot)

    args = parser.parse_args(argv)
    if args.platform == "cpu":
        args.device = "cpu"
    elif args.cmd in _DEVICE_COMMANDS and not torch.cuda.is_available():
        print(f"error: {args.cmd} runs on the GPU and no CUDA device is "
              "available; pass --platform cpu to run it on the CPU",
              file=sys.stderr)
        return 2
    else:
        args.device = "cuda"
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
