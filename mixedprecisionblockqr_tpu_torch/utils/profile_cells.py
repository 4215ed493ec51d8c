"""Where the time goes: profile the calls that ``chip_smoke.py`` drives, on
one CUDA device.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.profile_cells [--host]
        [--enqueue] [name ...]

With names, only the cells whose name contains one of them.  For each cell
it prints one JSON line:
  * ``wall_ms``: host clock around one synchronized call, median of 3
    (after one warm-up);
  * ``profiled_ms``: host clock per call across ``calls`` calls under
    ``torch.profiler`` (CPU and CUDA activity), which slows the host side;
  * ``busy_share``: the union of the device's activity intervals (kernels,
    copies, memsets) over the profiled wall time: the share of the call in
    which the device had work;
  * ``device_events``: device activities per call;
  * ``top``: the largest device items by time per call, with their counts
    per call;
  * with ``--host``, ``host_ms`` and ``host_top``: one more synchronized
    call under ``cProfile``, its host clock and the Python functions with
    the most time of their own in it (the wait for the device shows as
    ``_cuda_synchronize``).  The tracer slows the host side; compare two
    trees by it only within one call of this script on each;
  * with ``--enqueue``, ``enqueue``: the ``torch.matmul`` calls of one
    call of the cell, recorded (shapes, strides, types) and launched again
    on views of zeroed buffers, once into an idle device queue (after a
    synchronize) and once behind a busy one (after ``torch.cuda._sleep``
    of ``BUSY_S`` seconds), idle / busy / busy / idle: the host's time to
    launch them all, and its median and 90th percentile a call.  It
    measures what a launch costs the host with and without work ahead of
    it on the device (the 16384^2 scan's 1280 products).
The cells: ``headline`` (block_qr 2048^2 POLICY_MIXED_FAST, bgs1), ``qr
default`` (qr 2048^2 POLICY_MIXED, bgs2), ``band`` (the headline call at
4096^2), ``lstsq`` (the 4096 x 2048 gauge-deficient system of
``datagen.gauge_deficient_system``) and its four stages as ``lstsq`` runs
them, ``robust`` (the Householder tier at 2048^2), ``householder_pallas``
(the same call with every panel through K6), ``cholqr1 scan`` (the
2048^2 CholeskyQR tier under POLICY_MIXED with ``loop_mode='scan'``: 15
K4 launches, ``chip_smoke.py`` phase 11's), ``polar`` (the
auto-dispatched complete Q of a 4096 x 2048 input, POLICY_MIXED_FAST),
``proj_entry`` (the headline's BGS driver with the inter-group projection
inside K5), ``scan 16384^2`` (the headline call at 16384^2: bgs1 / scan),
``bgs scan 4096^2`` (the all-robust scan tier under POLICY_FP32), and
``chip_smoke.py`` phases 16-18: ``tsqr 100000x64`` (7 batched K6
launches for 127 panels), ``lstsq refine`` (``refine_steps=2`` on the
full-rank ``slam_jacobian(4096, 2048, seed=0)``: stored-factor CAQR, one
batched K6 a panel's leaves and one a tree level), ``lstsq_batched`` (8
systems of 2048 x 512: the Householder driver on the stack, one batched
K6 a panel step), ``block_qr_batched`` (the same 8 x 2048 x 512 stack,
POLICY_FP32, ``'householder'``, reduced), ``block_qr_batched_bgs1``
(``chip_smoke.py`` phase 25 (a): 8 x 2048 x 2048, member i from
``default_rng(i)``, POLICY_MIXED_FAST, ``'bgs1'``, reduced: 4 batched K2
entries for 32 groups), ``block_qr_batched_polar`` (``chip_smoke.py``
phase 26 (a): 8 x 4096 x 2048, member i from ``default_rng(i)``,
POLICY_MIXED_FAST, ``'polar'``, complete: 16 batched K1 and 16 batched K4
launches) and ``autodiff``
(``qr_autodiff`` forward and backward on 2048 x 1024, POLICY_FP32), and
``chip_smoke.py`` phase 19's streaming cells:
``rls`` (``rls_update`` of 16 rows from ``default_rng(4)`` into the
``rls_init`` state of the full-rank ``slam_jacobian(4096, 2048, seed=0)``:
one G1 launch) and ``givens`` (``qr_rank1_update`` of the complete factors
of ``default_rng(0).random((2048, 2048)) - 0.5``, u and v from
``default_rng(2)`` x 1e-3: one G2 and one G3), and ``chip_smoke.py``
phase 21's widths: ``headline r=256`` (the headline call at
``block_size=256``: bgs1 g4, K2 at r = 256 on the chain's L2 route) and
``polar 4096x2048 r=256`` (8 K1 + 8 K4 at 256), and ``chip_smoke.py``
phase 24's calls through K6's wide route: ``householder r=256`` (the
Householder tier at 2048^2, block 256), ``lstsq tsqr 4096x2048``
(``method='tsqr'`` on the full-rank SLAM Jacobian: one 2048-wide leaf)
and ``tsqr 65536x256`` (7 wide batched calls for 127 panels).  The inputs
of phases 16-19 and
24 are made at first use.
Without a CUDA device it exits 2.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

Span = Tuple[str, float, float]  # (name, start us, end us)


def device_spans(prof) -> List[Span]:
    """Every device activity of a finished profile."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(spans: List[Span]) -> float:
    """Length of the union of the spans' intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted((s, e) for _, s, e in spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def top_items(spans: List[Span], calls: int, k: int = 6) -> List[Dict]:
    """The k largest device items by total time, per call, each under the
    first 80 characters of its demangled name."""
    ms: Dict[str, float] = collections.defaultdict(float)
    count: Dict[str, int] = collections.Counter()
    for name, s, e in spans:
        ms[name] += (e - s) / 1e3
        count[name] += 1
    return [{"name": n.removeprefix("void ").replace(
                "(anonymous namespace)::", "")[:80],
             "ms": ms[n] / calls, "count": count[n] / calls}
            for n in sorted(ms, key=ms.get, reverse=True)[:k]]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def host_items(fn: Callable[[], object], k: int = 8) -> Dict:
    """One synchronized call of ``fn`` under ``cProfile``: its host clock
    and the k functions with the most time of their own, in ms."""
    import cProfile
    import pstats
    from pathlib import Path

    tracer = cProfile.Profile()
    t0 = time.perf_counter()
    tracer.enable()
    fn()
    _sync()
    tracer.disable()
    host_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(tracer).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:k]
    return {"host_ms": host_ms,
            "host_top": [{"fn": f"{Path(f).name}:{line}({name})",
                          "ms": tt * 1e3, "calls": nc}
                         for (f, line, name), (_, nc, tt, _, _) in top]}


#: Seconds of ``torch.cuda._sleep`` that keep the device busy while the
#: recorded products are launched behind it (``--enqueue``).
BUSY_S = 0.25


def matmul_calls(fn: Callable[[], object]) -> List[tuple]:
    """The ``torch.matmul`` calls of one synchronized call of ``fn``: per
    call, (shape, stride, dtype) of each operand."""
    calls, real = [], torch.matmul

    def record(a, b, *args, **kw):
        calls.append(tuple((tuple(x.shape), tuple(x.stride()), x.dtype)
                           for x in (a, b)))
        return real(a, b, *args, **kw)

    torch.matmul = record
    try:
        fn()
        _sync()
    finally:
        torch.matmul = real
    return calls


def enqueue_times(fn: Callable[[], object]) -> Dict:
    """``--enqueue``: :func:`matmul_calls` of ``fn`` launched again, idle /
    busy / busy / idle (see the module's docstring), on operands that are
    views of one zeroed buffer per type, made before the clock starts."""
    calls = matmul_calls(fn)
    dev = torch.device("cuda", 0)
    need: Dict[torch.dtype, int] = collections.defaultdict(int)
    for ops in calls:
        for shape, stride, dtype in ops:
            need[dtype] = max(need[dtype], 1 + sum(
                (n - 1) * st for n, st in zip(shape, stride)))
    bufs = {dt: torch.zeros(n, dtype=dt, device=dev)
            for dt, n in need.items()}
    views = [tuple(bufs[dt].as_strided(shape, stride)
                   for shape, stride, dt in ops) for ops in calls]
    cycles = int(BUSY_S * 2e9)  # at or below the card's 1.98 GHz maximum

    def once(busy: bool) -> Dict:
        _sync()
        if busy:
            torch.cuda._sleep(cycles)
        per = []
        t0 = time.perf_counter()
        for a, b in views:
            t = time.perf_counter()
            torch.matmul(a, b)
            per.append(time.perf_counter() - t)
        total = time.perf_counter() - t0
        _sync()
        per.sort()
        return {"ms": total * 1e3, "median_us": per[len(per) // 2] * 1e6,
                "p90_us": per[int(0.9 * len(per))] * 1e6}

    runs = {"idle": [], "busy": []}
    for mode in ("idle", "busy", "busy", "idle"):
        runs[mode].append(once(mode == "busy"))
    del views, bufs
    return {"enqueue": {"matmuls": len(calls), "busy_s": BUSY_S, **runs}}


def profile_cell(fn: Callable[[], object], calls: int) -> Dict:
    """Host walls of ``fn`` and one profile of ``calls`` calls of it."""
    fn()
    _sync()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        _sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync()
        profiled_us = (time.perf_counter() - t0) * 1e6
    spans = device_spans(prof)
    return {"wall_ms": statistics.median(walls), "calls": calls,
            "profiled_ms": profiled_us / 1e3 / calls,
            "busy_share": busy_us(spans) / profiled_us,
            "device_events": len(spans) / calls,
            "top": top_items(spans, calls)}


def main(only: Sequence[str] = ()) -> int:
    host, enqueue = "--host" in only, "--enqueue" in only
    only = [o for o in only if o not in ("--host", "--enqueue")]
    if not torch.cuda.is_available():
        print("profile_cells: no CUDA device", file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch import (
        POLICY_FP32,
        POLICY_MIXED,
        POLICY_MIXED_FAST,
        back_substitution,
        block_qr,
        block_qr_batched,
        block_qr_qtb,
        lstsq,
        lstsq_batched,
        numerical_rank,
        pivoted_qr_qtb,
        qr,
        qr_autodiff,
        qr_rank1_update,
        rls_init,
        rls_update,
        tsqr,
    )
    from mixedprecisionblockqr_tpu_torch.ops.blockqr import _block_qr_bgs
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
    from mixedprecisionblockqr_tpu_torch.utils.datagen import (
        gauge_deficient_system,
        slam_jacobian,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()

    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.random((2048, 2048), dtype=np.float32)
                         - 0.5).to(dev)
    A4 = torch.from_numpy(rng.random((4096, 4096), dtype=np.float32)
                          - 0.5).to(dev)
    A42 = torch.from_numpy(np.random.default_rng(0).random(
        (4096, 2048), dtype=np.float32) - 0.5).to(dev)
    Jn, bn = gauge_deficient_system(4096, 2048, 64)
    J = torch.from_numpy(Jn).to(dev)
    nb = -torch.from_numpy(bn).to(dev)
    # The pivoted stage's outputs feed the two stages after it.
    R, qtb, _ = pivoted_qr_qtb(J, nb[:, None])
    k = numerical_rank(R, m=4096)
    RkT = R[:k, :].T.contiguous()
    _, T = qr(RkT, mode="reduced", panel_method="householder")

    def headline(x, r=128):
        return block_qr(x, r, POLICY_MIXED_FAST, mode="complete",
                        panel_method="auto", quality="fast", check="defer")

    big_input = []

    def big():
        """The 16384^2 input (1 GiB), made on the card at first use."""
        if not big_input:
            big_input.append(torch.rand(
                (16384, 16384), device=dev,
                generator=torch.Generator(device=dev).manual_seed(0)) - 0.5)
        return big_input[0]

    made = {}

    def lazy(key, make):
        """An input made on the card at first use."""
        if key not in made:
            made[key] = make()
        return made[key]

    def tall():
        return torch.from_numpy(np.random.default_rng(0).random(
            (100000, 64), dtype=np.float32) - 0.5).to(dev)

    def tall256():
        return torch.from_numpy(np.random.default_rng(0).random(
            (65536, 256), dtype=np.float32) - 0.5).to(dev)

    def slam():
        return (torch.from_numpy(slam_jacobian(4096, 2048, seed=0)).to(dev),
                torch.from_numpy(np.random.default_rng(2).standard_normal(
                    4096).astype(np.float32)).to(dev))

    def batch():
        return (torch.from_numpy(np.stack(
                    [slam_jacobian(2048, 512, seed=i) for i in range(8)])
                ).to(dev),
                torch.from_numpy(np.random.default_rng(2).standard_normal(
                    (8, 2048)).astype(np.float32)).to(dev))

    def headline_stack():
        """chip_smoke.py phase 25 (a)'s stack: member i the uniform draw of
        ``default_rng(i)`` - 0.5, so member 0 is the headline's input."""
        return torch.from_numpy(np.stack(
            [np.random.default_rng(i).random((2048, 2048), dtype=np.float32)
             - 0.5 for i in range(8)])).to(dev)

    def polar_stack():
        """chip_smoke.py phase 26 (a)'s stack: member i the uniform draw of
        ``default_rng(i)`` - 0.5, so member 0 is the polar cell's input."""
        return torch.from_numpy(np.stack(
            [np.random.default_rng(i).random((4096, 2048), dtype=np.float32)
             - 0.5 for i in range(8)])).to(dev)

    def rls_case():
        st = rls_init(*lazy("slam", slam))
        rng4 = np.random.default_rng(4)
        rows = rng4.standard_normal((16, 2048)).astype(np.float32)
        betas = rng4.standard_normal(16).astype(np.float32)
        return (st, torch.from_numpy(rows).to(dev),
                torch.from_numpy(betas).to(dev))

    def rank1_case():
        a = np.random.default_rng(0).random((2048, 2048),
                                            dtype=np.float32) - 0.5
        q, r = np.linalg.qr(a, mode="complete")
        rng2 = np.random.default_rng(2)
        u = rng2.standard_normal(2048).astype(np.float32) * 1e-3
        v = rng2.standard_normal(2048).astype(np.float32) * 1e-3
        return tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                     for x in (q, r, u, v))

    def autodiff_step():
        X = A[:, :1024].clone().requires_grad_()
        Q, R = qr_autodiff(X, 128, POLICY_FP32)
        (Q.sum() + R.sum()).backward()

    cells = [
        ("headline", lambda: headline(A), 5),
        ("qr default", lambda: qr(A, policy=POLICY_MIXED), 5),
        ("band", lambda: headline(A4), 5),
        ("lstsq", lambda: lstsq(J, nb), 1),
        ("lstsq: block_qr_qtb householder",
         lambda: block_qr_qtb(J, nb, panel_method="householder",
                              check="sync"), 1),
        ("lstsq: pivoted_qr_qtb rqrcp",
         lambda: pivoted_qr_qtb(J, nb[:, None]), 1),
        (f"lstsq: qr(Rk.T) householder 2048 x {k}",
         lambda: qr(RkT, mode="reduced", panel_method="householder"), 1),
        ("lstsq: back_substitution",
         lambda: back_substitution(T.T, qtb[:k, :], lower=True), 1),
        ("robust", lambda: block_qr(A, 128, POLICY_FP32,
                                    panel_method="householder"), 1),
        ("householder_pallas", lambda: block_qr(
            A, 128, POLICY_FP32, panel_method="householder_pallas"), 5),
        ("cholqr1 scan", lambda: block_qr(
            A, 128, POLICY_MIXED, mode="complete", panel_method="cholqr1",
            loop_mode="scan"), 5),
        ("polar 4096x2048", lambda: block_qr(
            A42, 128, POLICY_MIXED_FAST, mode="complete",
            panel_method="auto", quality="fast"), 5),
        ("proj_entry", lambda: _block_qr_bgs(
            A, 128, POLICY_MIXED_FAST, True, group_panels=8, reorth=False,
            chain_mid=True, proj_entry=True), 5),
        ("scan 16384^2", lambda: headline(big()), 1),
        ("bgs scan 4096^2", lambda: block_qr(
            A4, 128, POLICY_FP32, panel_method="bgs", loop_mode="scan"), 1),
        ("tsqr 100000x64", lambda: tsqr(lazy("tall", tall)), 5),
        ("lstsq refine", lambda: lstsq(*lazy("slam", slam),
                                       refine_steps=2), 1),
        ("lstsq_batched", lambda: lstsq_batched(*lazy("batch", batch)), 1),
        ("block_qr_batched 8x2048x512", lambda: block_qr_batched(
            lazy("batch", batch)[0], 128, POLICY_FP32,
            panel_method="householder"), 1),
        ("block_qr_batched_bgs1 8x2048x2048", lambda: block_qr_batched(
            lazy("headline_stack", headline_stack), 128, POLICY_MIXED_FAST,
            panel_method="bgs1"), 3),
        ("block_qr_batched_polar 8x4096x2048", lambda: block_qr_batched(
            lazy("polar_stack", polar_stack), 128, POLICY_MIXED_FAST,
            mode="complete", panel_method="polar"), 3),
        ("autodiff", autodiff_step, 5),
        ("rls update 16 rows n=2048",
         lambda: rls_update(*lazy("rls", rls_case)), 5),
        ("givens rank1_update 2048^2",
         lambda: qr_rank1_update(*lazy("rank1", rank1_case)), 5),
        ("headline r=256", lambda: headline(A, 256), 5),
        ("polar 4096x2048 r=256", lambda: headline(A42, 256), 5),
        ("householder r=256", lambda: block_qr(
            A, 256, POLICY_FP32, panel_method="householder"), 5),
        ("lstsq tsqr 4096x2048", lambda: lstsq(*lazy("slam", slam),
                                               method="tsqr"), 3),
        ("tsqr 65536x256", lambda: tsqr(lazy("tall256", tall256)), 3),
    ]
    for name, fn, calls in cells:
        if only and not any(o in name for o in only):
            continue
        row = profile_cell(fn, calls)
        if host:
            row.update(host_items(fn))
        if enqueue:
            row.update(enqueue_times(fn))
        print(json.dumps({"cell": name, **row, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
