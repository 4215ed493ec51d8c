"""K4 ``ninv_chain`` and the robust R-block combine alone on the card.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.ninv_probe [--phases]

Builds (or loads) the kernel library and prints JSON lines.  The first
line is the card's name and power limit (nvidia-smi).  Then:

* one line per K4 input of :func:`k4_inputs` (``chip_smoke.py`` phase 3's,
  from the same generator draws): two launches and whether they agree bit
  for bit, max|dX| against ``ninv_chain_plain`` with its limit (1e-4 of
  max|X|), the residual beside the plain version's and whether both land on
  the same side of the drivers' fallback threshold (1e-3), the times of the
  kernel, the plain version and ``torch.linalg.inv(S)`` (CUDA events,
  median of 20), the kernel's device time (:func:`session_device_ms`:
  median of 20 calls in one ``torch.profiler`` session), the host's time
  to issue one call (:func:`host_us`), its cluster and its bound
  (``utils/bounds.py``);
* one line of an S with a NaN entry, whose residual must be NaN;
* one line of the combine at r = 128 on the t1, t2, t3 of a robust K3 call
  on the RQRCP panel (4096 x 128, phase 3's panel; the plain route's
  values, ``ns.robust_products``): two launches bit for bit, max|d| against
  ``tri_combine_plain`` (limit 1e-4 of max|out|), the kernel's time (events
  and device) and host time per call, ``T3 @ (T2 @ T1)`` (a yardstick) and
  the bound;
* one line of robust K3 on that panel: its time and the combine's device
  time inside it (``torch.profiler``, median of 10).

With ``--phases``, the kernel library's K4 is built a second time with
``-DMPBQR_NINV_PROF`` (:data:`PROF_BUILD`: ``ninv_chain.cu`` alone,
``_build.instrumented_library``); one more launch of K4 per input from it
gives a line per input: per CTA, the microseconds its thread 0 spent in
each phase (:data:`PHASES`, summed over the iterations, at the SM clock
that ``nvidia-smi`` reads beside it).

``--l2`` takes K4's L2 route (r > 128) and the L2 combine instead:

* one line per set of :data:`L2_SETS` (r = 192, 256, 512, 1024 at 5 and
  12 iterations, on :func:`l2_inputs`): :func:`k4_row`'s checks and times,
  the device time (:func:`session_device_ms`: one ``torch.profiler``
  session of 20 calls, since many sessions in one process come back
  empty), ``loop_ms`` (:data:`LOOP` launches back to back, over LOOP),
  and a hash of X and resid (:func:`digest`), which a parent tree's run
  in the same call must repeat bit for bit;
* one line per stack of :data:`L2_STACKS` (4 and 8 x 256, 5 iterations):
  ``batched_probe.k4_batched_row`` with the device time, ``loop_ms`` and
  the stack's hash;
* one line per width of :data:`COMBINE_WIDTHS` (128 .. 1024): the combine
  on the t1, t2, t3 of a robust 4096 x r panel (:func:`combine_row`, its
  device time beside ``T3 @ (T2 @ T1)``'s, each from one session) with
  the hash of its output and of its inputs;
* one line of the callers whose robust panels close with the combine: K3
  4096 x 256 and 4096 x 128 robust, K2 2048 x 1024 g4 bgs1 at r = 256
  (CUDA events, median of 20);
* with ``--phases`` too, one launch of each of :data:`L2_PHASE_SETS` (r =
  192, 256, 512 at 5 and 12 iterations) from the clock build: per slot of
  :data:`L2_SLOTS` the mean cycles over the cluster's CTAs, their share,
  the cycles an iteration of the loop's slots, each CTA's cycles
  (:func:`l2_phase_table`), and whether the clock build's outputs equal
  the library's bit for bit.

It runs whichever ``mixedprecisionblockqr_tpu_torch`` Python imports, so a
parent tree can be timed in the same call, with this file:
``PYTHONPATH=<parent tree> python3 -P <this file> [--l2]`` (without
``--phases``, whose clock build only this tree has).  A tree without the
combine's own wrapper gets the K3 line but no combine line, and a tree
without ``ns.ninv_layout`` reports its K4 as one CTA.  It needs a CUDA
device and ``nvcc``; without a device it exits 2, and 1 when a check fails.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys

import torch

#: The drivers' LU fallback threshold on K4's residual (ops/blockqr.py).
FALLBACK = 1e-3
TOL = 1e-4
#: Slots of K4's phase clocks (csrc/ninv_chain.cu, PROF), as CTA thread 0
#: sees them.
PHASES = {"setup": 0, "prod_SX": 1, "sync_SX": 2, "cluster_wait": 3,
          "prod_XE": 4, "gather": 5, "cluster_arrive": 6, "residual": 7}
#: The clock build: macro, its read-out entry (two pointers: the
#: shared-memory route's record, 8 x 8, and the L2 route's), the source.
PROF_BUILD = ("-DMPBQR_NINV_PROF", "mpbqr_ninv_prof", 2, ("ninv_chain.cu",))
#: The slots of the L2 route's clock, in the order of csrc/ninv_chain.cu's
#: NL_*; those an iteration runs; the CTA rows of its record.
L2_SLOTS = ("setup", "prod_sx", "prod_xe", "barrier", "residual",
            "x_store", "cluster_max")
L2_LOOP_SLOTS = ("prod_sx", "prod_xe", "barrier")
L2_PROF_CTAS = 16
#: Launches back to back in one ``loop_ms`` timing.
LOOP = 20
#: name -> (r, iterations) of K4 on the L2 route (``--l2``): 5 is the
#: polar tier's count, 12 the cholqr scan's.
L2_SETS = {f"r{r}_it{it}": (r, it) for r in (192, 256, 512, 1024)
           for it in (5, 12)}
#: The sets the clock build runs.
L2_PHASE_SETS = tuple(n for n, (r, _) in L2_SETS.items() if r <= 512)
#: name -> (B, r, iterations) of the batched entry on the L2 route.
L2_STACKS = {"4x256_it5": (4, 256, 5), "8x256_it5": (8, 256, 5)}
#: Widths of the combine's rows (``--l2``): the shared-memory route's
#: widest, then the L2 route.
COMBINE_WIDTHS = (128, 192, 256, 512, 1024)


def yamamoto_s(m: int, gen: torch.Generator, dev, r: int = 128,
               batch: tuple = ()) -> torch.Tensor:
    """The Yamamoto S = I - Q1^T of a uniform m x r panel drawn from
    ``gen`` (Q1 the sign-fixed top r x r block of its orthonormal basis),
    or a (*batch, r, r) stack of them from one (*batch, m, r) draw."""
    from mixedprecisionblockqr_tpu_torch.ops.cholqr import _sign_fix

    Qb, _ = torch.linalg.qr(
        torch.rand((*batch, m, r), generator=gen, device=dev) - 0.5)
    D = _sign_fix(Qb[..., :r, :])
    return (torch.eye(r, device=dev)
            - (Qb * D[..., None, :])[..., :r, :].mT).contiguous()


def k4_inputs(gen: torch.Generator, dev) -> dict:
    """name -> (S, iters): Yamamoto S matrices (:func:`yamamoto_s`) of a
    4096 x 128 panel (aspect 32, 5 iterations: the polar phase's), a 256 x
    128 one (aspect 2, 12: the cholqr scan's), both drawn from ``gen`` in
    that order, and a near-singular S: the rotation by pi about
    (1,1,1)/sqrt(3) of the JAX package's ops/cholqr.py:110-115, scaled by
    0.999, in the top corner (12 iterations stall above the fallback
    threshold)."""
    c3 = torch.ones(3, device=dev) / 3 ** 0.5
    S_sing = torch.eye(128, device=dev)
    S_sing[:3, :3] -= 0.999 * (2 * torch.outer(c3, c3)
                               - torch.eye(3, device=dev)).T
    return {"panel4096_it5": (yamamoto_s(4096, gen, dev), 5),
            "panel256_it12": (yamamoto_s(256, gen, dev), 12),
            "near_singular_it12": (S_sing.contiguous(), 12)}


def l2_inputs(r: int, dev) -> dict:
    """iterations -> S of K4's L2 rows at width r, from a generator seeded
    with 1000 + r: the Yamamoto S of a 4096 x r panel (5 iterations) and
    of a 2r x r one (12)."""
    gen = torch.Generator(device=dev).manual_seed(1000 + r)
    return {5: yamamoto_s(4096, gen, dev, r=r),
            12: yamamoto_s(2 * r, gen, dev, r=r)}


def digest(*ts) -> str:
    """A short sha256 of the tensors' bytes: equal outputs of two trees
    give equal digests."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _max_abs(a, b) -> float:
    return float((a - b).abs().max())


def session_device_ms(fn, calls: int = 20, attempts: int = 8) -> float:
    """Median device time of one call of ``fn`` over ``calls`` calls in ONE
    ``torch.profiler`` session (many sessions in one process have come back
    empty on an H100): each call after a marker kernel
    (``torch.cuda._sleep``) and synchronized, its device activities
    summed.  Raises when no session shows half the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                torch.cuda._sleep(1000)
                fn()
                torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end,
                        "spin_kernel" in e.name) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        per = []
        for start, end, mark in spans:
            if mark:
                per.append(0.0)
            elif per:
                per[-1] += end - start
        per = [t for t in per if t > 0]
        if len(per) >= calls // 2:
            return statistics.median(per) / 1e3
    raise RuntimeError(f"torch.profiler saw too few calls in {attempts} "
                       f"sessions")


def host_us(fn, calls: int = 50, batches: int = 5) -> float:
    """Host microseconds to issue one call of ``fn`` (median over
    ``batches`` of ``calls`` calls issued back to back, each batch after a
    synchronize): what a host-bound caller pays per launch."""
    import time

    fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def k4_row(S: torch.Tensor, iters: int, profiled: bool = True) -> dict:
    """Two launches of K4 and the plain version on ``S``: agreement, the
    fallback class, times, cluster and bound; with ``profiled``, the
    device time from ``torch.profiler`` and the host time to issue a
    launch as well."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
    from mixedprecisionblockqr_tpu_torch.utils.bounds import ninv_chain_bound
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    X, res = ns.ninv_chain(S, iters)
    X2, res2 = ns.ninv_chain(S, iters)
    Xp, resp = ns.ninv_chain_plain(S, iters)
    torch.cuda.synchronize()
    err, lim = _max_abs(X, Xp), TOL * float(Xp.abs().max())
    same = bool(torch.equal(X, X2) and torch.equal(res, res2))
    klass = (float(res) < FALLBACK) == (float(resp) < FALLBACK)
    layout = getattr(ns, "ninv_layout", None)
    r = S.shape[0]
    row = {"iters": iters, "max_abs_X": err, "lim_X": lim,
           "resid": float(res), "resid_plain": float(resp),
           "same_fallback_class": klass, "bitwise_repeatable": same,
           "ok": err <= lim and klass and same,
           "cluster": layout(r).ctas if layout else 1,
           "ms": cuda_time_ms(lambda: ns.ninv_chain(S, iters))}
    if profiled:
        row["device_ms"] = session_device_ms(lambda: ns.ninv_chain(S, iters))
        row["host_us"] = host_us(lambda: ns.ninv_chain(S, iters))
    return {**row,
            "plain_ms": cuda_time_ms(lambda: ns.ninv_chain_plain(S, iters)),
            "library_ms": cuda_time_ms(lambda: torch.linalg.inv(S)),
            **ninv_chain_bound(r, iters)}


def _combine_ctas(T1) -> int:
    """CTAs of the combine's layout for T1's width on T1's card (a tree
    whose combine layout takes no cluster size: its plain grid's)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns

    r = T1.shape[0]
    if "max_cluster" in inspect.signature(ns.combine_layout).parameters:
        return ns.combine_layout(r, ns._card_cluster(T1, r)).ctas
    return ns.combine_layout(r).ctas


def combine_row(T1, T2, T3, profiled: bool = True) -> dict:
    """Two launches of the combine and its plain version on T1..T3; with
    ``profiled``, the device time from ``torch.profiler`` and the host time
    to issue a launch as well."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        tri_combine_bound,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    out = ns.tri_combine(T1, T2, T3)
    again = ns.tri_combine(T1, T2, T3)
    ref = ns.tri_combine_plain(T1, T2, T3)
    torch.cuda.synchronize()
    err, lim = _max_abs(out, ref), TOL * float(ref.abs().max())
    same = bool(torch.equal(out, again))
    row = {"r": T1.shape[0], "max_abs": err, "lim": lim,
           "bitwise_repeatable": same, "ok": err <= lim and same,
           "ctas": _combine_ctas(T1),
           "ms": cuda_time_ms(lambda: ns.tri_combine(T1, T2, T3))}
    if profiled:
        row["device_ms"] = session_device_ms(
            lambda: ns.tri_combine(T1, T2, T3))
        row["host_us"] = host_us(lambda: ns.tri_combine(T1, T2, T3))
    return {**row,
            "plain_ms": cuda_time_ms(
                lambda: ns.tri_combine_plain(T1, T2, T3)),
            "library_call": "T3 @ (T2 @ T1)",
            "library_ms": cuda_time_ms(lambda: T3 @ (T2 @ T1)),
            **tri_combine_bound(T1.shape[0])}


def k3_combine_row(Pk: torch.Tensor, calls: int = 10) -> dict:
    """Robust K3 on ``Pk``: its time and its combine's device time."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import panel_qr_fused
    from mixedprecisionblockqr_tpu_torch.utils.group_probe import (
        _profile_once,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    def call():
        return panel_qr_fused(Pk, robust=True)

    inside, names = [], set()
    for _ in range(calls):
        spans = [x for x in _profile_once(call) if "combine" in x[0]]
        names |= {x[0][:60] for x in spans}
        inside.append(sum(e - s for *_, s, e in spans) / 1e3)
    return {"shape": list(Pk.shape), "ms": cuda_time_ms(call),
            "combine_device_ms": statistics.median(inside),
            "combine_kernels": sorted(names)}


def _sm_mhz(query: str = "clocks.sm") -> float:
    """The card's SM clock in MHz as ``nvidia-smi`` reads ``query``: by
    default the current one; ``clocks.max.sm`` is the clock at which a
    count of cycles takes least time."""
    return float(subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def k4_phases(lib, S: torch.Tensor, iters: int, mhz: float) -> dict:
    """One launch of K4 from the instrumented library ``lib``: per phase
    of :data:`PHASES`, each CTA's microseconds."""
    import numpy as np

    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        _launch_ninv,
        ninv_layout,
    )

    _launch_ninv(lib, S, iters)
    torch.cuda.synchronize()
    prof = np.zeros((8, 8), np.int64)
    prof_l2 = np.zeros((L2_PROF_CTAS, len(L2_SLOTS)), np.int64)
    check(lib.mpbqr_ninv_prof(prof.ctypes.data, prof_l2.ctypes.data),
          "ninv_prof")
    n = ninv_layout(S.shape[0]).ctas
    return {name: [float(p[k]) / mhz for p in prof[:n]]
            for name, k in PHASES.items()}


def l2_phase_table(raw, ctas: int, iters: int, mhz: float) -> dict:
    """The L2 route's clock record ``raw`` ((L2_PROF_CTAS, len(L2_SLOTS))
    cycles of CTA thread 0) of a launch on ``ctas`` CTAs with ``iters``
    iterations, at ``mhz``: per slot the mean cycles over the CTAs, their
    share of the launch and microseconds, and for the loop's slots the
    cycles an iteration; ``per_cta``: each CTA's launch and each slot's
    cycles; the launch (the slowest CTA's sum)."""
    rows = [[int(c) for c in raw[p]] for p in range(ctas)]
    launch = [sum(row) for row in rows]
    mean_launch = sum(launch) / ctas
    out = {"ctas": ctas, "iters": iters, "sm_mhz": mhz,
           "launch_cycles": max(launch), "launch_us": max(launch) / mhz,
           "slots": {}, "per_cta": {"launch": launch}}
    for k, name in enumerate(L2_SLOTS):
        cyc = sum(row[k] for row in rows) / ctas
        slot = {"cycles": cyc, "share": cyc / mean_launch if mean_launch
                else 0.0, "us": cyc / mhz}
        if name in L2_LOOP_SLOTS and iters:
            slot["per_iteration"] = cyc / iters
        out["slots"][name] = slot
        out["per_cta"][name] = [row[k] for row in rows]
    return out


def l2_phase_rows(lib, S_of: dict, mhz: float, names=L2_PHASE_SETS) -> dict:
    """name -> :func:`l2_phase_table` of one launch of each set of
    ``names`` from the clock build ``lib`` (after one launch to warm it),
    with the SM clock ``nvidia-smi`` reads after it and whether its
    outputs equal the kernel library's bit for bit (the clock reads change
    no arithmetic).  ``S_of``: r -> :func:`l2_inputs`."""
    import numpy as np

    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        _launch_ninv,
        ninv_layout,
    )

    out = {}
    for name in names:
        r, it = L2_SETS[name]
        S = S_of[r][it]
        _launch_ninv(lib, S, it)
        theirs = _launch_ninv(lib, S, it)
        mine = _launch_ninv(library(), S, it)
        torch.cuda.synchronize()
        raw = np.zeros((8, 8), np.int64)
        raw_l2 = np.zeros((L2_PROF_CTAS, len(L2_SLOTS)), np.int64)
        check(lib.mpbqr_ninv_prof(raw.ctypes.data, raw_l2.ctypes.data),
              "ninv_prof")
        out[name] = {**l2_phase_table(raw_l2, ninv_layout(r).ctas, it, mhz),
                     "r": r, "sm_mhz_read": _sm_mhz(),
                     "same_as_library": all(bool(torch.equal(a, b))
                                            for a, b in zip(mine, theirs))}
    return out


def l2_main(smi: str, tree: str, phases: bool) -> bool:
    """``--l2``: K4's L2 sets and stacks, the combine's widths, the
    callers and, with ``phases``, the clock build's split (module
    docstring); one JSON line each.  Returns whether every check held."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build, ns
    from mixedprecisionblockqr_tpu_torch.utils.batched_probe import (
        k4_batched_row,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda", 0)
    S_of = {r: l2_inputs(r, dev) for r in sorted({r for r, _ in
                                                   L2_SETS.values()})}
    ok = True
    if phases:
        with _build.instrumented_library(*PROF_BUILD) as prof:
            rows = l2_phase_rows(prof, S_of, _sm_mhz("clocks.max.sm"))
            for name, row in rows.items():
                ok = ok and row["same_as_library"]
                print(json.dumps({"tree": tree, "phases": name, **row,
                                  "card": smi}), flush=True)
    for name, (r, it) in L2_SETS.items():
        S = S_of[r][it]
        row = k4_row(S, it)
        row["loop_ms"] = cuda_time_ms(
            lambda: [ns.ninv_chain(S, it) for _ in range(LOOP)]) / LOOP
        row["digest"] = digest(*ns.ninv_chain(S, it))
        ok = ok and row["ok"]
        print(json.dumps({"tree": tree, "k4": name, "r": r, **row,
                          "card": smi}), flush=True)
    for name, (B, r, it) in L2_STACKS.items():
        gen = torch.Generator(device=dev).manual_seed(2000 + B)
        S = yamamoto_s(4096, gen, dev, r=r, batch=(B,))
        row = k4_batched_row(S, it)
        row["device_ms"] = session_device_ms(
            lambda: ns.ninv_chain_batched(S, it))
        row["loop_ms"] = cuda_time_ms(
            lambda: [ns.ninv_chain_batched(S, it)
                     for _ in range(LOOP)]) / LOOP
        row["digest"] = digest(*ns.ninv_chain_batched(S, it))
        ok = ok and row["ok"]
        print(json.dumps({"tree": tree, "k4_batched": name, **row,
                          "card": smi}), flush=True)
    for r in COMBINE_WIDTHS:
        gen = torch.Generator(device=dev).manual_seed(3000 + r)
        P = torch.rand((4096, r), generator=gen, device=dev) - 0.5
        T = ns.robust_products(P)
        row = combine_row(*T)
        row["library_device_ms"] = session_device_ms(
            lambda: T[2] @ (T[1] @ T[0]))
        row["digest"] = digest(ns.tri_combine(*T))
        row["inputs_digest"] = digest(*T)
        ok = ok and row["ok"]
        print(json.dumps({"tree": tree, "combine": r, **row, "card": smi}),
              flush=True)
    gen = torch.Generator(device=dev).manual_seed(4000)
    Pg = torch.rand((2048, 1024), generator=gen, device=dev) - 0.5
    Pk = {r: torch.rand((4096, r), generator=gen, device=dev) - 0.5
          for r in (256, 128)}
    calls = {
        "k3_4096x256_robust": lambda: ns.panel_qr_fused(Pk[256],
                                                        robust=True),
        "k3_4096x128_robust": lambda: ns.panel_qr_fused(Pk[128],
                                                        robust=True),
        "k2_2048x1024_g4_r256_bgs1": lambda: ns.bgs_group_fused(
            Pg, 256, (12, 6, 6, 10), (False, False, False, True),
            bf16_dots=True, chain_mid=True),
    }
    print(json.dumps({"tree": tree, "callers": {
        name: {"ms": cuda_time_ms(fn), "digest": digest(*fn())}
        for name, fn in calls.items()}, "card": smi}), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--l2", action="store_true",
                    help="K4's L2 route and the L2 combine (r > 128)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ninv_probe: no CUDA device", file=sys.stderr)
        return 2
    import mixedprecisionblockqr_tpu_torch as pkg
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build, ns

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.l2:
        return 0 if l2_main(smi, pkg.__file__, args.phases) else 1
    dev = torch.device("cuda", 0)
    # chip_smoke.py phase 3's draws: its K1 and K2 inputs, the RQRCP panel,
    # then K4's inputs.
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in ((2048, 128), (2048, 1024)):
        torch.rand(shape, generator=gen, device=dev)
    Pk = torch.rand((4096, 128), generator=gen, device=dev) - 0.5
    tree = pkg.__file__
    ok = True
    inputs = k4_inputs(gen, dev)
    for name, (S, it) in inputs.items():
        row = k4_row(S, it)
        ok = ok and row["ok"]
        print(json.dumps({"tree": tree, "k4": name, **row}), flush=True)
    S_nan = inputs["panel4096_it5"][0].clone()
    S_nan[4, 9] = float("nan")
    res_nan = float(ns.ninv_chain(S_nan, 5)[1])
    ok = ok and res_nan != res_nan
    print(json.dumps({"tree": tree, "k4": "nan_in_S", "resid": res_nan}),
          flush=True)
    if hasattr(ns, "tri_combine"):
        row = combine_row(*ns.robust_products(Pk))
        ok = ok and row["ok"]
        print(json.dumps({"tree": tree, "combine": "robust_4096x128",
                          **row}), flush=True)
    print(json.dumps({"tree": tree, "k3_robust": k3_combine_row(Pk)}),
          flush=True)
    if args.phases:
        with _build.instrumented_library(*PROF_BUILD) as prof:
            for name, (S, it) in inputs.items():
                mhz = _sm_mhz()
                print(json.dumps({"k4": name, "iters": it, "sm_mhz": mhz,
                                  "phases_us": k4_phases(prof, S, it, mhz)}),
                      flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
