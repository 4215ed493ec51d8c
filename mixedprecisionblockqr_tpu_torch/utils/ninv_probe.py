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
  median of 20), the kernel's device time (``torch.profiler``, median of
  10), the host's time to issue one call (:func:`host_us`), its cluster
  and its bound (``utils/bounds.py``);
* one line of an S with a NaN entry, whose residual must be NaN;
* one line of the combine at r = 128 on the t1, t2, t3 of a robust K3 call
  on the RQRCP panel (4096 x 128, phase 3's panel; the plain route's
  values, ``ns.robust_products``): two launches bit for bit, max|d| against
  ``tri_combine_plain`` (limit 1e-4 of max|out|), the kernel's time (events
  and device) and host time per call, ``T3 @ (T2 @ T1)`` (a yardstick) and the bound;
* one line of robust K3 on that panel: its time and the combine's device
  time inside it (``torch.profiler``, median of 10).

With ``--phases``, the kernel library is built a second time with
``-DMPBQR_NINV_PROF`` (``_build.instrumented_library``); one more launch of
K4 per input from it gives a line per input: per CTA, the microseconds its
thread 0 spent in each phase (:data:`PHASES`, summed over the iterations,
at the SM clock that ``nvidia-smi`` reads beside it).

It runs whichever ``mixedprecisionblockqr_tpu_torch`` Python imports, so a
parent tree can be timed in the same call, with this file:
``PYTHONPATH=<parent tree> python3 <this file>``.  A tree without the
combine's own wrapper gets the K3 line but no combine line, and a tree
without ``ns.ninv_layout`` reports its K4 as one CTA.  It needs a CUDA
device and ``nvcc``; without a device it exits 2, and 1 when a check fails.
"""

from __future__ import annotations

import argparse
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


def _max_abs(a, b) -> float:
    return float((a - b).abs().max())


def _device_ms(fn, calls: int = 10) -> float:
    from mixedprecisionblockqr_tpu_torch.utils.group_probe import device_ms

    return device_ms(fn, calls)


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
        row["device_ms"] = _device_ms(lambda: ns.ninv_chain(S, iters))
        row["host_us"] = host_us(lambda: ns.ninv_chain(S, iters))
    return {**row,
            "plain_ms": cuda_time_ms(lambda: ns.ninv_chain_plain(S, iters)),
            "library_ms": cuda_time_ms(lambda: torch.linalg.inv(S)),
            **ninv_chain_bound(r, iters)}


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
           "ctas": ns.combine_layout(T1.shape[0]).ctas,
           "ms": cuda_time_ms(lambda: ns.tri_combine(T1, T2, T3))}
    if profiled:
        row["device_ms"] = _device_ms(lambda: ns.tri_combine(T1, T2, T3))
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


def _sm_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
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
    check(lib.mpbqr_ninv_prof(prof.ctypes.data), "ninv_prof")
    n = ninv_layout(S.shape[0]).ctas
    return {name: [float(p[k]) / mhz for p in prof[:n]]
            for name, k in PHASES.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ninv_probe: no CUDA device", file=sys.stderr)
        return 2
    import mixedprecisionblockqr_tpu_torch as pkg
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build, ns

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
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
        with _build.instrumented_library("-DMPBQR_NINV_PROF",
                                         "mpbqr_ninv_prof", 1) as prof:
            for name, (S, it) in inputs.items():
                mhz = _sm_mhz()
                print(json.dumps({"k4": name, "iters": it, "sm_mhz": mhz,
                                  "phases_us": k4_phases(prof, S, it, mhz)}),
                      flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
