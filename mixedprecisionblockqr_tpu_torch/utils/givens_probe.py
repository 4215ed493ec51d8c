"""The Givens chains G1-G3 alone on the card, against their plain versions
and a refactorization.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.givens_probe [--main]
        [--layouts] [--phases] [--compare]

Builds (or loads) the kernel library, then prints one JSON line per kernel
and shape from :func:`fold_row`, :func:`chain_row` and
:func:`hessenberg_row`: the error against the plain version (each output
within ``TOL`` of max|plain|; G1 and G3 also bit for bit), whether two
launches agree bit for bit, the kernel's time (CUDA events, median of 20,
in place on one copy of the inputs and, for G1 and G3, on fresh inputs;
their abort flag read once after them, so not timed), the plain version's
(median of 3), the refactorization's (one ``torch.linalg.qr`` of the same
data), the bounds of ``utils/bounds.py``, and beside them the serial
floor: the chain's dependent steps times one step measured by
:func:`chain_step`.  The shapes are ``chip_smoke.py`` phase 3's
(:data:`PHASE3_SHAPES`): G1 at n = 256, nb = 1 with 16, 8, 4, 2 and one
rows (each of the kernel's five row-slot layouts), and nb = 3 with 20
rows; G2 and G3 at m = n = 512, and on a 300 x 120 factor (G2 from row 5).
With ``--main``, the same at the shapes of phase 19's main path, n =
2048, with the plain version run once and not timed, and the end-of-call
abort-flag read timed (:func:`abort_read_rows`).  ``--layouts``: G3 at
other warps a CTA (:func:`layout_rows`); ``--phases``: G1's and G3's
step phases from their own clock (:func:`phase_rows`); ``--compare``:
only :func:`compare_rows`, through the public functions.  The first line
is the card's name and power limit (nvidia-smi).  ``chip_smoke.py`` runs
the same rows and the phases.  It needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

# The kernels round every operation as the plain versions do; what may
# differ is hypotf against torch.hypot's, so each output is held within
# 1e-5 of its largest plain entry.
TOL = 1e-5
# fold: (n, nb, k); chain: (m, n, start); hessenberg: (m, n).  Beside the
# main paths' shapes, phase 3 folds 8, 4 and 2 rows (the row-slot layouts
# fold_rows_kernel<8>, <4> and <2>; 16 and 1 are the main paths'), 20 rows
# (two blocks of the wavefront) into three right-hand sides, starts a chain
# at row 5 (qr_insert_col) and re-triangularizes a tall H (m - 1 > n:
# qr_delete_col's).
PHASE3_SHAPES = {"fold": ((256, 1, 16), (256, 1, 8), (256, 1, 4),
                          (256, 1, 2), (256, 1, 1), (256, 3, 20)),
                 "chain": ((512, 512, 0), (300, 120, 5)),
                 "hessenberg": ((512, 512), (300, 120))}
MAIN_SHAPES = {"fold": ((2048, 1, 16), (2048, 1, 1)),
               "chain": ((2048, 2048, 0),), "hessenberg": ((2048, 2048),)}


def _err(outs, refs):
    """max|out - ref| over the pairs and the limit TOL * max|ref|."""
    err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    return err, TOL * max(float(r.abs().max()) for r in refs)


def _compare(row, outs, again, refs, bitwise_plain=False):
    """Error against the plain version and repeatability; with
    ``bitwise_plain`` (G1, G3) ``ok`` also needs the kernel's outputs equal
    to the plain version's bit for bit."""
    err, lim = _err(outs, refs)
    same = all(bool(torch.equal(a, b)) for a, b in zip(outs, again))
    plain = all(bool(torch.equal(a, b)) for a, b in zip(outs, refs))
    row.update({"max_abs_err": err, "lim": lim, "bitwise_repeatable": same,
                "bitwise_plain": plain,
                "ok": err <= lim and same and (plain or not bitwise_plain)
                and all(bool(torch.isfinite(o).all()) for o in outs)})


def _times(row, kernel, plain, library, timed_plain):
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    row["ms"] = cuda_time_ms(kernel)
    row["plain_ms"] = (cuda_time_ms(plain, warmup=1, iters=3)
                       if timed_plain else None)
    row["library_ms"] = cuda_time_ms(library)


def _factors(m, n, gen):
    """Complete Q, R of a uniform m x n matrix, with Q^T."""
    A = torch.rand((m, n), generator=gen, device=gen.device) - 0.5
    Q, R = torch.linalg.qr(A, mode="complete")
    return A, Q.contiguous(), R.contiguous(), Q.T.contiguous()


def fold_row(n: int, nb: int, k: int, gen: torch.Generator,
             timed_plain: bool = True) -> dict:
    """G1: k standard normal rows of width n + nb folded into ``[R | qtb]``,
    R the triangular factor of a uniform 2n x n matrix, qtb normal;
    compared over R's upper triangle and qtb.  Library:
    ``torch.linalg.qr(cat([Raug, rows]), mode='r')``."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import (
        abort_flag,
        fold_layout,
        givens_fold_rows,
        givens_fold_rows_plain,
        raise_on_abort,
    )
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        givens_fold_bound,
    )

    dev = gen.device
    A = torch.rand((2 * n, n), generator=gen, device=dev) - 0.5
    R = torch.linalg.qr(A, mode="r")[1]
    qtb = torch.randn((n, nb), generator=gen, device=dev)
    Raug = torch.cat([R, qtb], dim=1).contiguous()
    rows = torch.randn((k, n + nb), generator=gen, device=dev)

    def run(fn, X):
        X = X.clone()
        fn(X, rows)
        return [torch.triu(X[:, :n]), X[:, n:]]

    flag = abort_flag(dev)

    def kernel(X, r):
        givens_fold_rows(X, r, flag)

    outs = run(kernel, Raug)
    again = run(kernel, Raug)
    refs = run(givens_fold_rows_plain, Raug)
    torch.cuda.synchronize()
    row = {"kernel": "givens_fold_rows", "n": n, "nb": nb, "k": k,
           "layout": fold_layout(n, n + nb, k)._asdict()}
    _compare(row, outs, again, refs, bitwise_plain=True)
    work, work_p = Raug.clone(), Raug.clone()
    _times(row, lambda: kernel(work, rows),
           lambda: givens_fold_rows_plain(work_p, rows),
           lambda: torch.linalg.qr(torch.cat([Raug, rows]), mode="r"),
           timed_plain)
    row["ms_fresh"] = fresh_ms(lambda: kernel(work, rows),
                               lambda: work.copy_(Raug))
    raise_on_abort(flag, "givens_fold_rows")
    row.update(givens_fold_bound(n, nb, k))
    return row


def _rank1_inputs(m, n, gen):
    A, Q, R, Qt = _factors(m, n, gen)
    u = torch.randn(m, generator=gen, device=gen.device)
    v = torch.randn(n, generator=gen, device=gen.device)
    w = (Q.T @ u).contiguous()
    return A + torch.outer(u, v), R, Qt, w, v


def chain_row(m: int, n: int, start: int, gen: torch.Generator,
              timed_plain: bool = True) -> dict:
    """G2 as ``qr_rank1_update``'s first chain (from row ``start``): w = Q^T
    u of a uniform m x n matrix's complete factors, applied to R and Q^T;
    compared over R, Q^T and the rotated w[start].  Library:
    ``torch.linalg.qr`` of A + u v^T (the refactorization the update
    replaces)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import (
        CHAIN_COLS,
        givens_chain,
        givens_chain_plain,
    )
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        givens_chain_bound,
    )

    B, R, Qt, w, _ = _rank1_inputs(m, n, gen)

    def run(fn):
        X1, X2 = R.clone(), Qt.clone()
        w0 = fn(w, X1, X2, start)
        return [X1, X2, w0.reshape(1)]

    outs, again, refs = run(givens_chain), run(givens_chain), run(
        givens_chain_plain)
    torch.cuda.synchronize()
    row = {"kernel": "givens_chain", "m": m, "n": n, "start": start,
           "ctas": -(-(n + m) // CHAIN_COLS)}
    _compare(row, outs, again, refs)
    X1, X2, X1p, X2p = R.clone(), Qt.clone(), R.clone(), Qt.clone()
    _times(row, lambda: givens_chain(w, X1, X2, start),
           lambda: givens_chain_plain(w, X1p, X2p, start),
           lambda: torch.linalg.qr(B), timed_plain)
    row.update(givens_chain_bound(m, n, start))
    return row


def hessenberg_row(m: int, n: int, gen: torch.Generator,
                   timed_plain: bool = True) -> dict:
    """G3 as ``qr_rank1_update``'s second chain: the upper Hessenberg H =
    (G2's R) + w0 e_0 v^T of a uniform m x n matrix's complete factors and
    G2's Q^T; compared over H's upper triangle and Q^T.  Library:
    ``torch.linalg.qr`` of A + u v^T."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import (
        abort_flag,
        givens_chain,
        givens_hessenberg,
        givens_hessenberg_plain,
        hessenberg_layout,
        raise_on_abort,
    )
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        givens_hessenberg_bound,
    )

    B, R, Qt, w, v = _rank1_inputs(m, n, gen)
    H, Qt = R.clone(), Qt.clone()
    H[0, :] += givens_chain(w, H, Qt, 0) * v

    def run(fn):
        X1, X2 = H.clone(), Qt.clone()
        fn(X1, X2)
        return [torch.triu(X1), X2]

    flag = abort_flag(gen.device)

    def kernel(X1, X2):
        givens_hessenberg(X1, X2, flag)

    outs, again, refs = run(kernel), run(kernel), run(givens_hessenberg_plain)
    torch.cuda.synchronize()
    row = {"kernel": "givens_hessenberg", "m": m, "n": n,
           "layout": hessenberg_layout(m, n, m)._asdict()}
    _compare(row, outs, again, refs, bitwise_plain=True)
    X1, X2, X1p, X2p = H.clone(), Qt.clone(), H.clone(), Qt.clone()
    _times(row, lambda: kernel(X1, X2),
           lambda: givens_hessenberg_plain(X1p, X2p),
           lambda: torch.linalg.qr(B), timed_plain)
    row["ms_fresh"] = fresh_ms(lambda: kernel(X1, X2),
                               lambda: (X1.copy_(H), X2.copy_(Qt)))
    kernel(X1, X2)  # in place: the subdiagonal holds the last call's residue
    sub = torch.diagonal(X1, -1)
    tiny = torch.finfo(torch.float32).tiny
    row["in_place_subdiag"] = {
        "denormal": int(((sub != 0) & (sub.abs() < tiny)).sum()),
        "zero": int((sub == 0).sum()),
        "median_abs": float(sub.abs().median()),
        "fresh_median_abs": float(torch.diagonal(H, -1).abs().median())}
    raise_on_abort(flag, "givens_hessenberg")
    row.update(givens_hessenberg_bound(m, n))
    return row


def fresh_ms(kernel, reset, warmup: int = 3, iters: int = 20) -> float:
    """Median device ms of ``kernel()`` (CUDA events) with ``reset()`` (a
    copy of the pristine inputs) enqueued before each call, outside the
    events."""
    for _ in range(warmup):
        reset()
        kernel()
    times = []
    for _ in range(iters):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kernel()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(fn, iters: int = 20) -> float:
    """Median host ms of ``fn()`` (which ends synchronized)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def abort_read_rows(gen: torch.Generator) -> dict:
    """The end-of-call abort-flag read on the host: G1 (n = 2048, 16 rows)
    and G3 (2048^2), each call in place, host ms (median of 20) of the
    wrapper with its read (``abort`` None: ``.item()``), of the same launch
    with a flag of the caller's and one ``torch.cuda.synchronize()``, and
    of 20 launches queued back to back and synchronized once, per call."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import (
        abort_flag,
        givens_chain,
        givens_fold_rows,
        givens_hessenberg,
        raise_on_abort,
    )

    dev = gen.device
    n = 2048
    A = torch.rand((2 * n, n), generator=gen, device=dev) - 0.5
    Raug = torch.cat([torch.linalg.qr(A, mode="r")[1],
                      torch.randn((n, 1), generator=gen, device=dev)],
                     dim=1).contiguous()
    rows_ = torch.randn((16, n + 1), generator=gen, device=dev)
    _, R, Qt, w, v = _rank1_inputs(n, n, gen)
    H = R.clone()
    H[0, :] += givens_chain(w, H, Qt, 0) * v
    out = {}
    for name, call in (
            ("fold_n2048_k16", lambda f: givens_fold_rows(Raug, rows_, f)),
            ("hessenberg_m2048", lambda f: givens_hessenberg(H, Qt, f))):
        flag = abort_flag(dev)

        def queued():
            for _ in range(20):
                call(flag)
            torch.cuda.synchronize()

        out[name] = {
            "host_ms_read": _host_ms(lambda: call(None)),
            "host_ms_sync": _host_ms(
                lambda: (call(flag), torch.cuda.synchronize())),
            "host_ms_queued": _host_ms(queued, iters=5) / 20}
        raise_on_abort(flag, name)
    return out


def compare_rows(gen: torch.Generator) -> dict:
    """G1 and G3 at the main shapes and their two public callers, through
    the public functions only, so that the same code times another tree's
    package (``PYTHONPATH=<tree> python3 -P <this file> --compare``;
    ``-P`` keeps this file's directory, where ``logging.py`` would shadow
    the standard library's, off ``sys.path``): CUDA-event
    medians of 20 of G1 (n = 2048, 16 rows and one) and G3 (2048^2) in place
    and on fresh inputs, and of ``rls_update`` (16 rows into a 2048 state)
    and ``qr_rank1_update`` (2048^2), with their host walls (median of 20,
    each call synchronized)."""
    import mixedprecisionblockqr_tpu_torch as pkg
    from mixedprecisionblockqr_tpu_torch import qr_rank1_update
    from mixedprecisionblockqr_tpu_torch.models.lstsq import (
        RLSState,
        rls_update,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import (
        abort_flag,
        givens_chain,
        givens_fold_rows,
        givens_hessenberg,
        raise_on_abort,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    dev, n = gen.device, 2048
    flag = abort_flag(dev)
    A = torch.rand((2 * n, n), generator=gen, device=dev) - 0.5
    R = torch.linalg.qr(A, mode="r")[1].contiguous()
    Raug = torch.cat([R, torch.randn((n, 1), generator=gen, device=dev)],
                     dim=1).contiguous()
    out = {"package": pkg.__file__}
    for k in (16, 1):
        rows_ = torch.randn((k, n + 1), generator=gen, device=dev)
        work = Raug.clone()
        out[f"fold_n{n}_k{k}"] = {
            "ms": cuda_time_ms(lambda: givens_fold_rows(work, rows_, flag)),
            "ms_fresh": fresh_ms(lambda: givens_fold_rows(work, rows_, flag),
                                 lambda: work.copy_(Raug))}
    _, Rs, Qt, w, v = _rank1_inputs(n, n, gen)
    H = Rs.clone()
    H[0, :] += givens_chain(w, H, Qt, 0) * v
    X1, X2 = H.clone(), Qt.clone()
    out[f"hessenberg_m{n}"] = {
        "ms": cuda_time_ms(lambda: givens_hessenberg(X1, X2, flag)),
        "ms_fresh": fresh_ms(lambda: givens_hessenberg(X1, X2, flag),
                             lambda: (X1.copy_(H), X2.copy_(Qt)))}
    raise_on_abort(flag, "compare")
    st = RLSState(R, torch.randn(n, generator=gen, device=dev))
    rows16 = torch.randn((16, n), generator=gen, device=dev)
    betas = torch.randn(16, generator=gen, device=dev)
    Q, Rf = torch.linalg.qr(torch.rand((n, n), generator=gen, device=dev)
                            - 0.5, mode="complete")
    u = torch.randn(n, generator=gen, device=dev) * 1e-3
    vv = torch.randn(n, generator=gen, device=dev) * 1e-3
    for name, fn in (("rls_update_16_n2048", lambda: rls_update(
            st, rows16, betas)), ("qr_rank1_update_2048", lambda:
                                  qr_rank1_update(Q, Rf, u, vv))):
        out[name] = {"ms": cuda_time_ms(fn),
                     "wall_ms": _host_ms(lambda: (fn(),
                                                  torch.cuda.synchronize()))}
    return out


def chain_step(gen: torch.Generator, lengths=(64, 4096)) -> dict:
    """One dependent step of a rotation chain, measured: G2 with one column
    in X1 and one in X2 at two lengths m, where the coefficients (one
    thread, each waiting for the one before: a hypot, two divisions and a
    rotation) set the time.  ``step_ms`` is the difference of the two
    times over the difference of the steps; ``serial_steps`` times it is
    a chain's latency floor."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import (
        givens_chain,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    dev = gen.device
    ms = []
    for m in lengths:
        v = torch.randn(m, generator=gen, device=dev)
        X1 = torch.randn((m, 1), generator=gen, device=dev)
        X2 = torch.randn((m, 1), generator=gen, device=dev)
        ms.append(cuda_time_ms(lambda: givens_chain(v, X1, X2)))
    return {"lengths": list(lengths), "ms": ms,
            "step_ms": (ms[1] - ms[0]) / (lengths[1] - lengths[0])}


#: Slots of the kernels' phase clocks (csrc/givens.cu, kGp*): each warp's
#: steps split into front steps (it makes a coefficient) and follower
#: steps, each into making the coefficient, handing it on inside the warp
#: or CTA, waiting on another CTA, applying it, the CTA barrier and waiting
#: on another warp of the CTA.
PHASE_SLOTS = {"make": 0, "hand_on": 1, "wait_cta": 2, "apply": 3,
               "barrier": 4, "wait_warp": 5}
STEPS_SLOT, FOLLOW, TOTAL_SLOT, PROF_WARPS, PROF_SLOTS = 6, 8, 15, 2048, 18
#: Each warp's %globaltimer (ns) at its first and last front step.
FIRST_SLOT, LAST_SLOT = 16, 17
#: The clock build: its macro, its extra C entry and its arguments, and the
#: one source it compiles (``_build.instrumented_library``).
PROF_BUILD = ("-DMPBQR_GIVENS_PROF", "mpbqr_givens_prof", 1, ("givens.cu",))
#: --phases: G1 at n = 2048 with 16 rows and one (rls_update's and
#: qr_append_row's), G3 at 2048^2 (qr_rank1_update's).
PHASE_SHAPES = {"fold": ((2048, 1, 16), (2048, 1, 1)),
                "hessenberg": ((2048, 2048),)}


def phase_summary(prof, warps: int, mhz: float) -> dict:
    """One launch's clocks (``PROF_WARPS`` x ``PROF_SLOTS``, its first
    ``warps`` rows) as cycles a step and shares by phase, for front and
    follower steps; ``kernel_us`` is the longest warp's clock."""
    p = [[int(x) for x in row] for row in prof[:warps]]
    out = {"sm_mhz": mhz,
           "kernel_us": max(row[TOTAL_SLOT] for row in p) / mhz}
    # The front's timeline: each front warp's span (first to last front
    # step) and the gap from one front warp's last step to the next's
    # first, in us of the global timer.
    spans = sorted((row[FIRST_SLOT], row[LAST_SLOT]) for row in p
                   if row[STEPS_SLOT] > 0 and row[FIRST_SLOT] > 0)
    if spans:
        gaps = [b[0] - a[1] for a, b in zip(spans, spans[1:])]
        out["front_timeline_us"] = {
            "front_warps": len(spans),
            "first_to_last": (spans[-1][1] - spans[0][0]) / 1e3,
            "in_front_warps": sum(b - a for a, b in spans) / 1e3,
            "between_front_warps": sum(gaps) / 1e3,
            "largest_gap": max(gaps, default=0) / 1e3}
    for role, off in (("front", 0), ("follower", FOLLOW)):
        steps = sum(row[STEPS_SLOT + off] for row in p)
        cyc = {name: sum(row[k + off] for row in p)
               for name, k in PHASE_SLOTS.items()}
        total = sum(cyc.values())
        out[role] = {
            "warp_steps": steps,
            "cycles_per_step": {k: v / max(steps, 1) for k, v in cyc.items()},
            "shares": {k: v / max(total, 1) for k, v in cyc.items()},
            "us_per_warp": total / mhz / max(warps, 1)}
    return out


def _read_prof(lib):
    import numpy as np

    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check

    torch.cuda.synchronize()
    prof = np.zeros((PROF_WARPS, PROF_SLOTS), np.int64)
    check(lib.mpbqr_givens_prof(prof.ctypes.data), "givens_prof")
    return prof


def phase_rows(lib, gen: torch.Generator, mhz: float,
               shapes=PHASE_SHAPES, warps=None) -> dict:
    """G1 and G3 through the clock build ``lib``: each shape launched on a
    copy of its fresh inputs and then again in place on the result, the
    clocks of each launch summarized (:func:`phase_summary`), with whether
    the fresh launch's outputs equal the kernel library's bit for bit
    (``same_as_library``); with ``warps`` (as ``LAYOUT_WARPS``) G3 also at
    those warps a CTA."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check,
        library,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import (
        abort_flag,
        fold_layout,
        givens_chain,
        hessenberg_layout,
        launch_fold_rows,
        launch_hessenberg,
        raise_on_abort,
    )

    dev = gen.device
    cases = []
    for n, nb, k in shapes["fold"]:
        A = torch.rand((2 * n, n), generator=gen, device=dev) - 0.5
        Raug = torch.cat([torch.linalg.qr(A, mode="r")[1],
                          torch.randn((n, nb), generator=gen, device=dev)],
                         dim=1).contiguous()
        rows_ = torch.randn((k, n + nb), generator=gen, device=dev)
        cases.append((f"fold_n{n}_k{k}", fold_layout(n, n + nb, k),
                      lambda lb, X, f, lay, r=rows_: launch_fold_rows(
                          lb, X, r, f), (Raug,)))
    for m, n in shapes["hessenberg"]:
        _, R, Qt, w, v = _rank1_inputs(m, n, gen)
        H = R.clone()
        H[0, :] += givens_chain(w, H, Qt, 0) * v
        name = f"hessenberg_m{m}"
        for wp in (None,) + tuple((warps or {}).get(name, ())):
            cases.append((name if wp is None else f"{name}_w{wp}",
                          hessenberg_layout(m, n, m, wp),
                          lambda lb, X1, X2, f, lay: launch_hessenberg(
                              lb, X1, X2, f, lay), (H, Qt)))
    out = {}
    for name, lay, launch, inputs in cases:
        flag = abort_flag(dev)
        ref = [x.clone() for x in inputs]
        check(launch(library(), *ref, flag, None), name)
        work = [x.clone() for x in inputs]
        for when in ("fresh", "in_place"):
            check(launch(lib, *work, flag, lay), name)
            row = phase_summary(_read_prof(lib), lay.total_warps, mhz)
            if when == "fresh":
                row["same_as_library"] = all(
                    bool(torch.equal(a, b)) for a, b in zip(work, ref))
            out[f"{name}_{when}"] = {"layout": lay._asdict(), **row}
        raise_on_abort(flag, name)
    return out


#: --layouts: warps a CTA tried beside the rule's at the main shapes.
LAYOUT_WARPS = {"hessenberg_m2048": (1, 2, 4, 8)}


def layout_rows(gen: torch.Generator) -> dict:
    """G3 (2048^2) at each of ``LAYOUT_WARPS``' warps a CTA: CUDA-event
    median of 20 in place and on fresh inputs, and whether the outputs equal
    the rule's layout's bit for bit."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import (
        abort_flag,
        check_launch,
        givens_chain,
        hessenberg_layout,
        launch_hessenberg,
        raise_on_abort,
    )
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    dev, lib, n = gen.device, library(), 2048
    flag = abort_flag(dev)
    _, R, Qt, w, v = _rank1_inputs(n, n, gen)
    H = R.clone()
    H[0, :] += givens_chain(w, H, Qt, 0) * v
    cases = {}

    def hess(lay, X1, X2):
        check_launch(launch_hessenberg(lib, X1, X2, flag, lay), "hess")

    cases[f"hessenberg_m{n}"] = (
        lambda wp: hessenberg_layout(n, n, n, wp), hess, (H, Qt))
    out = {}
    for name, (layout, run, inputs) in cases.items():
        ref = [x.clone() for x in inputs]
        run(layout(None), *ref)
        for wp in LAYOUT_WARPS[name]:
            lay = layout(wp)
            got = [x.clone() for x in inputs]
            run(lay, *got)
            work = [x.clone() for x in inputs]
            out[f"{name}_w{wp}"] = {
                "layout": lay._asdict(), "rule": lay == layout(None),
                "bitwise_rule": all(bool(torch.equal(a, b))
                                    for a, b in zip(got, ref)),
                "ms": cuda_time_ms(lambda: run(lay, *work)),
                "ms_fresh": fresh_ms(
                    lambda: run(lay, *work),
                    lambda: [x.copy_(y) for x, y in zip(work, inputs)])}
    raise_on_abort(flag, "layouts")
    return out


def _sm_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def rows(shapes, gen, timed_plain=True):
    """Every row of ``shapes`` (as ``PHASE3_SHAPES``), keyed by name."""
    out = {}
    for n, nb, k in shapes["fold"]:
        out[f"fold_n{n}_k{k}"] = fold_row(n, nb, k, gen, timed_plain)
    for m, n, start in shapes["chain"]:
        name = f"chain_m{m}" + ("" if (n, start) == (m, 0)
                                else f"_n{n}_start{start}")
        out[name] = chain_row(m, n, start, gen, timed_plain)
    for m, n in shapes["hessenberg"]:
        name = f"hessenberg_m{m}" + ("" if n == m else f"_n{n}")
        out[name] = hessenberg_row(m, n, gen, timed_plain)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--main", action="store_true",
                    help="also the main path's shapes (n = 2048)")
    ap.add_argument("--compare", action="store_true",
                    help="only the public-function timings of "
                    "compare_rows (run it with another tree on PYTHONPATH "
                    "to time that tree's kernels)")
    ap.add_argument("--layouts", action="store_true",
                    help="also G3 at 2048^2 with other warps a CTA than the "
                    "rule's")
    ap.add_argument("--phases", action="store_true",
                    help="also G1's and G3's step phases from their own "
                    "clock (a second build with -DMPBQR_GIVENS_PROF)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("givens_probe: no CUDA device", file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.library()
    print(json.dumps({"build_seconds": _build.build_seconds}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.compare:
        print(json.dumps({"compare": compare_rows(gen), "card": smi}),
              flush=True)
        return 0
    step = chain_step(gen)
    print(json.dumps({"chain_step": step, "card": smi}), flush=True)
    ok = True
    plans = [(PHASE3_SHAPES, True)] + ([(MAIN_SHAPES, False)]
                                       if args.main else [])
    for shapes, timed in plans:
        for name, row in rows(shapes, gen, timed).items():
            ok = ok and row["ok"]
            print(json.dumps({"row": name, **row, "serial_floor_ms":
                              row["serial_steps"] * step["step_ms"],
                              "card": smi}), flush=True)
    if args.main:
        print(json.dumps({"abort_read": abort_read_rows(gen), "card": smi}),
              flush=True)
    if args.layouts:
        for name, row in layout_rows(gen).items():
            ok = ok and row["bitwise_rule"]
            print(json.dumps({"layout_row": name, **row, "card": smi}),
                  flush=True)
    if args.phases:
        with _build.instrumented_library(*PROF_BUILD) as prof:
            for name, row in phase_rows(
                    prof, gen, _sm_mhz(),
                    warps=LAYOUT_WARPS if args.layouts else None).items():
                print(json.dumps({"phases": name, **row, "card": smi}),
                      flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
