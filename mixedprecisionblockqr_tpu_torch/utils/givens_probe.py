"""The Givens chains G1-G3 alone on the card, against their plain versions
and a refactorization.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.givens_probe [--main]

Builds (or loads) the kernel library, then prints one JSON line per kernel
and shape from :func:`fold_row`, :func:`chain_row` and
:func:`hessenberg_row`: the error against the plain version (each output
within ``TOL`` of max|plain|), whether two launches agree bit for bit, the
kernel's time (CUDA events, median of 20, in place on one copy of the
inputs; G1's and G3's abort flag read once after them, so not timed), the plain version's (median of 3), the refactorization's (one
``torch.linalg.qr`` of the same data), the bounds of ``utils/bounds.py``,
and beside them the serial floor: the chain's dependent steps times one
step measured by :func:`chain_step`.
The shapes are ``chip_smoke.py`` phase 3's (:data:`PHASE3_SHAPES`): G1 at
n = 256, nb = 1 with 16, 8, 4, 2 and one rows (each of the kernel's five
row-slot layouts), and nb = 3 with 20 rows; G2 and G3 at m = n = 512, and
on a 300 x 120 factor (G2 from row 5).  With ``--main``, the same at
the shapes of phase 19's main path, n = 2048, with the plain version run
once and not timed.  The first line is the card's name and power limit
(nvidia-smi).  ``chip_smoke.py`` runs the same rows.  It needs a CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

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


def _compare(row, outs, again, refs):
    err, lim = _err(outs, refs)
    same = all(bool(torch.equal(a, b)) for a, b in zip(outs, again))
    row.update({"max_abs_err": err, "lim": lim, "bitwise_repeatable": same,
                "ok": err <= lim and same and all(
                    bool(torch.isfinite(o).all()) for o in outs)})


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
           "ctas": -(-(n + nb) // 32)}
    _compare(row, outs, again, refs)
    work, work_p = Raug.clone(), Raug.clone()
    _times(row, lambda: kernel(work, rows),
           lambda: givens_fold_rows_plain(work_p, rows),
           lambda: torch.linalg.qr(torch.cat([Raug, rows]), mode="r"),
           timed_plain)
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
           "ctas": -(-(n + m) // 32)}
    _compare(row, outs, again, refs)
    X1, X2, X1p, X2p = H.clone(), Qt.clone(), H.clone(), Qt.clone()
    _times(row, lambda: kernel(X1, X2),
           lambda: givens_hessenberg_plain(X1p, X2p),
           lambda: torch.linalg.qr(B), timed_plain)
    raise_on_abort(flag, "givens_hessenberg")
    row.update(givens_hessenberg_bound(m, n))
    return row


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
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
