"""K1 ``ns_chain`` alone on the card, with its phases from its own clock.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.ns_probe [--phases]
        [--callers] [--l2]

Builds (or loads) the kernel library and prints JSON lines.  The first
line is the card's name and power limit (nvidia-smi).  Then:

* one line per option set of :data:`OPTION_SETS` (r = 128 plain 10
  iterations, ``chain_mid`` 6, ``shift`` 14, ``refine`` 4; ``chain_mid`` at
  r = 64 and 32; on the L2 route r = 256 plain 10, ``chain_mid`` 6,
  ``shift`` 14, ``refine`` 4 and ``chain_mid`` at r = 192 and 512; with
  ``--l2`` only these): the kernel's time (CUDA events, median of 20,
  around one launch as ``chip_smoke.py`` phase 3 times it, and
  ``loop_ms``: around :data:`LOOP` launches back to back, over LOOP), its
  error
  against ``ns_chain_plain`` (limit 1e-4 of max|plain|), beside
  ``torch.linalg.cholesky(G)`` (``library_ms``) and beside the cholesky
  followed by the triangular inverse (``library_inverse_ms``:
  ``solve_triangular`` of L^T against I; K1 forms X = R^-1 too), and the
  bound of ``utils/bounds.py``;
* one line per stack of :data:`BATCHED` (``ns_chain_batched``, 8 and 16
  members at r = 128, 4 and 8 at 256): ``batched_probe.k1_batched_row``,
  with the same yardsticks on the stack;
* with ``--callers``, one line each for the kernels whose chains run K1's
  body: K2 (``bgs_group_fused``) 2048 x 1024 g8 bgs1, K2 over a batch
  8 x 2048 x 512 bgs1 with a robust last panel, K3 (``panel_qr_fused``)
  4096 x 128 robust, and on the L2 route K2 2048 x 1024 g4 bgs1 at r =
  256 and K3 4096 x 256 robust;
* with ``--phases``, the kernel library's K1 built a second time with
  ``-DMPBQR_NS_PROF`` (``_build.instrumented_library``, ``ns_chain.cu``
  alone, ~15 s); one launch of each option set from it gives a line: per
  slot of :data:`SLOTS`, the cycles of CTA thread 0 (mean over the
  cluster's CTAs), its share of the launch, its cycles an iteration, and
  one cluster exchange (:func:`phase_table`), in cycles and in time at
  the card's maximum SM clock (``nvidia-smi`` ``clocks.max.sm``: the least
  time those cycles take, whatever clock the card ran at), beside the SM
  clock that ``nvidia-smi`` reads after the launches; above r = 128 the
  L2 route's own slots (:data:`L2_SLOTS`, 16 CTAs, each CTA's cycles in
  ``per_cta``) and one barrier as its exchange.  One exchange gives
  each option set's serial floor (``bounds.ns_chain_bound(...,
  exchange_ms=...)``): the current design's exchange cost, which moves
  with the kernel, not a floor of the function.

It runs whichever ``mixedprecisionblockqr_tpu_torch`` Python imports, so a
parent tree is timed in the same call with this file:
``PYTHONPATH=<parent tree> python3 -P <this file>`` (without ``--phases``,
whose clock build only this tree has).  It needs a CUDA device and
``nvcc``; without a device it exits 2, and 1 when a check fails.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys

import torch

TOL = 1e-4
#: Launches back to back in one ``loop_ms`` timing (the device's time a
#: launch, with the host's issue hidden behind the kernels before it).
LOOP = 20
#: The clock build: macro, its read-out entry (two pointers: the
#: shared-memory route's record and the L2 route's), the source.
PROF_BUILD = ("-DMPBQR_NS_PROF", "mpbqr_ns_prof", 2, ("ns_chain.cu",))
#: Rows of the clock records (csrc/ns_chain.cuh::g_ns_prof and
#: g_ns_l2_prof): CTAs of each route's largest cluster, {launch,
#: iterations}.
PROF_CTAS = 8
L2_PROF_CTAS = 16
#: The slots of K1's clock, in the order of csrc/ns_chain.cuh's NSP_*.
SLOTS = ("setup", "gather_X", "gather_W", "barrier", "w_product",
         "correction", "gather_C", "update", "close_t", "cluster_max")
#: The slots an iteration runs; they add up to the iteration.
LOOP_SLOTS = ("gather_X", "gather_W", "barrier", "w_product", "correction",
              "gather_C", "update")
#: The slots of a cluster exchange: the all-gathers' stores and the wait.
EXCHANGE_SLOTS = ("gather_X", "gather_W", "gather_C", "barrier")
#: The slots of the L2 route's clock, in the order of NSL_*; those an
#: iteration runs; and its exchange: the barrier with its __threadfence.
L2_SLOTS = ("setup", "w_product", "correction", "x_update", "w_update",
            "barrier", "close_t", "x_store", "cluster_max")
L2_LOOP_SLOTS = ("w_product", "correction", "x_update", "w_update",
                 "barrier")
L2_EXCHANGE_SLOTS = ("barrier",)
#: name -> (r, Gram kind, options); the kinds as batched_probe.k1_stack
#: makes them.
OPTION_SETS = {
    "plain": (128, "well", dict(iters=10)),
    "chain_mid": (128, "well", dict(iters=6, chain_mid=True)),
    "shift": (128, "ill", dict(iters=14, shift=1e-3)),
    "refine": (128, "near_identity", dict(iters=4, refine=True)),
    "chain_mid_r64": (64, "well", dict(iters=6, chain_mid=True)),
    "chain_mid_r32": (32, "well", dict(iters=6, chain_mid=True)),
    "l2_plain": (256, "well", dict(iters=10)),
    "l2_chain_mid": (256, "well", dict(iters=6, chain_mid=True)),
    "l2_shift": (256, "ill", dict(iters=14, shift=1e-3)),
    "l2_refine": (256, "near_identity", dict(iters=4, refine=True)),
    "l2_chain_mid_r192": (192, "well", dict(iters=6, chain_mid=True)),
    "l2_chain_mid_r512": (512, "well", dict(iters=6, chain_mid=True)),
}
#: name -> (B, r, Gram kind, options) of the batched entry.
BATCHED = {
    "8x128_chain_mid": (8, 128, "well", dict(iters=6, chain_mid=True)),
    "8x128_plain": (8, 128, "well", dict(iters=10)),
    "16x128_chain_mid": (16, 128, "well", dict(iters=6, chain_mid=True)),
    "16x128_plain": (16, 128, "well", dict(iters=10)),
    "4x256_chain_mid": (4, 256, "well", dict(iters=6, chain_mid=True)),
    "8x256_chain_mid": (8, 256, "well", dict(iters=6, chain_mid=True)),
}


def loop_exchanges(iters: int) -> int:
    """Cluster exchanges inside the iterations of the fused schedule:
    ``bounds.ns_chain_exchanges`` without the closing X's."""
    from mixedprecisionblockqr_tpu_torch.utils.bounds import (
        ns_chain_exchanges,
    )

    return ns_chain_exchanges(iters) - 1


def phase_table(raw, ctas: int, iters: int, mhz: float,
                l2: bool = False) -> dict:
    """K1's clock record ``raw`` ((PROF_CTAS, 2, len(SLOTS)) cycles: row 0
    the launch, row 1 the iterations alone; with ``l2`` the L2 route's
    (L2_PROF_CTAS, 2, len(L2_SLOTS))) of a launch on ``ctas`` CTAs with
    ``iters`` iterations, at ``mhz``, as a table: per slot the mean cycles
    over the CTAs, their share of the launch, the cycles an iteration (the
    iterations' slots only) and microseconds; ``per_cta``: each CTA's
    launch and each slot's cycles CTA by CTA (the imbalance shows there);
    the launch (the slowest CTA's sum) and the iteration (mean); and
    ``exchange_cycles``: one cluster exchange, the least over the CTAs of
    the iterations' exchange slots over their exchanges (the CTA that
    arrives last waits least): the all-gathers and barriers of
    :func:`loop_exchanges`, or on the L2 route the one barrier an
    iteration."""
    slots, loop, exch = ((L2_SLOTS, L2_LOOP_SLOTS, L2_EXCHANGE_SLOTS) if l2
                         else (SLOTS, LOOP_SLOTS, EXCHANGE_SLOTS))
    rows = [[[int(c) for c in raw[p][h]] for h in range(2)]
            for p in range(ctas)]
    launch = [sum(rows[p][0]) for p in range(ctas)]
    mean_launch = sum(launch) / ctas
    out = {"route": "l2" if l2 else "smem", "ctas": ctas, "iters": iters,
           "sm_mhz": mhz, "launch_cycles": max(launch),
           "launch_us": max(launch) / mhz, "slots": {},
           "per_cta": {"launch": launch}}
    for k, name in enumerate(slots):
        cyc = sum(rows[p][0][k] for p in range(ctas)) / ctas
        row = {"cycles": cyc, "share": cyc / mean_launch if mean_launch
               else 0.0, "us": cyc / mhz}
        if name in loop and iters:
            row["per_iteration"] = sum(rows[p][1][k]
                                       for p in range(ctas)) / ctas / iters
        out["slots"][name] = row
        out["per_cta"][name] = [rows[p][0][k] for p in range(ctas)]
    out["iteration_cycles"] = (sum(sum(rows[p][1]) for p in range(ctas))
                               / ctas / iters) if iters else 0.0
    n_ex = iters if l2 else loop_exchanges(iters)
    ex = min(sum(rows[p][1][slots.index(s)] for s in exch)
             for p in range(ctas)) / n_ex if n_ex else 0.0
    out["exchange_cycles"] = ex
    out["exchange_us"] = ex / mhz
    return out


def grams(gen: torch.Generator, dev: torch.device) -> dict:
    """(kind, r) -> Gram of each option set of :data:`OPTION_SETS`: the
    one member of ``batched_probe.k1_stack(kind, 1, r)``, made as the
    batched rows' stacks are."""
    from mixedprecisionblockqr_tpu_torch.utils.batched_probe import k1_stack

    return {(kind, r): k1_stack(kind, 1, r, gen, dev)[0]
            for r, kind, _ in OPTION_SETS.values()}


def cholesky_inverse(G: torch.Tensor) -> torch.Tensor:
    """The library's R^-1 of G = R^T R: ``torch.linalg.cholesky`` and the
    triangular inverse of its R = L^T (``solve_triangular`` against I)."""
    L = torch.linalg.cholesky(G)
    eye = torch.eye(G.shape[-1], device=G.device).expand_as(G)
    return torch.linalg.solve_triangular(L.mT, eye, upper=True)


def kernel_row(G: torch.Tensor, kw: dict, exchange_ms=None) -> dict:
    """K1 on G with the options ``kw``: error against the plain version,
    two launches bit for bit, time, the library yardsticks, the bound
    (with the serial floor when ``exchange_ms`` is known)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        ns_chain,
        ns_chain_plain,
    )
    from mixedprecisionblockqr_tpu_torch.utils.bounds import ns_chain_bound
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    X, t, res = ns_chain(G, **kw)
    again = ns_chain(G, **kw)
    Xp, tp, resp = ns_chain_plain(G, **kw)
    torch.cuda.synchronize()
    err = max(float((X - Xp).abs().max()), float((t - tp).abs().max()))
    lim = TOL * max(float(Xp.abs().max()), float(tp.abs().max()))
    same = all(bool(torch.equal(a, b)) for a, b in zip((X, t, res), again))
    row = {"r": G.shape[-1], "options": kw, "max_abs_err": err, "lim": lim,
           "bitwise_repeatable": same, "resid": float(res),
           "resid_plain": float(resp),
           "ok": err <= lim and same and (float(res) < 1e-4) == (
               float(resp) < 1e-4),
           "ms": cuda_time_ms(lambda: ns_chain(G, **kw)),
           "loop_ms": cuda_time_ms(lambda: [ns_chain(G, **kw)
                                            for _ in range(LOOP)]) / LOOP,
           "library_ms": cuda_time_ms(lambda: torch.linalg.cholesky(G)),
           "library_inverse_ms": cuda_time_ms(lambda: cholesky_inverse(G))}
    floor = {} if exchange_ms is None else dict(exchange_ms=exchange_ms)
    if "shift" in inspect.signature(ns_chain_bound).parameters:
        floor["shift"] = bool(kw.get("shift"))  # an older tree has none
    row.update(ns_chain_bound(G.shape[-1], kw["iters"],
                              kw.get("chain_mid", False),
                              kw.get("refine", False), **floor))
    return row


def caller_rows(gen: torch.Generator, dev: torch.device) -> dict:
    """The kernels whose chains run K1's body, at the main paths' shapes:
    name -> {"ms"} (CUDA events, median of 20)."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        bgs_group_fused,
        bgs_group_fused_batched,
        panel_qr_fused,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    Pg = torch.rand((2048, 1024), generator=gen, device=dev) - 0.5
    Pb = torch.rand((8, 2048, 512), generator=gen, device=dev) - 0.5
    Pk = torch.rand((4096, 128), generator=gen, device=dev) - 0.5
    Pk2 = torch.rand((4096, 256), generator=gen, device=dev) - 0.5
    head = (12, 6, 6, 6, 6, 6, 6, 10)
    calls = {
        "k2_2048x1024_g8_bgs1": lambda: bgs_group_fused(
            Pg, 128, head, (False,) * 8, bf16_dots=True, chain_mid=True),
        "k2_batched_8x2048x512_bgs1": lambda: bgs_group_fused_batched(
            Pb, 128, (12, 6, 6, 10), (False, False, False, True),
            bf16_dots=True, chain_mid=True),
        "k3_4096x128_robust": lambda: panel_qr_fused(Pk, robust=True),
        # the L2 route's chains: the headline's group at block 256, K3 at
        # 256 (width_probe.py's k2_row and k3_row)
        "k2_2048x1024_g4_r256_bgs1": lambda: bgs_group_fused(
            Pg, 256, (12, 6, 6, 10), (False, False, False, True),
            bf16_dots=True, chain_mid=True),
        "k3_4096x256_robust": lambda: panel_qr_fused(Pk2, robust=True),
    }
    return {name: {"ms": cuda_time_ms(fn)} for name, fn in calls.items()}


def _sm_mhz(query: str = "clocks.max.sm") -> float:
    """The card's SM clock in MHz as ``nvidia-smi`` reads ``query``: by
    default its maximum, at which a count of cycles takes least time."""
    return float(subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def phase_rows(lib, G_of: dict, mhz: float, names=None) -> dict:
    """name -> :func:`phase_table` of one launch of each option set of
    :data:`OPTION_SETS` (or of ``names``) from the clock build ``lib``
    (after one launch to warm it) at ``mhz``, read from the record of the
    set's route, with the clock build's own time (CUDA events), the SM
    clock that ``nvidia-smi`` reads after it (``sm_mhz_read``) and whether
    its outputs equal the kernel library's bit for bit (the clock reads
    change no arithmetic) beside the table."""
    import numpy as np

    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        _launch_chain,
        ns_layout,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    out = {}
    for name in names or OPTION_SETS:
        r, kind, kw = OPTION_SETS[name]
        G = G_of[kind, r]
        args = (G, kw["iters"], kw.get("shift", 0.0), kw.get("refine", False),
                kw.get("chain_mid", False), kw.get("omega", True),
                kw.get("fuse_xw", True))
        ms = cuda_time_ms(lambda: _launch_chain(*args, lib=lib))
        mine = _launch_chain(*args)
        theirs = _launch_chain(*args, lib=lib)
        torch.cuda.synchronize()
        raw = np.zeros((PROF_CTAS, 2, len(SLOTS)), np.int64)
        raw_l2 = np.zeros((L2_PROF_CTAS, 2, len(L2_SLOTS)), np.int64)
        check(lib.mpbqr_ns_prof(raw.ctypes.data, raw_l2.ctypes.data),
              "ns_prof")
        lay = ns_layout(r)
        l2 = lay.route == "l2"
        out[name] = {**phase_table(raw_l2 if l2 else raw, lay.ctas,
                                   kw["iters"], mhz, l2=l2),
                     "r": r, "clock_build_ms": ms,
                     "sm_mhz_read": _sm_mhz("clocks.sm"),
                     "same_as_library": all(
                         bool(torch.equal(a, b))
                         for a, b in zip(mine, theirs))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--callers", action="store_true")
    ap.add_argument("--l2", action="store_true",
                    help="only the option sets and stacks above r = 128")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ns_probe: no CUDA device", file=sys.stderr)
        return 2
    import mixedprecisionblockqr_tpu_torch as pkg
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
    from mixedprecisionblockqr_tpu_torch.utils.batched_probe import (
        k1_batched_row,
        k1_stack,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    G_of = grams(gen, dev)
    tree = pkg.__file__
    sets = [n for n, (r, _, _) in OPTION_SETS.items()
            if r > 128 or not args.l2]
    stacks = [n for n, (_, r, _, _) in BATCHED.items()
              if r > 128 or not args.l2]
    exchange = {}
    if args.phases:
        with _build.instrumented_library(*PROF_BUILD) as prof:
            for name, row in phase_rows(prof, G_of, _sm_mhz(),
                                        sets).items():
                exchange[name] = row["exchange_us"] * 1e-3
                print(json.dumps({"tree": tree, "phases": name, **row,
                                  "card": smi}), flush=True)
    ok = True
    for name in sets:
        r, kind, kw = OPTION_SETS[name]
        row = kernel_row(G_of[kind, r], kw, exchange.get(name))
        ok = ok and row["ok"]
        print(json.dumps({"tree": tree, "k1": name, **row, "card": smi}),
              flush=True)
    for name in stacks:
        B, r, kind, kw = BATCHED[name]
        row = k1_batched_row(k1_stack(kind, B, r, gen, dev), kw)
        ok = ok and row["ok"]
        print(json.dumps({"tree": tree, "k1_batched": name, **row,
                          "card": smi}), flush=True)
    if args.callers:
        print(json.dumps({"tree": tree, "callers": caller_rows(gen, dev),
                          "card": smi}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
