"""K2 ``bgs_group_fused`` alone on the card at the headline's group, with
its device kernels, the products it issues, and K3 beside it.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.group_probe \
        [--serial] [--k5-seeds N]

Builds (or loads) the kernel library and prints JSON lines.  The first line
is the card's name and power limit (nvidia-smi).  Then:

* one line per configuration of :data:`CONFIGS` (the bf16 flags with
  ``chain_mid`` or the fp32 flags, with or without a robust last panel:
  ``chip_smoke.py`` phase 3's four) on the headline's group (2048 x 1024,
  r = 128, g = 8, :data:`ITERS`): the kernel's time (CUDA events, median
  of 20) and, from ``torch.profiler`` over one call, each device kernel's
  time and count, the streams used, the union of the device's activity
  (``busy_ms``) and the idle share between the call's first and last
  device activity (``idle_share``; medians of three profiled calls, whose
  kernels run somewhat longer than unprofiled ones), and the gap in
  microseconds from each Gram's end to the start of the chain that
  follows it on the same stream;
* one line of the distinct products of that group, each launched alone
  through the library's product entry (``mpbqr_group_product``) with the
  layout of :func:`ops.kernels.ns.group_layout`: its device time
  (``torch.profiler``, median of 10), CTAs, TFLOP/s and relative distance
  from ``mm_bf16`` / ``mm_f32``, beside ``torch.matmul`` of the same shape
  and dtype (a yardstick only);
* one line of K3 at 4096 x 128, robust and plain (10 iterations).

``--serial`` builds the library a second time with
``-DMPBQR_GROUP_SERIAL`` (``_build.instrumented_library``), which issues
the same look-ahead schedule in plain program order on the caller's
stream, and checks that both builds give bitwise-equal Q, Rg and worst in
every configuration.

``--k5-seeds N`` runs K5 (fp32 and bf16 flags) and K2 (fp32 flags) with a
robust last panel on N seeded draws (seed s: a uniform 2048 x 1024 group
and the first 1024 columns of the Q of a uniform 2048 x 2048 matrix) and
holds the kernel and the fp32 plain version against the same block
Gram-Schmidt computed in float64 (Cholesky QR per panel): per draw the
largest entry distance of the last panel and of the whole group, and the
kernel's distance from the plain version, which ``chip_smoke.py`` bounds
by 1e-4 under the fp32 flags.

It needs a CUDA device and ``nvcc``; without a device it exits 2.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys

import torch

#: The headline's group: m, g * r, r, and its chain lengths.
HEADLINE = (2048, 1024, 128)
ITERS = (12, 6, 6, 6, 6, 6, 6, 10)
#: (name, bf16 flags and chain_mid, robust last panel)
CONFIGS = (("bgs1", True, False), ("bgs1_robust", True, True),
           ("bgs2", False, False), ("bgs2_robust", False, True))
_GRAM = re.compile(r"gemm_tn|splitk_reduce")
_CHAIN = re.compile(r"chain_kernel")


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _profile_once(fn, attempts: int = 8):
    """Device spans (name, stream, start us, end us) of one call of fn.

    The CUDA tracer can miss the first device activities of a profile (two
    or three of a K2 call, or all of them), so each profile runs fn once
    to warm it, then a marker kernel (``torch.cuda._sleep``), then the call
    it keeps: the spans that start after the marker ends.  A profile that
    shows no marker or nothing after it is taken again, up to ``attempts``
    times (three in a row came back empty for one K4 launch on an H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        spans = [(e.name, e.device_resource_id, e.time_range.start,
                  e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        marks = [e for name, _, _, e in spans if "spin_kernel" in name]
        if marks:
            spans = [x for x in spans if x[2] > marks[-1]]
            if spans:
                return spans
    raise RuntimeError(f"torch.profiler saw no device activity after its "
                       f"marker in {attempts} profiles")


def _busy(spans) -> float:
    total, reach = 0.0, float("-inf")
    for start, end in sorted((s, e) for _, _, s, e in spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _short(name: str) -> str:
    name = name.removeprefix("void ").replace("mpbqr::", "")
    return name[:60]


def device_breakdown(fn, calls: int = 3) -> dict:
    """Per-kernel device ms and counts of one call of ``fn`` (the last of
    ``calls`` profiled calls), the streams it used, the union of its device
    activity and the idle share between its first and last device activity
    (medians over the calls), and the gaps from each Gram to the chain
    after it on the same stream."""
    idle, busy, spans = [], [], []
    for _ in range(calls):
        spans = _profile_once(fn)
        span = max(e for *_, e in spans) - min(s for _, _, s, _ in spans)
        busy.append(_busy(spans) / 1e3)
        idle.append(1.0 - busy[-1] * 1e3 / span)
    per: dict = {}
    for name, _, s, e in spans:
        row = per.setdefault(_short(name), {"ms": 0.0, "count": 0})
        row["ms"] += (e - s) / 1e3
        row["count"] += 1
    gaps = []
    for name, stream, s, _ in spans:
        if _CHAIN.search(name):
            ends = [e for n, st, _, e in spans
                    if st == stream and _GRAM.search(n) and e <= s]
            if ends:
                gaps.append(s - max(ends))
    return {"kernels": dict(sorted(per.items(), key=lambda kv: -kv[1]["ms"])),
            "device_events": len(spans),
            "streams": len({st for _, st, _, _ in spans}),
            "busy_ms": statistics.median(busy),
            "idle_share": statistics.median(idle),
            "gram_to_chain_us": gaps}


def device_ms(fn, calls: int = 10) -> float:
    """Median device time of one call of ``fn`` (the sum of its device
    activities under ``torch.profiler``) over ``calls`` calls: launched
    alone, a product of a few microseconds is shorter than its host launch,
    which CUDA events around it would time."""
    fn()
    times = []
    for _ in range(calls):
        times.append(sum(e - s for *_, s, e in _profile_once(fn)) / 1e3)
    return statistics.median(times)


def group_rows(Pg: torch.Tensor) -> list:
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        bgs_group_fused,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    rows = []
    for name, bf, rob in CONFIGS:
        robust = (False,) * (len(ITERS) - 1) + (rob,)

        def call():
            return bgs_group_fused(Pg, HEADLINE[2], ITERS, robust,
                                   bf16_dots=bf, chain_mid=bf)

        rows.append({"config": name, "ms": cuda_time_ms(call),
                     **device_breakdown(call)})
    return rows


def _product(lib, ta: bool, bf: bool, A, B, C, sub=False, split=1,
             chunk=1, bm=0, bn=0):
    """One launch of the library's product entry: C = A^T B (``ta``; A
    holds K x M) or C (-)= A B; every operand a row-major view with unit
    column stride."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import _stream

    M, N = C.shape
    K = A.shape[0] if ta else A.shape[1]
    check(lib.mpbqr_group_product(
        int(ta), int(bf), M, N, K, A.data_ptr(), A.stride(0),
        int(A.dtype == torch.bfloat16), B.data_ptr(), B.stride(0),
        C.data_ptr(), C.stride(0), int(sub), split, chunk, bm, bn,
        _stream(C)), "group_product")


def product_rows(lib, Pg: torch.Tensor) -> dict:
    """The distinct products of the headline's group (and K5's scrub at
    p = 1024), each alone with its layout, in both arithmetic forms:
    time, CTAs, TFLOP/s and distance from ``mm_bf16`` / ``mm_f32`` (summation
    order only), beside ``torch.matmul`` of the same shape and dtype."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        TN_TILE,
        group_layout,
        tn_split,
    )
    from mixedprecisionblockqr_tpu_torch.ops.policy import mm_bf16, mm_f32

    m, w, r = HEADLINE
    lay = group_layout(m, r)
    gen = torch.Generator(device=Pg.device).manual_seed(1)
    X = torch.rand((r, r), generator=gen, device=Pg.device)
    Qp = torch.rand((m, w), generator=gen, device=Pg.device) - 0.5
    C2 = torch.rand((w, w), generator=gen, device=Pg.device) - 0.5
    cw = w - 2 * r  # panel 0's wide part
    tn_group = dict(split=lay.split, chunk=lay.chunk)
    # name: (ta, A, B, output shape, sub, layout); the group's G1 shares
    # its panel's Gram split, K5's scrub has its own.
    shapes = {
        "gram_128x128_k2048": (True, Pg[:, :r], Pg[:, :r], (r, r), False,
                               tn_group),
        "g1_wide_128x768_k2048": (True, Pg[:, :r], Pg[:, 2 * r:], (r, cw),
                                  False, tn_group),
        "q_2048x128_k128": (False, Pg[:, :r], X, (m, r), False,
                            dict(bm=lay.bm_panel, bn=lay.bn)),
        "update_wide_2048x768_k128": (False, Pg[:, :r], C2[:r, :cw],
                                      (m, cw), True,
                                      dict(bm=lay.bm_wide, bn=lay.bn)),
        "scrub_tn_1024x1024_k2048": (True, Qp, Pg, (w, w), False, dict(
            zip(("split", "chunk"), tn_split(w, w, m)))),
        "scrub_nt_2048x1024_k1024": (False, Qp, C2, (m, w), True,
                                     dict(bm=lay.bm_wide, bn=lay.bn)),
    }
    out = {}
    for name, (ta, A, B, (M, N), sub, kw) in shapes.items():
        K = A.shape[0] if ta else A.shape[1]
        if ta:
            ctas = -(-M // TN_TILE) * -(-N // TN_TILE) * kw["split"]
        else:
            ctas = -(-M // kw["bm"]) * -(-N // kw["bn"])
        At = A.T if ta else A
        row = {"ctas": ctas, **kw}
        for bf in (True, False):
            C = torch.zeros((M, N), device=Pg.device)
            _product(lib, ta, bf, A, B, C, sub, **kw)
            ref = (mm_bf16 if bf else mm_f32)(At, B)
            ref = -ref if sub else ref
            err = float((C - ref).norm() / ref.norm())
            ms = device_ms(lambda: _product(lib, ta, bf, A, B, C, sub, **kw))
            ops = (At.bfloat16(), B.bfloat16()) if bf else (At, B)
            row["bf16" if bf else "fp32"] = {
                "ms": ms, "tflops": 2 * M * N * K / (ms * 1e-3) / 1e12,
                "rel_err": err,
                "matmul_ms": device_ms(lambda: torch.matmul(*ops))}
        out[name] = row
    return out


def k3_rows(Pk: torch.Tensor) -> dict:
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import panel_qr_fused
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    out = {}
    for name, kw in (("robust", dict(robust=True)),
                     ("plain10", dict(iters=10))):
        out[name] = {"ms": cuda_time_ms(lambda: panel_qr_fused(Pk, **kw)),
                     **device_breakdown(lambda: panel_qr_fused(Pk, **kw))}
    return out


def group_f64(P: torch.Tensor, r: int, Qprev=None) -> torch.Tensor:
    """The group's block Gram-Schmidt in float64: the scrub against
    ``Qprev``, then per panel Cholesky QR and the projection of the later
    columns."""
    P = P.double().clone()
    if Qprev is not None:
        Qp = Qprev.double()
        P = P - Qp @ (Qp.T @ P)
    for c0 in range(0, P.shape[1], r):
        Pj = P[:, c0:c0 + r]
        L = torch.linalg.cholesky(Pj.T @ Pj)
        Qj = torch.linalg.solve_triangular(L, Pj.T, upper=False).T
        P[:, c0:c0 + r] = Qj
        C = P[:, c0 + r:]
        P[:, c0 + r:] = C - Qj @ (Qj.T @ C)
    return P


def _dist(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def k5_sweep(n: int, dev) -> dict:
    """K5 (fp32 and bf16 flags) and K2 (fp32 flags) with a robust last
    panel on ``n`` seeded draws, against the fp32 plain version and the
    float64 block Gram-Schmidt."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        bgs_group_fused,
        bgs_group_fused_plain,
        bgs_group_fused_proj,
        bgs_group_fused_proj_plain,
    )

    m, w, r = HEADLINE
    robust = (False,) * (len(ITERS) - 1) + (True,)
    rows = []
    for seed in range(n):
        gen = torch.Generator(device=dev).manual_seed(seed)
        Pg = torch.rand((m, w), generator=gen, device=dev) - 0.5
        Qfull = torch.linalg.qr(
            torch.rand((m, m), generator=gen, device=dev) - 0.5
        )[0].contiguous()
        row = {"seed": seed}
        for name, Qprev in (("k5_fp32", Qfull[:, :w]),
                            ("k5_bf16", Qfull.bfloat16()[:, :w]),
                            ("k2_fp32", None)):
            bf = name.endswith("bf16")
            kw = dict(bf16_dots=bf, chain_mid=bf)
            if Qprev is None:
                Qk = bgs_group_fused(Pg, r, ITERS, robust, **kw)[0]
                Qp = bgs_group_fused_plain(Pg, r, ITERS, robust, **kw)[0]
            else:
                Qk = bgs_group_fused_proj(Pg, Qprev, r, ITERS, robust,
                                          **kw)[0]
                Qp = bgs_group_fused_proj_plain(Pg, Qprev, r, ITERS, robust,
                                                **kw)[0]
            Q64 = group_f64(Pg, r, Qprev)
            last = slice(w - r, w)
            row[name] = {
                "kernel_plain": _dist(Qk, Qp),
                "kernel_f64_last": _dist(Qk[:, last], Q64[:, last]),
                "plain_f64_last": _dist(Qp[:, last], Q64[:, last]),
                "kernel_f64": _dist(Qk, Q64), "plain_f64": _dist(Qp, Q64)}
        rows.append(row)
        print(json.dumps({"k5_seed": row}), flush=True)
    summary = {}
    for name in ("k5_fp32", "k5_bf16", "k2_fp32"):
        col = [row[name] for row in rows]
        summary[name] = {key: max(c[key] for c in col) for key in col[0]}
        summary[name]["draws_kernel_plain_above_1e-4"] = sum(
            c["kernel_plain"] > 1e-4 for c in col)
        summary[name]["draws_kernel_further_from_f64"] = sum(
            c["kernel_f64_last"] > c["plain_f64_last"] for c in col)
    return summary


def serial_rows(Pg: torch.Tensor) -> dict:
    """Q, Rg and worst of the default build against the serial build
    (``-DMPBQR_GROUP_SERIAL``), bit for bit, in every configuration; and
    two launches of the default build against each other."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import _launch_group

    out = {}
    with _build.instrumented_library("-DMPBQR_GROUP_SERIAL") as serial:
        for name, bf, rob in CONFIGS:
            robust = (False,) * (len(ITERS) - 1) + (rob,)
            args = (Pg, HEADLINE[2], ITERS, robust, bf, bf, bf)
            a = _launch_group(_build.library(), *args)
            b = _launch_group(_build.library(), *args)
            c = _launch_group(serial, *args)
            torch.cuda.synchronize()
            out[name] = {
                "repeat_equal": all(torch.equal(x, y) for x, y in zip(a, b)),
                "serial_equal": all(torch.equal(x, y) for x, y in zip(a, c))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serial", action="store_true")
    ap.add_argument("--k5-seeds", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("group_probe: no CUDA device", file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    print(_smi("name,power.limit"), flush=True)
    _build.library()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    m, w, r = HEADLINE
    Pg = torch.rand((m, w), generator=gen, device=dev) - 0.5
    for row in group_rows(Pg):
        print(json.dumps({"group": row}), flush=True)
    print(json.dumps({"products": product_rows(_build.library(), Pg)}),
          flush=True)
    Pk = torch.rand((4096, 128), generator=gen, device=dev) - 0.5
    print(json.dumps({"k3": k3_rows(Pk)}), flush=True)
    ok = True
    if args.serial:
        rows = serial_rows(Pg)
        ok = all(all(v.values()) for v in rows.values())
        print(json.dumps({"serial": rows, "ok": ok}), flush=True)
    if args.k5_seeds:
        print(json.dumps({"k5_summary": k5_sweep(args.k5_seeds, dev)}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
