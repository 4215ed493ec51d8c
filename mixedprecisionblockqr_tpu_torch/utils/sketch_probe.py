"""K7 ``sketch_qrcp_ranks`` alone on the card, against its plain version.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.sketch_probe [--phases]

Builds (or loads) the kernel library, then for each sketch of
:func:`k7_sketches` launches K7 twice, runs the plain version once, and
prints one JSON line: the layout (cluster, stripe, route), whether the two
launches agree bit for bit and with the plain version's ranks, and the
kernel's and the plain version's times (CUDA events, median of 20).  The
first line is the card's name and power limit (nvidia-smi).  ``chip_smoke.py``
phase 3 runs the same kinds of sketches through :func:`k7_row`.

With ``--phases``, the kernel library is built a second time with
``-DMPBQR_SKETCH_PROF`` (``_build.instrumented_library``); one more launch
per sketch from it gives a second line per sketch: per CTA, the
microseconds its thread 0 spent in each phase of the steps (``phases_us``,
summed over the steps, at the SM clock that ``nvidia-smi`` reads beside
it).  It needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch


def k7_sketches(gen: torch.Generator, dev,
                gen_more: torch.Generator | None = None) -> dict:
    """name -> (sketch, r): seeded Gaussian sketches.  From ``gen``, in this
    order: d = 128 + 8 at the RQRCP panels' widths (2048, 1920, 200) and a
    2048-wide one with a zero column and a duplicated column.  From
    ``gen_more`` (by default ``gen``): 136 x 8192 (the in-place route);
    72 x 1024 with r = 64 (block size 64); rows that are not a multiple of
    4 (138 = 128 + 10, RQRCP's d at oversample 10, and 73 x 300 with
    r = 64); 700 rows with r = 64, on shared memory (256 wide) and in place
    (1024 wide), whose columns take two row blocks; one with a NaN column
    (nothing is ever selected) and one with an inf entry (its column is
    selected first, then the NaN coefficients end the selection); and a
    6-wide one (fewer columns than the cluster's most CTAs)."""
    more = gen if gen_more is None else gen_more

    def g(d, w, src=gen):
        return torch.randn((d, w), generator=src, device=dev)

    out = {f"w{w}": (g(136, w), 128) for w in (2048, 1920, 200)}
    Sz = g(136, 2048)
    Sz[:, 3] = 0.0
    Sz[:, 7] = Sz[:, 1000]
    out["zero_dup"] = (Sz, 128)
    out["w8192"] = (g(136, 8192, more), 128)
    for d, w, r in ((72, 1024, 64), (138, 2048, 128), (73, 300, 64),
                    (700, 256, 64), (700, 1024, 64)):
        out[f"d{d}_w{w}_r{r}"] = (g(d, w, more), r)
    Sn = g(136, 2048, more)
    Sn[:, 517] = float("nan")
    out["nan_column"] = (Sn, 128)
    Si = g(136, 2048, more)
    Si[40, 1234] = float("inf")
    out["inf_entry"] = (Si, 128)
    out["w6"] = (g(40, 6, more), 6)
    return out


def k7_row(S: torch.Tensor, r: int) -> dict:
    """Two launches of K7 and the plain version on ``S``: layout, agreement
    and times.  ``ok`` holds when the launches agree bit for bit and their
    ranks equal the plain version's."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.sketch import (
        sketch_layout,
        sketch_qrcp_ranks,
        sketch_qrcp_ranks_plain,
    )
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    lay = sketch_layout(*S.shape)
    rk = sketch_qrcp_ranks(S, r)
    rk2 = sketch_qrcp_ranks(S, r)
    rp = sketch_qrcp_ranks_plain(S, r)
    torch.cuda.synchronize()
    repeat = bool(torch.equal(rk, rk2))
    err = int((rk.long() - rp.long()).abs().max())
    return {"shape": list(S.shape), "r": r, "cluster": lay.cluster,
            "stripe": lay.stripe,
            "route": "smem" if lay.in_smem else "in_place",
            "selected": int((rk < S.shape[1]).sum()),
            "bitwise_repeatable": repeat, "max_abs_rank": err,
            "ok": repeat and err == 0,
            "ms": cuda_time_ms(lambda: sketch_qrcp_ranks(S, r)),
            "plain_ms": cuda_time_ms(lambda: sketch_qrcp_ranks_plain(S, r))}


#: Slots of the kernel's phase clocks (csrc/sketch_qrcp.cu, PROF), as CTA
#: thread 0 (in the choosing warp) sees them: from the barrier to the
#: pivot's choice, the pivot column's read, its norm and qn, the column
#: pass, the warp's argmax and push, the cluster barrier.
PHASES = {"choose": 0, "read_pivot": 1, "norm": 2, "pass": 4, "push": 5,
          "barrier": 7}


def _phases(lib, S: torch.Tensor, r: int, mhz: float) -> dict:
    import numpy as np

    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check
    from mixedprecisionblockqr_tpu_torch.ops.kernels.sketch import (
        _launch, sketch_layout,
    )

    _launch(lib, S, r)
    torch.cuda.synchronize()
    prof = np.zeros((8, 8), np.int64)
    check(lib.mpbqr_sketch_prof(prof.ctypes.data), "sketch_prof")
    n = sketch_layout(*S.shape).cluster
    return {name: [float(p[k]) / mhz for p in prof[:n]]
            for name, k in PHASES.items()}


def _sm_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sketch_probe: no CUDA device", file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.library()
    dev = torch.device("cuda", 0)
    sketches = k7_sketches(torch.Generator(device=dev).manual_seed(0), dev)
    ok = True
    for name, (S, r) in sketches.items():
        row = k7_row(S, r)
        ok = ok and row["ok"]
        print(json.dumps({"sketch": name, **row}), flush=True)
    if args.phases:
        with _build.instrumented_library("-DMPBQR_SKETCH_PROF",
                                         "mpbqr_sketch_prof", 1) as prof:
            for name, (S, r) in sketches.items():
                mhz = _sm_mhz()
                print(json.dumps({"sketch": name, "sm_mhz": mhz,
                                  "phases_us": _phases(prof, S, r, mhz)}),
                      flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
