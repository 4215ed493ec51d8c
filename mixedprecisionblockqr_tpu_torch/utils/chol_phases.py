"""Where K9 ``chol_rinv`` spends its time, read from the kernel's own clock.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.chol_phases [r ...]

A developer's tool, run by hand on a CUDA device when K9 is changed; no
test or benchmark runs it.  It builds the kernel library a second time with
``-DMPBQR_CHOL_PROF`` (each CTA's thread 0 of ``csrc/chol_rinv.cu`` then
writes ``%globaltimer`` at its phase boundaries, and the diagonal warp at
the start and end of each 32 x 32 factor) into a temporary directory under
the package's ``_build/``, launches K9 through the wrapper's own launch
helper twice per r on the Gram of a seeded 2048 x r panel (default r = 256
and 512), reads the second, and prints one JSON line per r: per CTA the
microseconds spent loading G, waiting at the first cluster barrier of a
block (for Linv), in the row-panel solve, at the second barrier, in the
trailing update, and in the back-fill (with the part before its first
staged rows); and the diagonal factors' times.  It needs ``nvcc``; the
library the package uses is not touched.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

#: Slots of the kernel's clock buffer (csrc/chol_rinv.cu, PROF): 0 start,
#: 1 after the load, per block k 2+4k (after the first barrier), 3+4k
#: (after the solve), 4+4k (after the second barrier), 5+4k (after the
#: update); 100+3k / 101+3k / 102+3k the back-fill's row k (start, rows
#: staged, end); 300 after the last barrier, 301 after the back-fill.
_SLOTS, _DIAGS = 320, 64


def phases(lib: ctypes.CDLL, r: int, seed: int = 0) -> dict:
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check
    from mixedprecisionblockqr_tpu_torch.ops.kernels.chol import (
        _launch, chol_layout,
    )
    from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = torch.rand((2048, r), generator=gen, device=dev) - 0.5
    G = mm_f32(P.T, P).contiguous()
    lay = chol_layout(r)
    for _ in range(2):  # the second launch is the one read
        _launch(lib, G)
        torch.cuda.synchronize()
    prof = np.zeros((8, _SLOTS), np.uint64)
    diag = np.zeros((_DIAGS, 2), np.uint64)
    check(lib.mpbqr_chol_prof(prof.ctypes.data, diag.ctypes.data),
          "chol_prof")
    prof, diag = prof.astype(np.int64), diag.astype(np.int64)
    nb = r // 32

    def us(x):
        return float(x) / 1e3

    ctas = []
    for p in prof[:lay.cluster]:
        wait1 = sum(p[2 + 4 * k] - (p[5 + 4 * (k - 1)] if k else p[1])
                    for k in range(nb))
        rows = [k for k in range(nb) if p[102 + 3 * k] > p[100 + 3 * k] > 0]
        ctas.append({
            "load": us(p[1] - p[0]), "wait_linv": us(wait1),
            "solve": us(sum(p[3 + 4 * k] - p[2 + 4 * k] for k in range(nb))),
            "wait_rrow": us(sum(p[4 + 4 * k] - p[3 + 4 * k]
                                for k in range(nb - 1))),
            "update": us(sum(p[5 + 4 * k] - p[4 + 4 * k]
                             for k in range(nb - 1))),
            "back_fill": us(p[301] - p[300]),
            "back_fill_to_first_staged": us(sum(
                p[101 + 3 * k] - p[100 + 3 * k] for k in rows)),
            "end": us(p[301] - prof[:lay.cluster, 0].min())})
    d = diag[:nb, 1] - diag[:nb, 0]
    return {"r": r, "layout": lay._asdict(), "ctas_us": ctas,
            "diag_us": [us(x) for x in d], "diag_sum_us": us(d.sum())}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chol_phases: no CUDA device", file=sys.stderr)
        return 2
    sizes = [int(a) for a in argv] or [256, 512]
    if any(r % 32 or not 32 <= r <= 512 for r in sizes):
        print("chol_phases: r must be a multiple of 32 up to 512 (the "
              "clock buffer's slots)", file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        instrumented_library,
    )

    with instrumented_library("-DMPBQR_CHOL_PROF", "mpbqr_chol_prof",
                              2) as lib:
        for r in sizes:
            print(json.dumps(phases(lib, r)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
