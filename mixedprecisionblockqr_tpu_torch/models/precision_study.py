"""Precision study: dtype x condition-number tables of error and duration
(port of ``mixedprecisionblockqr_tpu/models/precision_study.py``; the
original study is ``python/performance_test.py`` with its results in
``python/performance_test_result/{error,duration}.md``).

Householder QR over sizes x condition numbers x dtypes, rendered as
markdown tables of backward error and duration.  fp16 runs on the CPU in
numpy and overflows to NaN at cond >= 1e6 (``error.md:15-16`` of the
original), because fp16 has a 5-bit exponent; bf16, with fp32's 8-bit
exponent, stays finite on the same matrices.  The ``bf16`` and ``fp32``
rows call the port's ``block_qr`` on the card (``device=`` as in
``utils/device.py``), each timed between two device synchronizations.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from mixedprecisionblockqr_tpu_torch.ops.blockqr import block_qr
from mixedprecisionblockqr_tpu_torch.ops.policy import POLICY_BF16, POLICY_FP32
from mixedprecisionblockqr_tpu_torch.utils.datagen import conditioned_matrix


def _error(A: np.ndarray, Q: np.ndarray, R: np.ndarray) -> float:
    A = A.astype(np.float64)
    return float(
        np.linalg.norm(A - Q.astype(np.float64) @ R.astype(np.float64))
        / np.linalg.norm(A)
    )


def _qr_numpy_fp16(A: np.ndarray):
    """fp16 Householder QR in numpy, unblocked (the original study's
    NaN-prone configuration): the same numbers as the JAX package's, bit
    for bit.  inf / NaN propagate unguarded: reproducing that failure is
    the point."""
    A = A.astype(np.float16)
    m, n = A.shape
    Q = np.eye(m, dtype=np.float16)
    R = A.copy()
    for k in range(min(m - 1, n)):
        x = R[k:, k].astype(np.float16)
        sigma = np.float16(np.linalg.norm(x.astype(np.float16)))
        if sigma == 0:
            continue
        u = x.copy()
        u[0] = np.float16(u[0] + np.sign(u[0] + np.float16(1e-8)) * sigma)
        norm_u = np.float16(np.linalg.norm(u.astype(np.float16)))
        if norm_u == 0:
            continue
        w = (u / norm_u).astype(np.float16)
        R[k:, :] = (R[k:, :] - 2 * np.outer(w, w @ R[k:, :])).astype(np.float16)
        Q[:, k:] = (Q[:, k:] - 2 * np.outer(Q[:, k:] @ w, w)).astype(np.float16)
    return Q, R


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_study(
    sizes: Sequence[int] = (128, 256, 500),
    condition_numbers: Sequence[float] = (1e3, 1e4, 1e5, 1e6, 1e7),
    block_size: int = 64,
    device=None,
) -> Dict[str, List[dict]]:
    """One record per (size, cond, dtype): ``{"n", "cond", "dtype",
    "error", "seconds", "finite"}``, dtypes ``fp16(cpu)``, ``bf16``,
    ``fp32`` and the LAPACK float64 oracle ``lapack_fp64``.  ``device``
    places the ``block_qr`` rows (default: the card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: run_study runs block_qr on the GPU by "
                "default; pass device='cpu' to run it on the CPU")
        device = "cuda"
    records: List[dict] = []
    for n in sizes:
        for cond in condition_numbers:
            A = conditioned_matrix(n, cond, seed=0).astype(np.float64)
            for name, policy in (("fp16(cpu)", None), ("bf16", POLICY_BF16),
                                 ("fp32", POLICY_FP32)):
                if policy is None:
                    t0 = time.perf_counter()
                    Qh, Rh = _qr_numpy_fp16(A)
                    Qn = Qh.astype(np.float64)
                    Rn = np.triu(Rh.astype(np.float64))
                    dt = time.perf_counter() - t0
                else:
                    A32 = torch.from_numpy(A.astype(np.float32)).to(device)
                    _sync(device)
                    t0 = time.perf_counter()
                    Q, R = block_qr(A32, block_size=min(block_size, n),
                                    policy=policy, mode="complete")
                    _sync(device)
                    dt = time.perf_counter() - t0
                    Qn = Q.double().cpu().numpy()
                    Rn = R.double().cpu().numpy()
                err = _error(A, Qn, Rn)
                records.append(
                    {"n": n, "cond": cond, "dtype": name,
                     "error": err, "seconds": dt,
                     "finite": bool(np.isfinite(err))}
                )
            t0 = time.perf_counter()
            Qn, Rn = np.linalg.qr(A)
            dt = time.perf_counter() - t0
            records.append(
                {"n": n, "cond": cond, "dtype": "lapack_fp64",
                 "error": _error(A, Qn, Rn), "seconds": dt, "finite": True}
            )
    return {"records": records}


def to_markdown(study: Dict[str, List[dict]]) -> Dict[str, str]:
    """``{"error.md", "duration.md"}`` tables: rows size x cond, columns
    the dtypes, the original study's layout."""
    records = study["records"]
    dtypes = []
    for r in records:
        if r["dtype"] not in dtypes:
            dtypes.append(r["dtype"])
    keys = []
    for r in records:
        k = (r["n"], r["cond"])
        if k not in keys:
            keys.append(k)

    def table(field: str, fmt) -> str:
        lines = ["| n | cond | " + " | ".join(dtypes) + " |",
                 "|---|---|" + "---|" * len(dtypes)]
        for n, cond in keys:
            row = [str(n), f"{cond:.0e}"]
            for d in dtypes:
                rec = next(
                    r for r in records
                    if r["n"] == n and r["cond"] == cond and r["dtype"] == d
                )
                row.append(fmt(rec[field]))
            lines.append("| " + " | ".join(row) + " |")
        return "\n".join(lines) + "\n"

    err_md = (
        "# Backward error ||A-QR||/||A|| by dtype\n\n"
        "fp16 reproduces the original study's NaN overflow at high\n"
        "condition numbers (performance_test_result/error.md:15-16); bf16\n"
        "(fp16's mantissa class, fp32's exponent) stays finite.\n\n"
        + table("error", lambda v: "NaN" if not np.isfinite(v) else f"{v:.2e}")
    )
    dur_md = ("# Duration (seconds a call, between device synchronizations; "
              "the first call of a configuration included)\n\n"
              + table("seconds", lambda v: f"{v:.3f}"))
    return {"error.md": err_md, "duration.md": dur_md}


def write_study(out_dir: str = "log/precision_study", **kw) -> List[str]:
    """Run the study (``run_study``'s keyword arguments) and write its two
    tables into ``out_dir``; returns their paths."""
    import os

    files = to_markdown(run_study(**kw))
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, content in files.items():
        p = os.path.join(out_dir, name)
        with open(p, "w") as f:
            f.write(content)
        paths.append(p)
    return paths
