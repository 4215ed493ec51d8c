"""Benchmark and metrics logging (port of
``mixedprecisionblockqr_tpu/utils/logging.py``).

CSV schema of the original CUDA code's ``h_write_results_to_log``
(``Cuda/qr.cu:58-83``): ``rows,cols,runtime,flops,error`` appended to
``<log_dir>/<name>.txt``, the header written when the file is created.
Each configuration gets its own file and errors are logged unscaled, as
in the JAX package.  A JSONL sink carries richer structured records.  The
files are byte for byte the JAX package's for the same records.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

CSV_HEADER = "rows,cols,runtime,flops,error"


class ResultsLogger:
    def __init__(self, log_dir: str = "log"):
        self.log_dir = log_dir

    def _path(self, name: str, ext: str) -> str:
        os.makedirs(self.log_dir, exist_ok=True)
        return os.path.join(self.log_dir, f"{name}.{ext}")

    def write_csv(
        self, name: str, rows: int, cols: int, runtime_s: float, flops: float,
        error: float,
    ) -> None:
        """Append one CSV record (runtime in seconds, error unscaled)."""
        path = self._path(name, "txt")
        fresh = not os.path.exists(path)
        with open(path, "a") as f:
            if fresh:
                f.write(CSV_HEADER + "\n")
            f.write(f"{rows},{cols},{runtime_s},{flops},{error}\n")

    def write_jsonl(self, name: str, record: Dict[str, Any]) -> None:
        """Append ``record`` as one JSON line, with a ``ts`` (seconds since
        the epoch) unless it has one."""
        record = dict(record)
        record.setdefault("ts", time.time())
        with open(self._path(name, "jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")


def read_csv_log(path: str):
    """Parse a results CSV into a list of dicts (the plot scripts' input,
    ``Cuda/performance/util.py:6-32``); lines of the wrong width are
    skipped."""
    out = []
    with open(path) as f:
        header = f.readline().strip().split(",")
        for line in f:
            parts = line.strip().split(",")
            if len(parts) != len(header):
                continue
            rec = dict(zip(header, parts))
            out.append(
                {
                    "rows": int(float(rec["rows"])),
                    "cols": int(float(rec["cols"])),
                    "runtime": float(rec["runtime"]),
                    "flops": float(rec["flops"]),
                    "error": float(rec["error"]),
                }
            )
    return out


def average_by_rows(records):
    """Average repeated runs per row count, sorted by rows; ``cols`` is the
    last record's (``Cuda/performance/util.py:6-20``)."""
    groups: Dict[int, list] = {}
    for r in records:
        groups.setdefault(r["rows"], []).append(r)
    out = []
    for rows in sorted(groups):
        grp = groups[rows]
        n = len(grp)
        out.append(
            {
                "rows": rows,
                "cols": grp[-1]["cols"],
                "runtime": sum(g["runtime"] for g in grp) / n,
                "flops": sum(g["flops"] for g in grp) / n,
                "error": sum(g["error"] for g in grp) / n,
            }
        )
    return out
