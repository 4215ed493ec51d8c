"""Performance plots (port of ``mixedprecisionblockqr_tpu/utils/plotting.py``;
the original CUDA code's ``Cuda/performance/runtime.py``): runtime, GFLOP/s
and error against matrix rows, one series per CSV log, repeated runs
averaged per row count.

Matplotlib is optional (imported only here, inside ``plot_logs``); without
it ``plot_logs`` writes a markdown summary table instead.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from mixedprecisionblockqr_tpu_torch.utils.logging import (
    average_by_rows,
    read_csv_log,
)


def _series(log_path: str):
    return average_by_rows(read_csv_log(log_path))


def plot_logs(
    log_paths: Sequence[str],
    labels: Optional[Sequence[str]] = None,
    out_dir: str = "log/plots",
) -> List[str]:
    """Write runtime / GFLOP/s / error plots (PNG) of the logs into
    ``out_dir``, or ``summary.md`` without matplotlib.  Labels default to
    the files' base names (with their directories when two collide).
    Returns the paths written."""
    if labels is None:
        labels = [os.path.splitext(os.path.basename(p))[0] for p in log_paths]
        if len(set(labels)) != len(labels):
            labels = [
                f"{os.path.basename(os.path.dirname(os.path.abspath(p))) or '.'}/"
                f"{os.path.splitext(os.path.basename(p))[0]}"
                for p in log_paths
            ]
    labels = list(labels)
    series = {lab: _series(p) for lab, p in zip(labels, log_paths)}
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        path = os.path.join(out_dir, "summary.md")
        with open(path, "w") as f:
            f.write("| series | rows | cols | runtime (s) | GFLOP/s | error |\n")
            f.write("|---|---|---|---|---|---|\n")
            for lab, recs in series.items():
                for r in recs:
                    gflops = r["flops"] / max(r["runtime"], 1e-12) / 1e9 \
                        if r["flops"] < 1e15 else r["flops"] / 1e9
                    f.write(
                        f"| {lab} | {r['rows']} | {r['cols']} | "
                        f"{r['runtime']:.6f} | {gflops:.2f} | {r['error']:.3e} |\n"
                    )
        return [path]

    specs = [
        ("runtime", "Runtime (s)", lambda r: r["runtime"]),
        ("gflops", "GFLOP/s", lambda r: r["flops"] / max(r["runtime"], 1e-12) / 1e9),
        ("error", "||A-QR||/||A||", lambda r: r["error"]),
    ]
    for name, ylabel, get in specs:
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for lab, recs in series.items():
            xs = [r["rows"] for r in recs]
            ys = [get(r) for r in recs]
            ax.plot(xs, ys, marker="o", label=lab)
        ax.set_xlabel("Matrix rows")
        ax.set_ylabel(ylabel)
        if name in ("runtime", "error"):
            ax.set_yscale("log")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    return written
