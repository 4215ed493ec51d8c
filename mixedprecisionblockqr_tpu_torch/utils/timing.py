"""Device timing with CUDA events.

``cuda_time_ms`` warms a callable up, then records a CUDA event pair around
each of ``iters`` calls on the current stream and returns the median
milliseconds per call.  It refuses anything but a CUDA device: a CPU run
has no device time to report.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def cuda_time_ms(fn: Callable[[], object], warmup: int = 3,
                 iters: int = 20) -> float:
    """Median device milliseconds of ``fn()`` over ``iters`` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(max(warmup, 1)):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
