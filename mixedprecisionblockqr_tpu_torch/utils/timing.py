"""Timing: device time with CUDA events, wall time, profiler scopes.

``cuda_time_ms`` warms a callable up, then records a CUDA event pair around
each of ``iters`` calls on the current stream and returns the median
milliseconds per call.  It refuses anything but a CUDA device: a CPU run
has no device time to report.  ``time_fn`` is the JAX package's wall-clock
harness, ``time_step_amortized`` its difference of chained runs (CUDA
events on the card; the reference's remote-tunnel reasoning does not
apply), ``trace`` a ``torch.profiler`` scope and ``device_peak_tflops`` the
card's dense peak.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Optional, Tuple

import torch

from mixedprecisionblockqr_tpu_torch.utils.bounds import PEAK_BF16, PEAK_F32


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


def _on_cuda(x) -> bool:
    """Whether ``x`` (a tensor, or a tuple / list of them) holds a CUDA
    tensor."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_on_cuda(y) for y in x)
    return False


def time_fn(
    fn: Callable,
    *args,
    warmup: int = 2,
    iters: int = 5,
    **kwargs,
) -> Tuple[float, object]:
    """Median wall-clock seconds per call (after ``warmup`` calls) and the
    last result.  When CUDA is in use (initialized in this process), every
    call is followed by ``torch.cuda.synchronize()``, so the time covers the
    device's work; on the CPU no synchronization is needed."""

    def call():
        out = fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return out

    result = None
    for _ in range(max(warmup, 1)):
        result = call()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        result = call()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], result


def time_step_amortized(
    step_fn: Callable,
    x0,
    iters: int = 16,
    repeats: int = 3,
) -> float:
    """Seconds per application of ``step_fn`` (x -> x, same shape and
    dtype), as the difference of two chained runs: ``1`` and ``1 + iters``
    applications, ``(t_long - t_base) / iters`` with the best of
    ``repeats`` of each, so fixed overhead cancels.  On a CUDA input each
    run is timed with a CUDA event pair and nothing is fetched to the host
    inside the chain; on the CPU with the host clock."""
    cuda = _on_cuda(x0)

    def run(n):
        x = x0
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                x = step_fn(x)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
        t0 = time.perf_counter()
        for _ in range(n):
            x = step_fn(x)
        return time.perf_counter() - t0

    run(1)  # warm up
    t_base, t_long = [], []
    for _ in range(repeats):
        t_base.append(run(1))
        t_long.append(run(1 + iters))
    return max(min(t_long) - min(t_base), 1e-9) / iters


@contextlib.contextmanager
def trace(name: str, log_dir: Optional[str] = None):
    """Named profiler scope (``torch.profiler.record_function``); with a
    ``log_dir``, a ``torch.profiler.profile`` around the block (CPU, and
    CUDA when available) exports a Chrome trace there as
    ``<name>.trace.json``."""
    if log_dir is None:
        with torch.profiler.record_function(name):
            yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(name):
            yield
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.trace.json"))


def device_peak_tflops(dtype: str = "bfloat16") -> Optional[float]:
    """The card's dense peak TFLOP/s for ``dtype`` ('bfloat16' / 'bf16' on
    the tensor cores, 'float32' / 'fp32' outside them): the H100 SXM data
    sheet's rates of ``utils/bounds.py`` when ``torch.cuda.get_device_name``
    names an H100; None on any other device, the CPU included, and for
    another dtype."""
    if not torch.cuda.is_available():
        return None
    if "H100" not in torch.cuda.get_device_name():
        return None
    peaks = {"bfloat16": PEAK_BF16, "bf16": PEAK_BF16,
             "float32": PEAK_F32, "fp32": PEAK_F32}
    peak = peaks.get(dtype)
    return None if peak is None else peak / 1e12
