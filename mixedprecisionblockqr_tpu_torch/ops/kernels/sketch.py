"""Greedy QRCP pivot selection on a small sketch: ``sketch_qrcp_ranks``
(K7) beside its plain PyTorch version.

Port of ``mixedprecisionblockqr_tpu/ops/pallas/sketch.py``.  The plain
version is also the counterpart of the JAX package's XLA loop
``ops/pivoted.py::_sketch_qrcp``, which runs off the TPU: both pick the
same pivots in the same order on finite input.

Selection (``_sketch_qrcp_kernel``), for s = 0 .. r-1 on the (d, w) sketch:
  1. j = first index of ``max(norms)``; the max propagates NaN, and then no
     column matches and the step selects nothing;
  2. qn = q / ||q|| of the pivot column q (0 when ``||q||^2 <= tiny``);
  3. coef = qn^T work, work -= qn coef;
  4. norms = max(norms - coef^2, 0), selected columns held at -inf;
  5. rank[j] = s.
Unselected columns hold rank w, so a stable argsort of the ranks puts the
pivots first in selection order and keeps the rest in column order.  The
CUDA kernel runs one thread-block cluster laid out by :func:`sketch_layout`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
    LAUNCHES,
    _require_cuda_f32,
    _stream,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32

_TINY = torch.finfo(torch.float32).tiny

#: Most CTAs of the kernel's thread-block cluster (the portable size).
MAX_CLUSTER = 8
#: Threads of one CTA (csrc/sketch_qrcp.cu's kSkThreads).
THREADS = 512
#: Shared memory one CTA may use on an H100 (bytes).
SMEM_LIMIT = 232448
#: Floats of shared memory before the pivot column, as the kernel carves
#: them: the candidates (2 parities x 8 CTAs x 16 warps of a 64-bit key)
#: and the pivot's index (2 parities, padded to 16 bytes).
_BASE_FLOATS = 2 * MAX_CLUSTER * (THREADS // 32) * 2 + 4


class SketchLayout(NamedTuple):
    """How the kernel splits a (d, w) sketch over its cluster."""
    cluster: int      # CTAs, one column stripe each
    stripe: int       # columns per stripe (the last may be narrower)
    in_smem: bool     # stripes in shared memory, else in place in scratch
    smem_bytes: int   # dynamic shared memory per CTA


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def sketch_layout(d: int, w: int) -> SketchLayout:
    """The kernel's layout for a (d, w) sketch: ``min(8, w)`` contiguous
    column stripes of ``ceil(w / 8)`` columns, each column stored as
    ``4 ceil(d / 4)`` rows; a stripe, its norms and the pivot column in the
    CTA's shared memory when they fit ``SMEM_LIMIT``, else the in-place
    route, which keeps the stripe in the scratch (L2) and only the norms
    and the pivot column in shared memory.  Raises ``ValueError`` when
    even those exceed ``SMEM_LIMIT``: 4 ceil(d / 4) + 4 ceil(stripe / 4)
    above 57,596 floats (so d up to 57,592 for w <= 8, and w up to 459,680
    at d = 136)."""
    stripe = -(-w // min(MAX_CLUSTER, w))
    cluster = -(-w // stripe)
    fixed = _BASE_FLOATS + _up4(d) + _up4(stripe)
    floats = fixed + stripe * _up4(d)
    if floats * 4 <= SMEM_LIMIT:
        return SketchLayout(cluster, stripe, True, floats * 4)
    if fixed * 4 > SMEM_LIMIT:
        raise ValueError(
            f"sketch_qrcp_ranks kernel: a ({d}, {w}) sketch needs {fixed * 4} "
            f"bytes of shared memory per CTA for the pivot column and the "
            f"norms of a {stripe}-column stripe, above the {SMEM_LIMIT} an "
            "H100 block may use")
    return SketchLayout(cluster, stripe, False, fixed * 4)


def sketch_qrcp_ranks_plain(Bsk: torch.Tensor, r: int) -> torch.Tensor:
    """Plain version of :func:`sketch_qrcp_ranks`: a loop of tensor ops
    with no host synchronization."""
    work = Bsk.float().clone()
    d, w = work.shape
    dev = work.device
    norms = (work * work).sum(dim=0)
    rank = torch.full((w,), w, dtype=torch.int32, device=dev)
    idx = torch.arange(w, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for s in range(r):
        hit = norms == norms.max()
        j = torch.where(hit, idx, w).min()
        onehot = idx == j
        jc = j.clamp(max=w - 1)[None]
        q = torch.where(j < w, work.index_select(1, jc)[:, 0], 0.0)
        q2 = (q * q).sum()
        qn = torch.where(q2 > _TINY,
                         q * torch.rsqrt(torch.clamp(q2, min=_TINY)), 0.0)
        coef = mm_f32(qn[None, :], work)[0]
        work = work - qn[:, None] * coef[None, :]
        dead = onehot | (norms == neg_inf)
        norms = torch.where(dead, neg_inf,
                            torch.maximum(norms - coef * coef,
                                          torch.zeros_like(norms)))
        rank = torch.where(onehot, s, rank)
    return rank


def sketch_qrcp_ranks(Bsk: torch.Tensor, r: int) -> torch.Tensor:
    """Selection ranks of greedy QRCP on the (d, w) fp32 sketch ``Bsk``:
    ``rank_of`` (w,) int32 with the s-th pivot column holding s (s < r)
    and unselected columns holding w; ``argsort(rank_of, stable=True)`` is
    the panel's column order.  On CUDA, 1 <= r <= w, and (d, w) within
    the limit that :func:`sketch_layout` states."""
    if Bsk.device.type == "cpu":
        return sketch_qrcp_ranks_plain(Bsk, r)
    _require_cuda_f32(Bsk, "Bsk")
    d, w = Bsk.shape
    if not 1 <= r <= w:
        raise ValueError(f"sketch_qrcp_ranks kernel needs 1 <= r <= w; got "
                         f"r={r}, sketch {tuple(Bsk.shape)}")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    rank = _launch(library(), Bsk, r)
    LAUNCHES["sketch_qrcp_ranks"] += 1
    return rank


def _launch(lib, Bsk: torch.Tensor, r: int) -> torch.Tensor:
    """One launch of ``mpbqr_sketch_qrcp`` from the kernel library ``lib``
    with the layout of :func:`sketch_layout`; counts nothing."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check

    d, w = Bsk.shape
    lay = sketch_layout(d, w)
    # The in-place route's scratch: the sketch column by column.
    work = torch.empty(0 if lay.in_smem else w * _up4(d),
                       dtype=torch.float32, device=Bsk.device)
    rank = torch.empty((w,), dtype=torch.int32, device=Bsk.device)
    code = lib.mpbqr_sketch_qrcp(
        Bsk.data_ptr(), work.data_ptr(), rank.data_ptr(), d, w, r,
        lay.cluster, lay.stripe, int(lay.in_smem), lay.smem_bytes,
        _stream(Bsk))
    check(code, "sketch_qrcp_ranks")
    return rank
