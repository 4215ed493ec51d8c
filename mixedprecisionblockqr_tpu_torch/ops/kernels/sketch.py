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
pivots first in selection order and keeps the rest in column order.
"""

from __future__ import annotations

import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
    LAUNCHES,
    _require_cuda_f32,
    _stream,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32

_TINY = torch.finfo(torch.float32).tiny


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
    the panel's column order.  On CUDA, 1 <= r <= w."""
    if Bsk.device.type == "cpu":
        return sketch_qrcp_ranks_plain(Bsk, r)
    _require_cuda_f32(Bsk, "Bsk")
    d, w = Bsk.shape
    if not 1 <= r <= w:
        raise ValueError(f"sketch_qrcp_ranks kernel needs 1 <= r <= w; got "
                         f"r={r}, sketch {tuple(Bsk.shape)}")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    lib = library()
    if w + d > lib.mpbqr_sketch_qrcp_max_floats():
        raise ValueError(f"sketch_qrcp_ranks kernel: d + w = {d + w} floats "
                         "exceed its shared memory")
    work = torch.empty_like(Bsk)
    rank = torch.empty((w,), dtype=torch.int32, device=Bsk.device)
    code = lib.mpbqr_sketch_qrcp(Bsk.data_ptr(), work.data_ptr(),
                                 rank.data_ptr(), d, w, r, _stream(Bsk))
    check(code, "sketch_qrcp_ranks")
    LAUNCHES["sketch_qrcp_ranks"] += 1
    return rank
