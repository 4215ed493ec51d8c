"""Fused Householder panel factorization: ``panel_factor_fused`` (K6)
beside its plain PyTorch version.

Port of ``mixedprecisionblockqr_tpu/ops/pallas/panel.py``.  Both return
``(V (m x w), T (w x w), R (m x w))`` with ``Q_panel = I - V T V^T`` and
``R = Q_panel^T panel``, the semantics of ``ops/householder.py::
panel_factor``: unit-norm reflectors with beta = 2, sign +1 when
``alpha >= 0``, beta = 0 for a column whose live norm is at most 1e-30.
Below its diagonal R holds rounding residue (plain version) or exact zeros
(the CUDA kernel); callers keep the upper triangle.  A NaN in the panel
survives into R, which the blocked drivers' NaN canary reads.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
    LAUNCHES,
    _require_cuda_f32,
    _stream,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32

_TINY = 1e-30
#: Widest panel the CUDA kernel takes.
MAX_WIDTH = 128


def panel_factor_fused_plain(panel: torch.Tensor):
    """Plain version of :func:`panel_factor_fused` (``_panel_kernel``
    transcription: masked full-height column steps, the rank-1 update on
    every column, T built column by column)."""
    P = panel.float().clone()
    m, r = P.shape
    dev = P.device
    rows = torch.arange(m, device=dev)[:, None]
    cols_r = torch.arange(r, device=dev)[:, None]
    V = torch.zeros_like(P)
    T = torch.zeros((r, r), dtype=torch.float32, device=dev)
    for j in range(r):
        x = P[:, j:j + 1]
        xm = torch.where(rows >= j, x, 0.0)
        sigma = torch.sqrt((xm * xm).sum())
        alpha = torch.where(rows == j, x, 0.0).sum()
        sign = torch.where(alpha >= 0, 1.0, -1.0)
        u = xm + sign * sigma * (rows == j).float()
        unorm = torch.sqrt((u * u).sum())
        live = sigma > _TINY
        w = torch.where(live, u / torch.where(live, unorm, 1.0), 0.0)
        beta = torch.where(live, 2.0, 0.0)
        P = P - beta * (w * mm_f32(w.T, P))
        tcol = -beta * mm_f32(T, mm_f32(V.T, w))
        tcol = torch.where(cols_r < j, tcol, 0.0)
        T[:, j:j + 1] = torch.where(cols_r == j, beta, tcol)
        V[:, j:j + 1] = w
    return V, T, P


def panel_factor_fused(panel: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Householder column loop of one m x w panel in one launch.

    Returns ``(V, T, R)`` as in the module docstring.  On CUDA the panel
    must be a contiguous fp32 tensor with ``1 <= w <= MAX_WIDTH`` and
    ``m >= w``; any height the device's memory holds is taken (rows beyond
    what the cluster's shared memory holds are worked on in place in R).
    """
    if panel.device.type == "cpu":
        return panel_factor_fused_plain(panel)
    _require_cuda_f32(panel, "panel")
    m, w = panel.shape
    if not (1 <= w <= MAX_WIDTH and m >= w):
        raise ValueError(
            f"panel_factor_fused kernel takes m x w with 1 <= w <= "
            f"{MAX_WIDTH} and m >= w; got {tuple(panel.shape)}")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    lib = library()
    V = torch.empty_like(panel)
    T = torch.empty((w, w), dtype=torch.float32, device=panel.device)
    R = torch.empty_like(panel)
    code = lib.mpbqr_panel_factor(panel.data_ptr(), V.data_ptr(),
                                  T.data_ptr(), R.data_ptr(), m, w,
                                  _stream(panel))
    check(code, "panel_factor_fused")
    LAUNCHES["panel_factor_fused"] += 1
    return V, T, R
