"""Fused Householder panel factorization: ``panel_factor_fused`` (K6)
beside its plain PyTorch version.

Port of ``mixedprecisionblockqr_tpu/ops/pallas/panel.py``.  Both return
``(V (m x w), T (w x w), R (m x w))`` with ``Q_panel = I - V T V^T`` and
``R = Q_panel^T panel``, the semantics of ``ops/householder.py::
panel_factor``: unit-norm reflectors with beta = 2, sign +1 when
``alpha >= 0``, beta = 0 for a column whose live norm is at most 1e-30.
Below its diagonal R holds rounding residue (plain version) or exact zeros
(the CUDA kernel); callers keep the upper triangle.  A NaN in the panel
survives into R, which the blocked drivers' NaN canary reads.  The CUDA
kernel runs one thread-block cluster laid out by :func:`panel_layout`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

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
#: Most CTAs of the kernel's thread-block cluster (a non-portable size).
MAX_CLUSTER = 16
#: Rows per CTA the layout aims at (utils/panel_probe.py compares others).
ROWS_TARGET = 128
#: Shared memory one CTA may use on an H100 (bytes).
SMEM_LIMIT = 232448
#: Floats of shared memory before the reflector entries and the rows, as
#: csrc/panel_factor.cu carves them (kPfFixedFloats): the pushed dots
#: [16][128] and norm partials [16][4][2], the row groups' dots [4][128],
#: beta and V's diagonal [128] each, a pad of 4.
_FIXED_FLOATS = 16 * 128 + 16 * 4 * 2 + 4 * 128 + 2 * 128 + 4


class PanelLayout(NamedTuple):
    """How the kernel splits an m x w panel over its cluster."""
    cluster: int      # CTAs, one row block each
    rows: int         # rows per CTA (the last may hold fewer)
    in_smem: bool     # rows in shared memory, else in place in R
    smem_bytes: int   # dynamic shared memory per CTA


def _smem_bytes(w: int, rows: int, in_smem: bool) -> int:
    """The kernel's carve-out: the fixed floats, the reflector entries of
    ``rows`` rows (padded to 4) and a region that holds the rows (when
    ``in_smem``) and, after the column loop, the w x w G."""
    held = rows * w if in_smem else 0
    return 4 * (_FIXED_FLOATS + (rows + 3) // 4 * 4 + max(held, w * w))


@functools.lru_cache(maxsize=None)
def panel_layout(m: int, w: int, max_cluster: int = MAX_CLUSTER,
                 rows_target: int = ROWS_TARGET) -> PanelLayout:
    """The kernel's layout for an m x w panel on a card that places
    clusters of up to ``max_cluster`` CTAs: ``ceil(m / rows_target)`` CTAs
    (1 to ``max_cluster``), more while a CTA's ``ceil(m / cluster)`` rows
    do not fit its shared memory; the rows in shared memory when they fit
    ``SMEM_LIMIT`` (428 rows at w = 128, so 16 CTAs hold 6848), else the
    in-place route on ``max_cluster`` CTAs.  A rule on shapes alone: it
    needs no device."""
    if not (1 <= w <= MAX_WIDTH and m >= w and 1 <= max_cluster
            <= MAX_CLUSTER):
        raise ValueError(
            f"panel_layout takes m x w with 1 <= w <= {MAX_WIDTH}, m >= w "
            f"and 1 <= max_cluster <= {MAX_CLUSTER}; got {m} x {w}, "
            f"max_cluster={max_cluster}")
    cluster = min(max_cluster, max(1, -(-m // rows_target)))
    while (cluster < max_cluster
           and _smem_bytes(w, -(-m // cluster), True) > SMEM_LIMIT):
        cluster += 1
    rows = -(-m // cluster)
    in_smem = _smem_bytes(w, rows, True) <= SMEM_LIMIT
    return PanelLayout(cluster, rows, in_smem, _smem_bytes(w, rows, in_smem))


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
    The layout is :func:`panel_layout`'s for the largest cluster the card
    places (:func:`max_cluster`), chosen before the launch.
    """
    if panel.device.type == "cpu":
        return panel_factor_fused_plain(panel)
    _require_cuda_f32(panel, "panel")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    # panel_layout raises ValueError for a shape the kernel does not take.
    lay = panel_layout(*panel.shape, max_cluster(panel.device))
    out = _launch(library(), panel, lay)
    LAUNCHES["panel_factor_fused"] += 1
    return out


@functools.lru_cache(maxsize=None)
def max_cluster(device: torch.device) -> int:
    """The largest cluster (at most ``MAX_CLUSTER`` CTAs) of which the card
    can place one at ``SMEM_LIMIT`` bytes of shared memory per CTA, the
    most any layout uses (``cudaOccupancyMaxActiveClusters``, asked once
    per device).  Raises when not even one CTA fits."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        check(library().mpbqr_panel_factor_max_cluster(
            SMEM_LIMIT, ctypes.byref(out)), "panel_factor_fused max_cluster")
    if out.value < 1:
        raise RuntimeError("panel_factor_fused: the card places no CTA with "
                           f"{SMEM_LIMIT} bytes of shared memory")
    return out.value


def _launch(lib, panel: torch.Tensor, lay: PanelLayout):
    """One launch of ``mpbqr_panel_factor`` from the kernel library ``lib``
    with the layout ``lay``; counts nothing.  Returns ``(V, T, R)``."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check

    m, w = panel.shape
    V = torch.empty_like(panel)
    T = torch.empty((w, w), dtype=torch.float32, device=panel.device)
    G = torch.empty((w, w), dtype=torch.float32, device=panel.device)
    R = torch.empty_like(panel)
    code = lib.mpbqr_panel_factor(
        panel.data_ptr(), V.data_ptr(), T.data_ptr(), G.data_ptr(),
        R.data_ptr(), m, w, lay.cluster, lay.rows, int(lay.in_smem),
        lay.smem_bytes, _stream(panel))
    check(code, "panel_factor_fused")
    return V, T, R
