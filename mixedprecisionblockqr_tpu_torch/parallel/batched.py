"""Batched factorizations over a device mesh (port of
``mixedprecisionblockqr_tpu/parallel/batched.py``).

Independent QR problems split over a ``batch`` mesh axis, optionally with
each problem's rows split over ``rows`` as well: a 2-D (batch x rows)
mesh.  Both functions are SPMD: every rank passes the global batch and
gets back its own slabs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
    _driver_batched,
    resolve_panel_config,
)
from mixedprecisionblockqr_tpu_torch.ops.householder import _mm
from mixedprecisionblockqr_tpu_torch.ops.policy import (
    DTypePolicy,
    POLICY_FP32,
)
from mixedprecisionblockqr_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    ROWS_AXIS,
    all_gather,
    axis_index,
    axis_size,
    mesh_device,
)
from mixedprecisionblockqr_tpu_torch.parallel.tsqr import (
    _leaf_qrs,
    _reduction_trees,
)
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor


def block_qr_batched_sharded(
    A_batch,
    mesh,
    block_size: int = 128,
    policy: DTypePolicy = POLICY_FP32,
    panel_method: str = "cholqr2",
    axis: str = BATCH_AXIS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Independent QRs of a (b, m, n) batch split over ``mesh[axis]``, with
    no communication: returns this rank's ``(Q (b/d, m, n), R (b/d, n,
    n))``.  The rank's problems run the unrolled driver of ``block_qr``
    after ``resolve_panel_config``'s shape fallbacks and policy checks, as
    in the JAX package, as one stack (``ops/blockqr.py::_driver_batched``:
    the reflector tiers in one stacked call, one K6 launch over the batch a
    panel step on the card; the ``bgs*`` tiers, where ``'auto'`` sends
    every m >= n, r | n, n >= 2r stack under a mixed policy, in one
    stacked call, one batched K2 entry a group; ``polar`` in one stacked
    call, one batched K1 and one batched K4 launch a panel)."""
    A_batch = as_device_tensor(A_batch, mesh_device(mesh)).to(policy.panel)
    b, m, n = A_batch.shape
    d = axis_size(mesh, axis)
    if b % d:
        raise ValueError(f"batch {b} must divide over {axis}")
    panel_method, _, group_panels = resolve_panel_config(
        m, n, block_size, policy, panel_method, "unroll", 4,
        mode="reduced", on_gpu=A_batch.is_cuda,
    )
    k = b // d
    i = axis_index(mesh, axis)
    R_full, Q, _ = _driver_batched(A_batch[i * k:(i + 1) * k], block_size,
                                   policy, True, None, panel_method,
                                   group_panels)
    return Q[:, :, :n], torch.triu(R_full[:, :n, :])


def tsqr_batched_sharded_2d(
    A_batch,
    mesh,
    batch_axis: str = BATCH_AXIS,
    rows_axis: str = ROWS_AXIS,
    leaf_method: str = "cholqr2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched TSQR on a 2-D (batch x rows) mesh: problems split over
    ``batch`` (no communication between them), each problem's rows over
    ``rows`` (one all-gather of the (n x n) leaf R factors per problem).
    A_batch (b, m, n) fp32 with b divisible by mesh[batch] and m by
    mesh[rows].  Returns this rank's ``(Q (b/db, m/dr, n), R (b/db, n,
    n))``: Q's slab over both axes, R's over ``batch`` only.  The rank's
    leaves are factored in one call (Householder leaves: one batched K6
    launch on the card; CholeskyQR2 leaves one stacked ``cholesky_qr2``),
    then ONE all-gather of the rank's (b/db, n, n) R stack and one
    ``_reduction_trees`` call for all its problems, as the JAX package's
    ``vmap(one)`` runs them."""
    A_batch = as_device_tensor(A_batch, mesh_device(mesh)).float()
    b, m, n = A_batch.shape
    db = axis_size(mesh, batch_axis)
    dr = axis_size(mesh, rows_axis)
    if b % db or m % dr:
        raise ValueError(
            f"batch {b} must divide over {batch_axis}({db}) and rows {m} "
            f"over {rows_axis}({dr})"
        )
    kb, h = b // db, m // dr
    ib, ir = axis_index(mesh, batch_axis), axis_index(mesh, rows_axis)
    Q_locs, R_locs = _leaf_qrs(
        A_batch[ib * kb:(ib + 1) * kb, ir * h:(ir + 1) * h], leaf_method)
    # (dr, kb, n, n) -> each problem's dr leaf R factors: (kb, dr, n, n)
    R_all = all_gather(R_locs, mesh, rows_axis).transpose(0, 1)
    F, R = _reduction_trees(R_all.contiguous())
    return _mm(Q_locs, F[:, ir]), R
