"""Fused blocked Cholesky with the factor's inverse: ``chol_rinv`` (K9)
beside its plain PyTorch version.

Port of ``mixedprecisionblockqr_tpu/ops/pallas/chol.py``.  For an SPD
``G`` (r x r, fp32, r a multiple of 32) both return the upper ``R`` with
``G = R^T R`` and the explicit ``R^-1``, so a CholeskyQR panel is a
product, this call, a product.  The algorithm is the reference's:
right-looking blocked Cholesky on 32-wide diagonal blocks whose column
loop also builds the block's inverse row by row (bordered form), a
row-panel solve and a trailing update per block, then the block-row
back-fill of ``R^-1``; every product in true fp32.  A pivot that is not
positive gives ``sqrt(negative) = NaN``, which spreads: nothing raises.
The strictly lower parts of ``R`` and ``R^-1`` are exact zeros.
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

#: Diagonal block size; r must be a multiple of it.
BLOCK = 32


def _check_size(G: torch.Tensor) -> int:
    r = G.shape[0] if G.dim() == 2 else 0
    if G.dim() != 2 or G.shape != (r, r) or r < BLOCK or r % BLOCK != 0:
        raise ValueError(f"chol_rinv requires a square matrix of size % "
                         f"{BLOCK} == 0, got {tuple(G.shape)}")
    return r


def chol_rinv_plain(G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`chol_rinv` (``_chol_inv_kernel``
    transcription)."""
    r = _check_size(G)
    dev = G.device
    A = G.float().clone()
    R = torch.zeros((r, r), dtype=torch.float32, device=dev)
    Rinv = torch.zeros_like(R)
    idx = torch.arange(BLOCK, device=dev)
    eye = torch.eye(BLOCK, dtype=torch.float32, device=dev)
    for base in range(0, r, BLOCK):
        end = base + BLOCK
        Ablk = A[base:end, base:end].clone()
        L = torch.zeros_like(Ablk)
        Linv = torch.zeros_like(Ablk)
        for i in range(BLOCK):
            d = torch.sqrt(Ablk[i, i])
            col = torch.where(idx >= i, Ablk[:, i] / d, 0.0)
            Ablk = Ablk - col[:, None] * col[None, :]
            L[:, i] = col
            # Inverse row i (bordered form): (e_i - L[i, :i] Linv) / d
            lrow = torch.where(idx < i, L[i, :], 0.0)
            Linv[i, :] = (eye[i] - (lrow[:, None] * Linv).sum(dim=0)) / d
        R[base:end, base:end] = L.T
        Rinv[base:end, base:end] = Linv.T
        if end < r:
            Rrow = mm_f32(Linv, A[base:end, end:])
            R[base:end, end:] = Rrow
            A[end:, end:] -= mm_f32(Rrow.T, Rrow)
    for kb in range(r - 2 * BLOCK, -1, -BLOCK):
        end = kb + BLOCK
        S = mm_f32(R[kb:end, end:], Rinv[end:, end:])
        Rinv[kb:end, end:] = -mm_f32(Rinv[kb:end, kb:end], S)
    return R, Rinv


def chol_rinv(G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upper Cholesky factor and its inverse: ``G = R^T R``, returns
    ``(R, R^-1)``.  ``G`` must be symmetric positive definite with a size
    that is a multiple of 32 (``ValueError`` otherwise); on CUDA a
    contiguous fp32 tensor."""
    r = _check_size(G)
    if G.device.type == "cpu":
        return chol_rinv_plain(G)
    _require_cuda_f32(G, "G")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    R = torch.empty_like(G)
    Rinv = torch.empty_like(G)
    scratch = torch.empty_like(G)
    code = library().mpbqr_chol_rinv(G.data_ptr(), R.data_ptr(),
                                     Rinv.data_ptr(), scratch.data_ptr(), r,
                                     _stream(G))
    check(code, "chol_rinv")
    LAUNCHES["chol_rinv"] += 1
    return R, Rinv
