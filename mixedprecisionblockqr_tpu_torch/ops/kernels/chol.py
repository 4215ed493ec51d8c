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
The strictly lower parts of ``R`` and ``R^-1`` are exact zeros.  The CUDA
kernel runs one thread-block cluster laid out by :func:`chol_layout`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
    LAUNCHES,
    _require_cuda_f32,
    _stream,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32

#: Diagonal block size; r must be a multiple of it.
BLOCK = 32
#: Most CTAs of the kernel's thread-block cluster (the portable size).
MAX_CLUSTER = 8
#: Shared memory one CTA may use on an H100 (bytes).
SMEM_LIMIT = 232448
#: Rows of R the in-place route stages at a time.
INPLACE_CHUNK = 512
#: Fewest rows staged: the staging buffer (32 x (chunk + 4) floats) also
#: holds the back-fill's partial sums, 8192 floats.
MIN_CHUNK = 256
#: Floats of shared memory besides the staged rows and the columns, as the
#: kernel carves them (csrc/chol_rinv.cu): Linv^T (32 x 36), the diagonal
#: warp's column (2 x 32) and the back-fill's sums (8 units of 32 x 8).
_BASE_FLOATS = BLOCK * (BLOCK + 4) + 2 * BLOCK + BLOCK * 64


class CholLayout(NamedTuple):
    """How the kernel splits an r x r problem over its cluster."""
    cluster: int      # CTAs, one column stripe each
    stripe: int       # columns per stripe (the last may be narrower)
    chunk: int        # rows of R staged in shared memory at a time
    in_smem: bool     # stripes in shared memory, else in place in R, Rinv
    smem_bytes: int   # dynamic shared memory per CTA


@functools.lru_cache(maxsize=None)
def chol_layout(r: int) -> CholLayout:
    """The kernel's layout for size ``r`` (a positive multiple of 32):
    stripes of 64 columns (32 when r = 32), widened by 32 at a time while
    more than ``MAX_CLUSTER`` would be needed, 32-column blocks dealt to
    the CTAs in snake order; the stripes and all of R's rows (at least
    ``MIN_CHUNK``) in shared memory when they fit ``SMEM_LIMIT``, else the
    in-place route, which stages ``INPLACE_CHUNK`` rows at a time."""
    nb = r // BLOCK
    per = max(min(2, nb), -(-nb // MAX_CLUSTER))
    stripe = BLOCK * per
    cluster = -(-nb // per)
    chunk = max(r, MIN_CHUNK)
    floats = _BASE_FLOATS + BLOCK * (chunk + 4) + r * stripe
    if floats * 4 <= SMEM_LIMIT:
        return CholLayout(cluster, stripe, chunk, True, floats * 4)
    chunk = max(MIN_CHUNK, min(r, INPLACE_CHUNK))
    return CholLayout(cluster, stripe, chunk, False,
                      (_BASE_FLOATS + BLOCK * (chunk + 4)) * 4)


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
    _check_size(G)
    if G.device.type == "cpu":
        return chol_rinv_plain(G)
    _require_cuda_f32(G, "G")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    R, Rinv = _launch(library(), G)
    LAUNCHES["chol_rinv"] += 1
    return R, Rinv


def _launch(lib, G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``mpbqr_chol_rinv`` from the kernel library ``lib``
    with the layout of :func:`chol_layout`; counts nothing."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check

    r = G.shape[0]
    lay = chol_layout(r)
    R = torch.empty_like(G)
    Rinv = torch.empty_like(G)
    code = lib.mpbqr_chol_rinv(G.data_ptr(), R.data_ptr(), Rinv.data_ptr(),
                               r, lay.stripe, lay.chunk, int(lay.in_smem),
                               lay.smem_bytes, _stream(G))
    check(code, "chol_rinv")
    return R, Rinv
