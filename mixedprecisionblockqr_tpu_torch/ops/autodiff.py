"""Differentiable blocked QR (port of
``mixedprecisionblockqr_tpu/ops/autodiff.py``).

``make_differentiable_qr`` wraps the public ``block_qr`` in a
``torch.autograd.Function``: the forward runs any blocked driver (auto
dispatch, the group kernels, mixed policies), the backward is the
closed-form thin-QR adjoint (Liao et al. 2019), for ``A = Q R`` reduced
with cotangents ``(gQ, gR)``:

    M   = R gR^T - gQ^T Q
    gA  = (gQ + Q copyltu(M)) R^{-T}

where ``copyltu(M) = tril(M, -1) + tril(M, -1)^T + diag(M)``.  The formula
holds for whatever sign convention the driver returns (Q and R flip
together).  The products and the triangular solve are plain library calls,
as in the JAX package, whose backward runs outside its Pallas kernels.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from mixedprecisionblockqr_tpu_torch.ops.blockqr import block_qr
from mixedprecisionblockqr_tpu_torch.ops.policy import (
    DTypePolicy,
    POLICY_FP32,
    mm_f32,
)
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

__all__ = ["qr_autodiff", "make_differentiable_qr", "copyltu"]


def copyltu(M: torch.Tensor) -> torch.Tensor:
    """Copy the strict lower triangle of a square matrix onto its upper:
    ``tril(M, -1) + tril(M, -1)^T + diag(M)`` (the thin-QR adjoint's
    symmetrization)."""
    L = torch.tril(M, -1)
    return L + L.T + torch.diag(torch.diagonal(M))


@functools.lru_cache(maxsize=None)
def make_differentiable_qr(
    block_size: int = 128,
    policy: DTypePolicy = POLICY_FP32,
    panel_method: str = "auto",
    quality: Optional[str] = None,
):
    """Build ``A -> (Q, R)`` (reduced mode) with a custom backward.

    The forward is the public ``block_qr`` with ``check='defer'``: no host
    synchronization, so the NaN canary of a Newton-Schulz breakdown reaches
    the gradient as NaN.  Cached per parameter tuple, as the reference's
    ``lru_cache``.  Gradients assume full column rank (R nonsingular).  The
    backward runs in fp32 with TF32 off (``mm_f32``) whatever the policy;
    ``gA = Y R^{-T}`` is ``torch.linalg.solve_triangular(R^T, Y,
    upper=False, left=False)``, which solves ``X R^T = Y``.  The gradient
    comes back in A's dtype.  A cotangent of None (an output the loss does
    not use) counts as zeros.
    """

    class _DifferentiableQR(torch.autograd.Function):
        @staticmethod
        def forward(ctx, A):
            Q, R = block_qr(A, block_size, policy, mode="reduced",
                            panel_method=panel_method, quality=quality,
                            check="defer")
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(Q, R)
            ctx.a_dtype = A.dtype
            return Q, R

        @staticmethod
        def backward(ctx, gQ, gR):
            Q, R = ctx.saved_tensors
            Q32, R32 = Q.float(), R.float()
            M = torch.zeros_like(R32)
            if gR is not None:
                M = M + mm_f32(R32, gR.float().T)
            if gQ is not None:
                M = M - mm_f32(gQ.float().T, Q32)
            Y = mm_f32(Q32, copyltu(M))
            if gQ is not None:
                Y = Y + gQ.float()
            gA = torch.linalg.solve_triangular(R32.T, Y, upper=False,
                                               left=False)
            return gA.to(ctx.a_dtype)

    def qr_fn(A):
        return _DifferentiableQR.apply(as_device_tensor(A))

    return qr_fn


def qr_autodiff(
    A,
    block_size: int = 128,
    policy: DTypePolicy = POLICY_FP32,
    panel_method: str = "auto",
    quality: Optional[str] = None,
):
    """Reduced QR with reverse-mode gradients: ``Q, R = qr_autodiff(A)``
    takes part in ``torch.autograd`` like any differentiable operation.
    Composes with triangular solves for differentiable least squares::

        Q, R = qr_autodiff(A)
        x = torch.linalg.solve_triangular(R, (Q.T @ b)[:, None], upper=True)
        ((x[:, 0] - target) ** 2).sum().backward()

    A non-tensor ``A`` runs on CUDA (``utils/device.py``)."""
    return make_differentiable_qr(block_size, policy, panel_method,
                                  quality)(A)
