"""QR quality metrics with the reference's precision-dependent bounds.

Port of ``mixedprecisionblockqr_tpu/ops/metrics.py``; every metric is
computed in fp32 with TF32 off, on the device of its inputs:
  * backward error   ||A - QR||_F / ||A||_F
  * orthogonality    max |Q^T Q - I|
  * lower-trapezoid  ||tril(R, -1)||_F
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32


def error_limit(precision_bits: int, m: int) -> float:
    """Acceptance threshold ``2^-bits * m``."""
    return (2.0 ** (-precision_bits)) * m


def tight_limit(precision_bits: int, m: int) -> float:
    """Regression gate ``2^-bits * max(sqrt(m), 12)``."""
    return (2.0 ** (-precision_bits)) * max(m ** 0.5, 12.0)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def backward_error(A, Q, R) -> torch.Tensor:
    """||A - QR||_F / ||A||_F."""
    A = _f32(A)
    QR = mm_f32(_f32(Q).to(A.device), _f32(R).to(A.device))
    return torch.linalg.norm(A - QR) / torch.linalg.norm(A)


def orthogonality_error(Q) -> torch.Tensor:
    """max |Q^T Q - I|."""
    Q = _f32(Q)
    QtQ = mm_f32(Q.T, Q)
    eye = torch.eye(Q.shape[1], dtype=torch.float32, device=Q.device)
    return torch.max(torch.abs(QtQ - eye))


def lower_trapezoid_error(R) -> torch.Tensor:
    """||tril(R, -1)||_F."""
    return torch.linalg.norm(torch.tril(_f32(R), -1))


def strip_r(A) -> torch.Tensor:
    """Upper-triangular part of A (``h_strip_R_from_A``, ``Cuda/qr.cu:85-100``
    of the reference)."""
    return torch.triu(torch.as_tensor(A))


@dataclasses.dataclass
class QRReport:
    """One factorization's quality report, with pass/fail per criterion."""

    m: int
    n: int
    precision_bits: int
    backward: float
    orthogonality: float
    lower_trapezoid: float

    @property
    def limit(self) -> float:
        return error_limit(self.precision_bits, self.m)

    @property
    def backward_ok(self) -> bool:
        return bool(self.backward <= self.limit)

    @property
    def orthogonality_ok(self) -> bool:
        return bool(self.orthogonality <= self.limit)

    @property
    def lower_trapezoid_ok(self) -> bool:
        return bool(self.lower_trapezoid <= self.limit)

    @property
    def all_ok(self) -> bool:
        return self.backward_ok and self.orthogonality_ok and self.lower_trapezoid_ok

    @property
    def tight(self) -> float:
        return tight_limit(self.precision_bits, self.m)

    @property
    def tight_ok(self) -> bool:
        return bool(
            self.backward <= self.tight
            and self.orthogonality <= self.tight
            and self.lower_trapezoid <= self.tight
        )

    def __str__(self) -> str:
        return (
            f"||A - QR||/||A|| = {self.backward:e} Error Criteria: {self.backward_ok}\n"
            f"||QT @ Q - Im|| = {self.orthogonality:E} Error Criteria: {self.orthogonality_ok}\n"
            f"||L|| = {self.lower_trapezoid:e} Error Criteria: {self.lower_trapezoid_ok}"
        )


def evaluate(A, Q, R, precision_bits: int = 23,
             R_has_full_rows: Optional[bool] = None) -> QRReport:
    """Compute all three metrics for a factorization A ~= Q R.
    ``R_has_full_rows`` is accepted and ignored, as in the JAX package."""
    A = _f32(A)
    m, n = A.shape
    return QRReport(
        m=m,
        n=n,
        precision_bits=precision_bits,
        backward=float(backward_error(A, Q, R)),
        orthogonality=float(orthogonality_error(Q)),
        lower_trapezoid=float(lower_trapezoid_error(R)),
    )
