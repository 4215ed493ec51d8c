"""SLAM / bundle-adjustment least-squares workflow (port of
``mixedprecisionblockqr_tpu/models/slam.py``): enumerate Jacobians (the
Euroc-MAV files through ``utils/euroc.py``, or synthetic stand-ins),
factor them, solve a Gauss-Newton step.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from mixedprecisionblockqr_tpu_torch.models.lstsq import lstsq
from mixedprecisionblockqr_tpu_torch.ops import metrics
from mixedprecisionblockqr_tpu_torch.ops.blockqr import block_qr
from mixedprecisionblockqr_tpu_torch.ops.policy import (
    DTypePolicy,
    POLICY_MIXED,
)
from mixedprecisionblockqr_tpu_torch.utils import euroc
from mixedprecisionblockqr_tpu_torch.utils.datagen import slam_jacobian
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor


@dataclasses.dataclass
class JacobianCase:
    name: str
    m: int
    n: int
    path: Optional[str] = None
    seed: int = 0

    def load(self) -> np.ndarray:
        if self.path is not None:
            return euroc.read_euroc_jacobian(self.path)[2]
        return slam_jacobian(self.m, self.n, seed=self.seed)


def enumerate_jacobians(
    data_dir: Optional[str] = None,
    max_matrices: int = 30,
    synthetic_sizes: Optional[List[Tuple[int, int]]] = None,
) -> List[JacobianCase]:
    """The dataset sweep of the original code
    (``get_jacobians_test_matrixs``, ``Cuda/qr.cu:1721-1759``): files
    ``A_%09d.txt`` for i in 100..22500 step 100 of an existing
    ``data_dir``, sorted by row count, every second one, at most
    ``max_matrices``.  Without the directory, synthetic stand-ins, one
    seed per size."""
    if data_dir and os.path.isdir(data_dir):
        cases = []
        for i in range(100, 22501, 100):
            path = os.path.join(data_dir, f"A_{i:09d}.txt")
            if os.path.exists(path):
                m, n = euroc.read_dims(path)
                cases.append(JacobianCase(os.path.basename(path), m, n, path))
        cases.sort(key=lambda c: c.m)
        return cases[::2][:max_matrices]
    sizes = synthetic_sizes or [
        (256, 128), (384, 192), (512, 256), (768, 384), (1024, 512),
        (1536, 768), (2000, 1000), (2048, 2048),
    ]
    return [
        JacobianCase(f"synthetic_{m}x{n}", m, n, seed=i)
        for i, (m, n) in enumerate(sizes)
    ]


def gauss_newton_step(
    J,
    residual,
    policy: DTypePolicy = POLICY_MIXED,
    damping: float = 0.0,
    device=None,
) -> torch.Tensor:
    """One Gauss-Newton / Levenberg update: solve ``J dx = -residual``.
    With ``damping > 0`` the stacked Tikhonov system ``[J; sqrt(damping)
    I] dx = [-r; 0]`` is solved instead.  ``device`` as in
    ``utils/device.py``."""
    J = as_device_tensor(J, device).float()
    residual = torch.as_tensor(residual, device=J.device).float()
    n = J.shape[1]
    if damping > 0.0:
        J = torch.cat([J, damping ** 0.5 * torch.eye(n, device=J.device)])
        residual = torch.cat([residual, residual.new_zeros(n)])
    return lstsq(J, -residual, policy=policy)


def factor_and_report(A, policy: DTypePolicy, block_size: int = 128,
                      device=None) -> metrics.QRReport:
    """Factor one Jacobian and report the metric triple (``device`` as in
    ``utils/device.py``)."""
    A = as_device_tensor(A, device)
    Q, R = block_qr(A, block_size=block_size, policy=policy)
    return metrics.evaluate(A, Q, R, policy.precision_bits)
