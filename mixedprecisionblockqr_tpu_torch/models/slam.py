"""SLAM / bundle-adjustment least-squares workflow (port of
``mixedprecisionblockqr_tpu/models/slam.py``): enumerate Jacobians, factor
them, solve a Gauss-Newton step.  Only the synthetic Jacobians are ported;
the Euroc-MAV file loader waits for ROADMAP Queue 1 item 12.
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
from mixedprecisionblockqr_tpu_torch.utils.datagen import slam_jacobian
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

_EUROC = ("the Euroc-MAV Jacobian files are not ported to "
          "mixedprecisionblockqr_tpu_torch yet (ROADMAP Queue 1 item 12)")


@dataclasses.dataclass
class JacobianCase:
    name: str
    m: int
    n: int
    path: Optional[str] = None
    seed: int = 0

    def load(self) -> np.ndarray:
        if self.path is not None:
            raise NotImplementedError(_EUROC)
        return slam_jacobian(self.m, self.n, seed=self.seed)


def enumerate_jacobians(
    data_dir: Optional[str] = None,
    max_matrices: int = 30,
    synthetic_sizes: Optional[List[Tuple[int, int]]] = None,
) -> List[JacobianCase]:
    """Synthetic stand-ins for the Euroc-MAV Jacobian sweep, one seed per
    size.  A ``data_dir`` that exists would select the dataset files,
    which are not ported."""
    if data_dir and os.path.isdir(data_dir):
        raise NotImplementedError(_EUROC)
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
