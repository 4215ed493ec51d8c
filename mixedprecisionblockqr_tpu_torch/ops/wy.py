"""Compact-WY (T-matrix) block reflectors (port of
``mixedprecisionblockqr_tpu/ops/wy.py``).

``Q = I - V T V^T`` with T (r x r) upper triangular.  ``apply_block_
reflector_left_t``, ``apply_block_reflector_right`` and
``reduced_q_from_vt`` also take stacks (B, ., .) of reflectors and
operands, member by member (the JAX package ``vmap``s them).  The tall
products run under the policy's dtypes through
``ops/policy.py::matmul``; the r x r T
products run at full precision in the accumulation dtype (fp32 with TF32
off under every policy but POLICY_FP64).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.householder import _mm
from mixedprecisionblockqr_tpu_torch.ops.policy import (
    DTypePolicy,
    POLICY_FP32,
    accum_matmul,
    q_matmul,
    trailing_matmul,
)


def build_t_matrix(V: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Upper-triangular T with ``H_0 ... H_{r-1} = I - V T V^T``, by the
    forward recurrence ``T_j = [[T, -beta_j T (V^T v_j)], [0, beta_j]]``."""
    r = V.shape[1]
    S = _mm(V.T, V)
    T = torch.zeros((r, r), dtype=V.dtype, device=V.device)
    for j in range(r):
        if j:
            T[:j, j] = -beta[j] * _mm(T[:j, :j], S[:j, j])
        T[j, j] = beta[j]
    return T


def wy_representation(V: torch.Tensor, beta: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(W, Y)`` with ``Q = I - W Y^T``: Y = V and W = V T."""
    T = build_t_matrix(V, beta)
    return _mm(V, T), V


def apply_block_reflector_left_t(
    C: torch.Tensor,
    V: torch.Tensor,
    T: torch.Tensor,
    policy: DTypePolicy = POLICY_FP32,
) -> torch.Tensor:
    """``Q^T C = C - V (T^T (V^T C))``: the trailing-matrix update (of
    each member, for stacks)."""
    mm = trailing_matmul(policy)
    return C - mm(V, accum_matmul(policy)(T.mT, mm(V.mT, C)))


def apply_block_reflector_right(
    Q: torch.Tensor,
    V: torch.Tensor,
    T: torch.Tensor,
    policy: DTypePolicy = POLICY_FP32,
) -> torch.Tensor:
    """``Q (I - V T V^T) = Q - ((Q V) T) V^T``: the Q-accumulation update
    (of each member, for stacks)."""
    mm = q_matmul(policy)
    return Q - mm(accum_matmul(policy)(mm(Q, V), T), V.mT)


def reduced_q_from_vt(V: torch.Tensor, T: torch.Tensor,
                      n: Optional[int] = None) -> torch.Tensor:
    """First n columns of ``I - V T V^T`` without the h x h identity:
    ``I[:, :n] - V (T V[:n, :]^T)`` (of each member, for stacks)."""
    h, r = V.shape[-2:]
    n = r if n is None else n
    Q = -_mm(V, _mm(T, V[..., :n, :].mT))
    return Q + torch.eye(h, n, dtype=Q.dtype, device=Q.device)
