"""mixedprecisionblockqr_tpu_torch — the PyTorch + CUDA port of
mixedprecisionblockqr_tpu for NVIDIA Hopper.

This slice ports the main path: the Block Gram-Schmidt QR tiers ``bgs1``,
``bgs2`` and ``bgs`` behind ``block_qr``/``qr``, with the two kernels that
carry them (``ns_chain`` and ``bgs_group_fused``) written in CUDA C++ for
``sm_90a`` under ``csrc/``.  The package imports torch and numpy, never jax.

Public API:
    qr, block_qr
    DTypePolicy, POLICY_FP32, POLICY_MIXED, POLICY_MIXED_FAST, POLICY_BF16,
    POLICY_BF16_FAST, POLICY_FP64, policy_by_name
    metrics: backward_error, orthogonality_error, lower_trapezoid_error,
    evaluate
    checked_qr, NonFiniteError
"""

from mixedprecisionblockqr_tpu_torch.ops import metrics
from mixedprecisionblockqr_tpu_torch.ops.blockqr import block_qr, qr
from mixedprecisionblockqr_tpu_torch.ops.policy import (
    DTypePolicy,
    POLICY_BF16,
    POLICY_BF16_FAST,
    POLICY_FP32,
    POLICY_FP64,
    POLICY_MIXED,
    POLICY_MIXED_FAST,
    policy_by_name,
)
from mixedprecisionblockqr_tpu_torch.utils.checks import (
    NonFiniteError,
    checked_qr,
)

__version__ = "0.1.0"

__all__ = [
    "DTypePolicy",
    "POLICY_FP32",
    "POLICY_MIXED",
    "POLICY_MIXED_FAST",
    "POLICY_BF16",
    "POLICY_BF16_FAST",
    "POLICY_FP64",
    "policy_by_name",
    "block_qr",
    "qr",
    "metrics",
    "checked_qr",
    "NonFiniteError",
    "__version__",
]
