"""mixedprecisionblockqr_tpu_torch — the PyTorch + CUDA port of
mixedprecisionblockqr_tpu for NVIDIA Hopper.

Ported so far, behind ``block_qr``/``qr``/``block_qr_qtb``: the Block
Gram-Schmidt tiers ``bgs1``, ``bgs2`` and ``bgs``; the ``polar`` tier; the
CholeskyQR tiers ``cholqr1``, ``cholqr2``, ``cholqr2s`` and ``cholqr1x2``
(unrolled, and the cholqr scan tier); the BGS scan tier
(``loop_mode='scan'``, and every ``'auto'`` input beyond 12288) with its
checkpointed driver ``block_qr_resumable``; the Householder tiers
``householder`` and ``householder_pallas``; ``block_recursive_qr`` and
``block_qr_batched``.  Also the rank-revealing least-squares path
(``lstsq`` -> RQRCP pivoted QR -> Householder tier) with its TSQR and
refinement (stored-factor CAQR) options and ``lstsq_batched``; the
differentiable QR (``qr_autodiff``, ``make_differentiable_qr``,
``lstsq_autodiff``); single-device TSQR (``tsqr``, ``tsqr_batched``) and
CAQR (``caqr``), whose panels run K6 on the card; the distributed layer
over ``torch.distributed`` (``make_mesh``, ``tsqr_sharded``,
``dist_block_qr``, ``block_qr_batched_sharded``,
``tsqr_batched_sharded_2d``: SPMD functions that every rank of a mesh
calls with the global input); Givens QR and the
streaming updates of complete-mode factors (``givens_qr``,
``qr_rank1_update``, ``qr_append_row``, ``qr_insert_col``,
``qr_delete_col``, ``qr_delete_row``) and recursive least squares
(``RLSState``, ``rls_init``, ``rls_update``, ``rls_solve``), whose
rotation chains run three CUDA kernels of their own (``csrc/givens.cu``:
the row fold, the vector-driven chain and the Hessenberg chain; none
replaces a ``pallas_call``).  All nine kernels of
the JAX package are written in CUDA C++ for ``sm_90a`` under ``csrc/``:
``ns_chain`` (K1), ``bgs_group_fused`` (K2), ``panel_qr_fused`` (K3),
``ninv_chain`` (K4), ``bgs_group_fused_proj`` (K5), ``panel_factor_fused``
(K6), ``sketch_qrcp_ranks`` (K7), ``tiled_matmul`` (K8) and ``chol_rinv``
(K9); K8 and K9 are exported from ``ops.kernels``, as the JAX package
exports them from ``ops.pallas``.  The package imports torch and numpy,
never jax.

Entry points run on the card unless the caller asks for the CPU: a tensor
stays on its device, and a numpy array or list goes to ``device=`` or, by
default, to ``cuda`` (without a CUDA device it raises and names
``device='cpu'``).

Public API:
    qr, block_qr, block_qr_qtb, block_recursive_qr, block_qr_batched,
    householder_qr, cholesky_qr2, block_qr_resumable, clear_checkpoints
    householder_reflector, q_backward_accumulation, build_t_matrix,
    wy_representation, apply_block_reflector_left_t,
    apply_block_reflector_right
    pivoted_qr, pivoted_qr_qtb, numerical_rank
    lstsq, lstsq_pivoted, lstsq_batched, back_substitution,
    gauss_newton_step
    qr_autodiff, make_differentiable_qr, lstsq_autodiff
    tsqr, tsqr_batched, caqr
    make_mesh, tsqr_sharded, dist_block_qr, block_qr_batched_sharded,
    tsqr_batched_sharded_2d
    givens_qr, qr_rank1_update, qr_append_row, qr_insert_col,
    qr_delete_col, qr_delete_row
    RLSState, rls_init, rls_update, rls_solve
    DTypePolicy, POLICY_FP32, POLICY_MIXED, POLICY_MIXED_FAST, POLICY_BF16,
    POLICY_BF16_FAST, POLICY_FP64, policy_by_name
    metrics: backward_error, orthogonality_error, lower_trapezoid_error,
    evaluate
    checked_qr, NonFiniteError
"""

from mixedprecisionblockqr_tpu_torch.models.lstsq import (
    RLSState,
    back_substitution,
    lstsq,
    lstsq_autodiff,
    lstsq_batched,
    lstsq_pivoted,
    rls_init,
    rls_solve,
    rls_update,
)
from mixedprecisionblockqr_tpu_torch.models.resumable import (
    block_qr_resumable,
    clear_checkpoints,
)
from mixedprecisionblockqr_tpu_torch.models.slam import gauss_newton_step
from mixedprecisionblockqr_tpu_torch.ops import metrics
from mixedprecisionblockqr_tpu_torch.ops.autodiff import (
    make_differentiable_qr,
    qr_autodiff,
)
from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
    block_qr,
    block_qr_batched,
    block_qr_qtb,
    block_recursive_qr,
    qr,
)
from mixedprecisionblockqr_tpu_torch.ops.cholqr import cholesky_qr2
from mixedprecisionblockqr_tpu_torch.ops.givens import (
    givens_qr,
    qr_append_row,
    qr_delete_col,
    qr_delete_row,
    qr_insert_col,
    qr_rank1_update,
)
from mixedprecisionblockqr_tpu_torch.ops.householder import (
    householder_qr,
    householder_reflector,
    q_backward_accumulation,
)
from mixedprecisionblockqr_tpu_torch.ops.pivoted import (
    numerical_rank,
    pivoted_qr,
    pivoted_qr_qtb,
)
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
from mixedprecisionblockqr_tpu_torch.ops.wy import (
    apply_block_reflector_left_t,
    apply_block_reflector_right,
    build_t_matrix,
    wy_representation,
)
from mixedprecisionblockqr_tpu_torch.parallel.batched import (
    block_qr_batched_sharded,
    tsqr_batched_sharded_2d,
)
from mixedprecisionblockqr_tpu_torch.parallel.caqr import caqr
from mixedprecisionblockqr_tpu_torch.parallel.dist_qr import dist_block_qr
from mixedprecisionblockqr_tpu_torch.parallel.mesh import make_mesh
from mixedprecisionblockqr_tpu_torch.parallel.tsqr import (
    tsqr,
    tsqr_batched,
    tsqr_sharded,
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
    "block_qr_qtb",
    "block_recursive_qr",
    "block_qr_batched",
    "cholesky_qr2",
    "qr",
    "householder_qr",
    "householder_reflector",
    "q_backward_accumulation",
    "build_t_matrix",
    "wy_representation",
    "apply_block_reflector_left_t",
    "apply_block_reflector_right",
    "pivoted_qr",
    "pivoted_qr_qtb",
    "numerical_rank",
    "lstsq",
    "lstsq_pivoted",
    "lstsq_batched",
    "lstsq_autodiff",
    "qr_autodiff",
    "make_differentiable_qr",
    "tsqr",
    "tsqr_batched",
    "caqr",
    "make_mesh",
    "tsqr_sharded",
    "dist_block_qr",
    "block_qr_batched_sharded",
    "tsqr_batched_sharded_2d",
    "givens_qr",
    "qr_rank1_update",
    "qr_append_row",
    "qr_insert_col",
    "qr_delete_col",
    "qr_delete_row",
    "RLSState",
    "rls_init",
    "rls_update",
    "rls_solve",
    "back_substitution",
    "gauss_newton_step",
    "block_qr_resumable",
    "clear_checkpoints",
    "metrics",
    "checked_qr",
    "NonFiniteError",
    "__version__",
]
