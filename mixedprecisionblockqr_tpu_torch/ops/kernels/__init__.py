"""Hand-written CUDA kernels (csrc/) and their plain PyTorch versions."""

from mixedprecisionblockqr_tpu_torch.ops.kernels.chol import (  # noqa: F401
    chol_rinv,
    chol_rinv_plain,
)
from mixedprecisionblockqr_tpu_torch.ops.kernels.gemm import (  # noqa: F401
    matmul_bf16_accum_f32,
    matmul_int8_accum_i32,
    matmul_uint8_accum_i32,
    tiled_matmul,
    tiled_matmul_plain,
)
from mixedprecisionblockqr_tpu_torch.ops.kernels.givens import (  # noqa: F401
    givens_chain,
    givens_chain_plain,
    givens_fold_rows,
    givens_fold_rows_plain,
    givens_hessenberg,
    givens_hessenberg_plain,
)
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (  # noqa: F401
    LAUNCHES,
    bgs_group_fused,
    bgs_group_fused_batched,
    bgs_group_fused_plain,
    bgs_group_fused_proj,
    bgs_group_fused_proj_plain,
    ninv_chain,
    ninv_chain_batched,
    ninv_chain_plain,
    ninv_layout,
    ns_chain,
    ns_chain_batched,
    ns_chain_plain,
    panel_qr_fused,
    panel_qr_fused_plain,
    reset_launches,
    tri_cholqr_fused,
    tri_cholqr_robust_fused,
    tri_combine,
    tri_combine_plain,
)
from mixedprecisionblockqr_tpu_torch.ops.kernels.panel import (  # noqa: F401
    panel_factor_fused,
    panel_factor_fused_plain,
)
from mixedprecisionblockqr_tpu_torch.ops.kernels.sketch import (  # noqa: F401
    sketch_qrcp_ranks,
    sketch_qrcp_ranks_plain,
)
