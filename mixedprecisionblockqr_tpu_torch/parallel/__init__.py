"""Communication-avoiding and distributed QR (port of
``mixedprecisionblockqr_tpu/parallel/``): TSQR with a binary reduction tree
and tiled CAQR with stored factors on one device; over the ranks of a
``torch.distributed`` device mesh (``mesh``), the sharded TSQR
(``tsqr.tsqr_sharded``), batched problems split over a mesh (``batched``),
the distributed blocked QR over the rows of a mesh
(``dist_qr.dist_block_qr``) and over a 2-D (rows x cols) mesh
(``dist_qr2d.dist_block_qr_2d``, whose column axis is ``COLS_AXIS``).
Every leaf, tree node and reflector-tier panel is a Householder panel, K6
(``panel_factor_fused``) on the card for fp32 panels at most 128 wide."""

from mixedprecisionblockqr_tpu_torch.parallel import (
    batched,
    caqr,
    dist_qr,
    dist_qr2d,
    mesh,
    tsqr,
)
from mixedprecisionblockqr_tpu_torch.parallel.dist_qr2d import (
    COLS_AXIS,
    dist_block_qr_2d,
)

__all__ = ["batched", "caqr", "dist_qr", "dist_qr2d", "mesh", "tsqr",
           "COLS_AXIS", "dist_block_qr_2d"]
