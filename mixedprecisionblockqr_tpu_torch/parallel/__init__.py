"""Communication-avoiding and distributed QR (port of
``mixedprecisionblockqr_tpu/parallel/``): TSQR with a binary reduction tree
and tiled CAQR with stored factors on one device; over the ranks of a
``torch.distributed`` device mesh (``mesh``), the sharded TSQR
(``tsqr.tsqr_sharded``), batched problems split over a mesh (``batched``)
and the distributed blocked QR (``dist_qr.dist_block_qr``).  Every leaf,
tree node and reflector-tier panel is a Householder panel, K6
(``panel_factor_fused``) on the card for fp32 panels at most 128 wide."""

from mixedprecisionblockqr_tpu_torch.parallel import (
    batched,
    caqr,
    dist_qr,
    mesh,
    tsqr,
)

__all__ = ["batched", "caqr", "dist_qr", "mesh", "tsqr"]
