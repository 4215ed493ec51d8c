"""Communication-avoiding QR on one device (port of
``mixedprecisionblockqr_tpu/parallel/``'s ``tsqr`` and ``caqr``): TSQR with
a binary reduction tree and tiled CAQR with stored factors.  Every leaf
and tree node is a Householder panel, K6 (``panel_factor_fused``) on the
card for fp32 panels at most 128 wide."""

from mixedprecisionblockqr_tpu_torch.parallel import caqr, tsqr

__all__ = ["caqr", "tsqr"]
