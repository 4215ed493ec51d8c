"""``panel_qr_fused`` (kernel K3) of the port against the JAX package's
Pallas kernel, run in interpret mode on the CPU.  On CPU tensors the port's
wrapper runs its plain PyTorch version; the CUDA kernel is compared with
that plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops.pallas import ns as jns
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns

SHAPES = [(256, 32), (512, 64)]
MODES = {
    "robust": dict(robust=True),
    "robust_mid": dict(robust=True, chain_mid=True),
    "plain": dict(iters=10),
    "plain_mid": dict(iters=10, chain_mid=True),
    "graded_robust": dict(robust=True),
}


def _panel(shape, graded):
    P = np.random.default_rng(shape[1]).random(shape, dtype=np.float32) - 0.5
    if graded:  # columns graded over three decades: cond(P) ~ 1e3
        P = (P * np.logspace(0, -3, shape[1])).astype(np.float32)
    return P


def _canary_ok(resid, robust):
    # the drivers' convention: robust chains report the exact residual
    # (scaled by 1e-2), plain chains the one-behind value (squared)
    est = 0.01 * resid if robust else resid * resid
    return est < 1e-4


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_panel_qr_fused_matches_jax(shape, mode):
    # fp32 Gram, chains and tall products in both packages: only the
    # summation order differs, so Q and t agree at atol 1e-4, and the
    # canary class of the residual agrees.
    kw = MODES[mode]
    P = _panel(shape, graded=mode.startswith("graded"))
    Qj, tj, rj = jns.panel_qr_fused(jnp.asarray(P), interpret=True,
                                    fuse_xw=True, **kw)
    Qt, tt, rt = tns.panel_qr_fused(torch.from_numpy(P), **kw)
    np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    robust = kw.get("robust", False)
    assert _canary_ok(float(rt), robust) == _canary_ok(float(rj), robust)
    assert _canary_ok(float(rt), robust), float(rt)
    assert np.allclose(np.tril(tt.numpy(), -1), 0.0)
    # the factorization itself: P = Q t to fp32 roundoff
    rec = np.abs(Qt.double().numpy() @ tt.double().numpy() - P).max()
    assert rec < 1e-4 * np.abs(P).max(), rec


def test_panel_qr_fused_robust_stalled_canary():
    # An exactly rank-deficient panel: the robust chain cannot converge and
    # both packages' residuals fall in the poison class.
    P = _panel((256, 32), graded=False)
    P[:, 5] = 0.0
    P[:, 9] = P[:, 3]
    _, _, rj = jns.panel_qr_fused(jnp.asarray(P), robust=True, interpret=True)
    _, _, rt = tns.panel_qr_fused(torch.from_numpy(P), robust=True)
    assert not _canary_ok(float(rj), True)
    assert not _canary_ok(float(rt), True)


def test_panel_qr_fused_cpu_plain_and_device_guard():
    # CPU tensors run the plain version and count no launch; a tensor that
    # is neither on the CPU nor on CUDA is refused.
    tns.reset_launches()
    tns.panel_qr_fused(torch.from_numpy(_panel((256, 32), False)),
                       robust=True)
    assert tns.LAUNCHES["panel_qr_fused"] == 0
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tns.panel_qr_fused(torch.empty((256, 32), device="meta"))
