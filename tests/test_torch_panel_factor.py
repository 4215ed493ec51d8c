"""``panel_factor_fused`` (kernel K6) of the port against the JAX package's
Pallas kernel, run in interpret mode on the CPU.  On CPU tensors the port's
wrapper runs its plain PyTorch version (a transcription of the Pallas
kernel); the CUDA kernel is compared with that plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops.pallas import panel as jpanel
from mixedprecisionblockqr_tpu_torch.ops import householder as thh
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.ops.kernels import panel as tpanel


def _close(t, j, atol):
    # atol of the entries' scale, max(1, max|x|)
    j = np.asarray(j, np.float64)
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * scale)


def _panel(m, w, seed):
    return np.random.default_rng(seed).random((m, w), dtype=np.float32) - 0.5


# Square (the hybrid rule's last panel), tall, and ragged widths (the last
# panel of an n % r != 0 matrix).
SHAPES = [(64, 64), (256, 32), (130, 17), (208, 48), (80, 80)]


@pytest.mark.parametrize("shape", SHAPES)
def test_panel_factor_fused_matches_jax(shape):
    # The same column loop in both packages; fp32 summation order only:
    # 1e-5 of the entries' scale for V and T, 1e-4 for R
    # (tests/test_pallas_kernels.py:56-72 uses the same pair).
    P = _panel(*shape, seed=2)
    Vt, Tt, Rt = tpanel.panel_factor_fused(torch.from_numpy(P))
    Vj, Tj, Rj = jpanel.panel_factor_fused(jnp.asarray(P), interpret=True)
    _close(Vt.numpy(), Vj, 1e-5)
    _close(Tt.numpy(), Tj, 1e-5)
    _close(Rt.numpy(), Rj, 1e-4)
    # and against the plain column loop of the Householder tier
    Vh, Th, Rh = thh.panel_factor(torch.from_numpy(P))
    _close(Vt.numpy(), Vh.numpy(), 1e-5)
    _close(Tt.numpy(), Th.numpy(), 1e-5)
    _close(np.triu(Rt.numpy()), np.triu(Rh.numpy()), 1e-4)


def test_panel_factor_fused_zero_column_matches_jax():
    # A zero live column: beta = 0, a zero reflector, and Q^T P = R.
    P = np.zeros((64, 8), np.float32)
    P[:, ::2] = np.random.default_rng(3).random((64, 4))
    Vt, Tt, Rt = tpanel.panel_factor_fused(torch.from_numpy(P))
    Vj, Tj, Rj = jpanel.panel_factor_fused(jnp.asarray(P), interpret=True)
    assert np.isfinite(Vt.numpy()).all()
    for t, j in ((Vt, Vj), (Tt, Tj), (Rt, Rj)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    Vn, Tn = Vt.double().numpy(), Tt.double().numpy()
    Qp = np.eye(64) - Vn @ Tn @ Vn.T
    np.testing.assert_allclose(Qp.T @ P, Rt.numpy(), atol=1e-5)
    assert Tt[1, 1] == 0.0 and Tt[3, 3] == 0.0


@pytest.mark.parametrize("where", [(3, 5), (200, 0), (0, 0)])
def test_panel_factor_fused_nan_reaches_r(where):
    # The blocked drivers' canary funnels sum(Rp * 0): an input NaN must
    # survive into R (V and T may stay finite), in both packages alike.
    P = _panel(256, 32, seed=4)
    P[where] = np.nan
    Vt, Tt, Rt = tpanel.panel_factor_fused(torch.from_numpy(P))
    Vj, Tj, Rj = jpanel.panel_factor_fused(jnp.asarray(P), interpret=True)
    assert torch.isnan(Rt).any() and np.isnan(np.asarray(Rj)).any()
    np.testing.assert_array_equal(np.isnan(np.triu(Rt.numpy())),
                                  np.isnan(np.triu(np.asarray(Rj))))
    np.testing.assert_array_equal(np.isnan(Vt.numpy()),
                                  np.isnan(np.asarray(Vj)))
    np.testing.assert_array_equal(np.isnan(Tt.numpy()),
                                  np.isnan(np.asarray(Tj)))


def test_panel_factor_fused_cpu_never_counts_and_rejects_others():
    tns.reset_launches()
    tpanel.panel_factor_fused(torch.from_numpy(_panel(64, 16, 5)))
    assert tns.LAUNCHES["panel_factor_fused"] == 0
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpanel.panel_factor_fused(torch.empty((64, 16), device="meta"))
