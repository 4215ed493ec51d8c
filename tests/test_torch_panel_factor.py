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


# (m, w, max_cluster) -> (cluster, rows, in_smem): 128 rows per CTA aimed
# at, more CTAs while the rows do not fit, the in-place route past what
# max_cluster CTAs of at most 405 rows (w = 128) hold.
LAYOUTS = {
    (80, 80, 8): (1, 80, True), (80, 80, 16): (1, 80, True),
    (2048, 128, 8): (8, 256, True), (2048, 128, 16): (16, 128, True),
    (4096, 128, 8): (8, 512, False), (4096, 128, 16): (16, 256, True),
    (7000, 128, 8): (8, 875, False), (7000, 128, 16): (16, 438, False),
    (8192, 128, 8): (8, 1024, False), (8192, 128, 16): (16, 512, False),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_panel_layout(case):
    m, w, max_cluster = case
    lay = tpanel.panel_layout(m, w, max_cluster)
    assert (lay.cluster, lay.rows, lay.in_smem) == LAYOUTS[case]
    assert lay.cluster * lay.rows >= m > (lay.cluster - 1) * lay.rows
    assert lay.smem_bytes <= tpanel.SMEM_LIMIT == 232448
    # The kernel's carve-out: fixed floats, the reflector's and the next
    # column's entries, and the rows (shared-memory route) or at least G
    # (w x w).
    held = lay.rows * w if lay.in_smem else 0
    assert lay.smem_bytes == 4 * (tpanel._FIXED_FLOATS
                                  + 2 * (-(-lay.rows // 4) * 4)
                                  + max(held, w * w))
    if not lay.in_smem:
        # the rows would not have fit
        assert tpanel._smem_bytes(w, lay.rows, True) > tpanel.SMEM_LIMIT


def test_panel_layout_rejects_what_the_kernel_does_not_take():
    for m, w, mc in ((128, 129, 16), (64, 80, 16), (2048, 128, 17),
                     (2048, 128, 0)):
        with pytest.raises(ValueError, match="panel_layout"):
            tpanel.panel_layout(m, w, mc)


@pytest.mark.parametrize("device_type, dtype, w, fused", [
    ("cuda", torch.float32, 128, True),
    ("cuda", torch.float32, 64, True),
    ("cpu", torch.float32, 128, False),
    ("cuda", torch.float64, 128, False),
    ("cuda", torch.float32, 129, True),
    ("cuda", torch.bfloat16, 128, False),
])
def test_householder_routes_every_cuda_fp32_panel_to_k6_at_any_width(
        device_type, dtype, w, fused):
    # The width w no longer decides: K6 takes every fp32 panel on the card,
    # those wider than 128 by its wide route.
    from mixedprecisionblockqr_tpu_torch.ops import blockqr as tbq
    assert tbq._householder_fused(device_type, dtype) is fused


def test_householder_tier_on_cpu_runs_the_plain_loop(monkeypatch):
    # On CPU tensors 'householder' never reaches K6's wrapper: the parity
    # tests against the reference keep the reference's column loop.
    from mixedprecisionblockqr_tpu_torch.ops import blockqr as tbq

    def no_k6(panel):
        raise AssertionError("K6 reached on the CPU")

    monkeypatch.setattr(tbq, "panel_factor_fused", no_k6)
    A = torch.from_numpy(_panel(96, 64, 6))
    Q, R = tbq.block_qr(A, 32, panel_method="householder")
    assert torch.allclose(Q @ R, A, atol=1e-5)


@pytest.mark.parametrize("m", [2048, 4096, 8192])
def test_panel_factor_bound_uses_the_kernels_cluster(m):
    from mixedprecisionblockqr_tpu_torch.utils import bounds

    row = bounds.panel_factor_bound(m, 128)
    assert row["cluster_sms"] == tpanel.panel_layout(m, 128).cluster == 16
    ops = bounds.householder_panel_ops(m, 128)
    assert row["cluster_bound_ms"] == pytest.approx(
        ops * bounds.SMS / 16 / bounds.PEAK_F32 * 1e3, rel=1e-12)
    assert row["bound_ms"] == pytest.approx(
        ops / bounds.PEAK_F32 * 1e3, rel=1e-12)
    assert bounds.panel_factor_bound(m, 128, 8)["cluster_sms"] == 8


def test_panel_factor_entry_takes_the_layout():
    # The C entry takes P, V, T, G (scratch), R, m, w, the layout's four
    # numbers and the stream; the cluster query takes the shared memory
    # size and an out pointer.
    import ctypes

    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build._declare(Lib())
    args = lib.mpbqr_panel_factor.argtypes
    assert args.count(ctypes.c_void_p) == 6
    assert args.count(ctypes.c_int) == 6 and len(args) == 12
    assert len(lib.mpbqr_panel_factor_max_cluster.argtypes) == 2
