"""The port's ``polar`` tier against the JAX package on the CPU: the
panel compositions ``tri_cholqr_fused`` / ``tri_cholqr_robust_fused``
(with the Yamamoto sign fix) against the JAX ones in interpret mode, and
``block_qr``/``block_qr_qtb`` with ``panel_method='polar'``.

On the CPU the JAX polar driver runs its XLA branch (``tri_cholqr``,
``tri_cholqr_robust``, ``newton_inv``) while the port runs K1's and K4's
plain versions: the same iterations with another product order (the fused
X/W update), so the fp32 factors agree to roundoff: 1e-5 of the entries'
scale.  Mixed policies are held to the metric triple within 2x.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.models import lstsq as jlstsq
from mixedprecisionblockqr_tpu.ops import blockqr as jbq
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu.ops.pallas import ns as jns
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns

ATOL = 1e-5


def _close(t, j, atol=ATOL):
    j = np.asarray(j, np.float64)
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * scale)


@pytest.mark.parametrize("m,r,iters", [(512, 64, 6), (256, 32, 12),
                                       (1024, 128, 7)])
def test_tri_cholqr_fused_matches_jax(m, r, iters):
    # Gram -> K1 chain -> sign fix -> Q: the same composition in both
    # packages; only the chain's fp32 summation order differs.
    P = np.random.default_rng(1).random((m, r), dtype=np.float32) - 0.5
    out_t = tns.tri_cholqr_fused(torch.from_numpy(P), iters=iters)
    out_j = jns.tri_cholqr_fused(jnp.asarray(P), iters=iters,
                                 sign_fix=True, interpret=True)
    for t, j in zip(out_t[:3], out_j[:3]):
        _close(t.numpy(), j, atol=1e-4)
    assert (float(out_t[3]) ** 2 < 1e-4) == (float(out_j[3]) ** 2 < 1e-4)
    Q, t = out_t[0].double().numpy(), out_t[1].double().numpy()
    np.testing.assert_allclose(Q @ t, P, atol=1e-5)
    assert (np.diag(Q[:r]) <= 0).all()


def test_tri_cholqr_robust_fused_sign_fix_matches_jax():
    # cond 1e4 tail-class panel: the three passes amplify the roundoff
    # difference, so the check is quality (as test_torch_ns.py's robust
    # composition test) plus the sign convention on both.
    rng = np.random.default_rng(4)
    U, _ = np.linalg.qr(rng.standard_normal((256, 128)))
    V, _ = np.linalg.qr(rng.standard_normal((128, 128)))
    P = ((U * np.logspace(0, -4, 128)) @ V.T).astype(np.float32)
    Qt, tt, Xt, rt = tns.tri_cholqr_robust_fused(torch.from_numpy(P),
                                                 sign_fix=True)
    Qj, tj, _, rj = jns.tri_cholqr_robust_fused(jnp.asarray(P), sign_fix=True,
                                                interpret=True)
    Qt64, Qj64 = Qt.double().numpy(), np.asarray(Qj, np.float64)
    assert (np.diag(Qt64[:128]) <= 0).all()
    assert (np.diag(Qj64[:128]) <= 0).all()
    orth_t = np.abs(Qt64.T @ Qt64 - np.eye(128)).max()
    orth_j = np.abs(Qj64.T @ Qj64 - np.eye(128)).max()
    assert orth_t < max(5e-5, 2 * orth_j), (orth_t, orth_j)
    assert np.abs(Qt64 @ tt.double().numpy() - P).max() < 1e-4
    np.testing.assert_allclose(Qt64, P @ Xt.double().numpy(), atol=1e-3)
    assert np.sign(np.diag(tt.numpy())).tolist() == \
        np.sign(np.diag(np.asarray(tj))).tolist()
    assert float(rt) < 1e-2 and float(rj) < 1e-2


@pytest.mark.parametrize("g", [1, 4])
def test_polar_square_fp32_matches_jax(g):
    # tests/test_polar.py: 512^2, r = 64 -- tall panels, then the square
    # final panel in the W-form (no inversion).
    a = np.random.default_rng(4).standard_normal((512, 512)).astype(
        np.float32)
    Qt, Rt = pt.block_qr(torch.from_numpy(a), 64, pt.POLICY_FP32,
                         mode="complete", panel_method="polar",
                         group_panels=g)
    Qj, Rj = jbq.block_qr(jnp.asarray(a), 64, jpolicy.POLICY_FP32,
                          mode="complete", panel_method="polar",
                          group_panels=g)
    _close(Qt.numpy(), Qj)
    _close(Rt.numpy(), Rj)
    rep = pt.metrics.evaluate(torch.from_numpy(a), Qt, Rt, 23)
    assert rep.all_ok and rep.orthogonality < 8e-5 and rep.backward < 8e-5


def test_polar_tail_panels_fp32_matches_jax():
    # 320 x 256 at r = 64: the last two panels have aspect < 2 and take the
    # shifted three-pass robust chain; the LU fallback is armed (aspect <
    # 4) on every panel.
    a = np.random.default_rng(6).random((320, 256), dtype=np.float32) - 0.5
    Qt, Rt = pt.block_qr(torch.from_numpy(a), 64, pt.POLICY_FP32,
                         mode="complete", panel_method="polar")
    Qj, Rj = jbq.block_qr(jnp.asarray(a), 64, jpolicy.POLICY_FP32,
                          mode="complete", panel_method="polar")
    _close(Qt.numpy(), Qj, atol=1e-4)
    _close(Rt.numpy(), Rj, atol=1e-4)
    rep = pt.metrics.evaluate(torch.from_numpy(a), Qt, Rt, 23)
    assert rep.all_ok, str(rep)


@pytest.mark.parametrize("shape,r,g", [((768, 512), 128, 4),
                                       ((512, 512), 64, 8)])
def test_polar_mixed_quality_matches_jax(shape, r, g):
    # Tall complete (the auto-dispatched tall complete-Q case) and square.
    a = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    Qt, Rt = pt.block_qr(torch.from_numpy(a), r, pt.POLICY_MIXED,
                         mode="complete", panel_method="polar",
                         group_panels=g)
    Qj, Rj = jbq.block_qr(jnp.asarray(a), r, jpolicy.POLICY_MIXED,
                          mode="complete", panel_method="polar",
                          group_panels=g)
    assert Qt.shape == (shape[0], shape[0])
    rt = pt.metrics.evaluate(torch.from_numpy(a), Qt, Rt, 8)
    rj = jmetrics.evaluate(a, np.asarray(Qj, np.float32),
                           np.asarray(Rj, np.float32), precision_bits=8)
    assert rt.all_ok and rt.tight_ok and rj.all_ok, (str(rt), str(rj))
    for f in ("backward", "orthogonality"):
        vt, vj = getattr(rt, f), getattr(rj, f)
        assert vt <= 2 * vj + 1e-9 and vj <= 2 * vt + 1e-9, (f, vt, vj)


def test_polar_qtb_matches_jax():
    # tests/test_polar.py's least-squares path: 640 x 512, r = 64.
    rng = np.random.default_rng(5)
    a = rng.standard_normal((640, 512)).astype(np.float32)
    xt = rng.standard_normal(512).astype(np.float32)
    b = a @ xt
    Rt, qt = pt.block_qr_qtb(torch.from_numpy(a), torch.from_numpy(b), 64,
                             pt.POLICY_FP32, panel_method="polar")
    Rj, qj = jbq.block_qr_qtb(jnp.asarray(a), jnp.asarray(b), 64,
                              jpolicy.POLICY_FP32, panel_method="polar")
    _close(Rt.numpy(), Rj)
    _close(qt.numpy(), qj)
    x = pt.back_substitution(Rt, qt[:512])
    np.testing.assert_allclose(x.numpy(), xt, atol=5e-3)
    xj = np.asarray(jlstsq.back_substitution(Rj, qj[:512]))
    np.testing.assert_allclose(x.numpy(), xj, atol=1e-3)


def test_polar_mixed_qtb_matches_jax():
    a = np.random.default_rng(8).standard_normal((768, 512)).astype(
        np.float32)
    b = np.random.default_rng(9).standard_normal((768, 3)).astype(np.float32)
    Rt, qt = pt.block_qr_qtb(torch.from_numpy(a), torch.from_numpy(b), 128,
                             pt.POLICY_MIXED, panel_method="polar")
    Rj, qj = jbq.block_qr_qtb(jnp.asarray(a), jnp.asarray(b), 128,
                              jpolicy.POLICY_MIXED, panel_method="polar")
    # bf16 trailing products round differently, and the sign fix reads the
    # sign of near-zero diagonal entries of Q's top block, so a few rows of
    # R (and of Q^T B) may come out negated -- an equally valid QR.  With
    # the rows' signs normalized by diag(R): normwise within a few bf16
    # units (2^-8 = 3.9e-3); the residual rows by their norm.
    Rt, qt = Rt.double().numpy(), qt.double().numpy()
    Rj, qj = np.asarray(Rj, np.float64), np.asarray(qj, np.float64)
    st, sj = np.sign(np.diag(Rt))[:, None], np.sign(np.diag(Rj))[:, None]
    for t, j in ((st * Rt, sj * Rj), (st * qt[:512], sj * qj[:512])):
        assert np.linalg.norm(t - j) / np.linalg.norm(j) <= 1e-2
    nt, nj = np.linalg.norm(qt[512:]), np.linalg.norm(qj[512:])
    assert abs(nt - nj) <= 1e-2 * nj


def test_polar_falls_back_like_jax():
    # n not a multiple of r -> cholqr1 (tests/test_polar.py).
    a = np.random.default_rng(6).standard_normal((200, 120)).astype(
        np.float32)
    Qt, Rt = pt.block_qr(torch.from_numpy(a), 64, mode="complete",
                         panel_method="polar")
    Qj, Rj = jbq.block_qr(jnp.asarray(a), 64, mode="complete",
                          panel_method="polar")
    _close(Qt.numpy(), Qj)
    _close(Rt.numpy(), Rj)
    with pytest.raises(ValueError, match="POLICY_FP64"):
        pt.block_qr(torch.from_numpy(a).double(), 64, pt.POLICY_FP64,
                    panel_method="polar")


def test_polar_canary_fires_on_rank_deficiency():
    # A zero column: the tall panel's chain cannot converge, the canary
    # poisons R[0, 0] in both packages, and 'sync' reruns through
    # 'householder'.
    a = np.random.default_rng(0).standard_normal((512, 512)).astype(
        np.float32)
    a[:, 200] = 0.0
    _, Rt = pt.block_qr(torch.from_numpy(a), 64, pt.POLICY_MIXED,
                        panel_method="polar")
    _, Rj = jbq.block_qr(jnp.asarray(a), 64, jpolicy.POLICY_MIXED,
                         panel_method="polar")
    assert not torch.isfinite(Rt[0, 0]) and not np.isfinite(
        np.asarray(Rj)[0, 0])
    Q, R = pt.block_qr(torch.from_numpy(a), 64, pt.POLICY_MIXED,
                       panel_method="polar", check="sync")
    assert torch.isfinite(R).all()
    assert pt.metrics.evaluate(torch.from_numpy(a), Q, R, 8).all_ok
