"""The port's Householder tier against the JAX package on the CPU:
reflectors, unblocked QR, the panel factor, the compact-WY functions, the
blocked ``'householder'`` driver (``block_qr``/``block_qr_qtb``), CPU
``auto`` dispatch, ``qr()``'s unblocked path and the ``check='sync'``
retry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.ops import blockqr as jbq
from mixedprecisionblockqr_tpu.ops import householder as jhh
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu.ops import wy as jwy
from mixedprecisionblockqr_tpu_torch.ops import householder as thh
from mixedprecisionblockqr_tpu_torch.ops import wy as twy

# fp32, same operations, summation order only: 1e-5 of the entries'
# scale (max(1, max|x|)).
ATOL = 1e-5


def _mat(m, n, seed=0):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def _close(t, j, atol=ATOL):
    j = np.asarray(j, np.float64)
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * scale)


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return np.linalg.norm(np.asarray(t, np.float64) - j) / np.linalg.norm(j)


@pytest.mark.parametrize("x,k", [
    ([0.0, 0.0, 2.0], 0),         # the reference's convention example
    ([3.0, -1.0, 2.0, 5.0], 1),   # negative pivot entry
    ([1.0, 0.0, 0.0, 0.0], 2),    # numerically zero live part: the skip
])
def test_householder_reflector_matches_jax(x, k):
    x = np.asarray(x, np.float32)
    wt, bt, rt = thh.householder_reflector(torch.from_numpy(x), k)
    wj, bj, rj = jhh.householder_reflector(jnp.asarray(x), k)
    _close(wt.numpy(), wj)
    assert float(bt) == float(bj) and abs(float(rt) - float(rj)) < 1e-6


@pytest.mark.parametrize("shape", [(60, 40), (40, 60), (50, 50)])
@pytest.mark.parametrize("mode", ["reduced", "complete", "raw"])
def test_householder_qr_matches_jax(shape, mode):
    a = _mat(*shape)
    out_t = thh.householder_qr(torch.from_numpy(a), mode=mode)
    out_j = jhh.householder_qr(jnp.asarray(a), mode=mode)
    for t, j in zip(out_t, out_j):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t.numpy(), j)


def test_householder_qr_zero_column_skip():
    # A zero live column keeps beta = 0 and R's diagonal entry 0 (the
    # exact pivoted tier and rank-deficient inputs rely on it).
    a = _mat(30, 20, seed=1)
    a[:, 7] = 0.0
    V, beta = thh.householder_qr(torch.from_numpy(a), mode="raw")
    Q, R = thh.householder_qr(torch.from_numpy(a), mode="reduced")
    Vj, bj = jhh.householder_qr(jnp.asarray(a), mode="raw")
    _close(beta.numpy(), bj)
    _close(V.numpy(), Vj)
    assert np.isfinite(R.numpy()).all()
    np.testing.assert_allclose((Q @ R).numpy(), a, atol=1e-5)


# A full panel, and a narrow one as the ragged last panel of a blocked
# factorization gives it (w = n - lam < r).
@pytest.mark.parametrize("shape", [(96, 32), (130, 17)])
def test_panel_factor_matches_jax(shape):
    p = _mat(*shape, seed=2)
    Vt, Tt, Rt = thh.panel_factor(torch.from_numpy(p))
    Vj, Tj, Rj = jhh.panel_factor(jnp.asarray(p))
    _close(Vt.numpy(), Vj)
    _close(Tt.numpy(), Tj)
    # below the diagonal the panel holds rounding residue in both packages
    _close(np.triu(Rt.numpy()), np.triu(np.asarray(Rj)))


@pytest.mark.parametrize("num_cols", [0, 5, 16])
def test_panel_factor_num_cols_matches_jax(num_cols):
    """``num_cols`` masks the trailing columns: reflectors for the first
    ``num_cols`` only, V and T zero beyond them."""
    P = _mat(80, 24, seed=7)
    outs_t = thh.panel_factor(torch.from_numpy(P), num_cols=num_cols)
    outs_j = jhh.panel_factor(jnp.asarray(P), num_cols=num_cols)
    for t, j in zip(outs_t, outs_j):
        _close(t.numpy(), j)
    V, T, _ = outs_t
    assert not V[:, num_cols:].any() and not T[:, num_cols:].any()


def test_wy_functions_match_jax():
    p = _mat(96, 32, seed=3)
    c = _mat(96, 48, seed=4)
    V, beta = thh.householder_qr(torch.from_numpy(p), mode="raw")
    Vj, bj = jhh.householder_qr(jnp.asarray(p), mode="raw")
    T = twy.build_t_matrix(V, beta)
    Tj = jwy.build_t_matrix(Vj, bj)
    _close(T.numpy(), Tj)
    for t, j in zip(twy.wy_representation(V, beta),
                    jwy.wy_representation(Vj, bj)):
        _close(t.numpy(), j)
    for pol_t, pol_j in ((pt.POLICY_FP32, jpolicy.POLICY_FP32),):
        _close(twy.apply_block_reflector_left_t(torch.from_numpy(c), V, T,
                                                pol_t).numpy(),
               jwy.apply_block_reflector_left_t(jnp.asarray(c), Vj, Tj,
                                                pol_j), atol=1e-4)
        _close(twy.apply_block_reflector_right(torch.from_numpy(c.T), V, T,
                                               pol_t).numpy(),
               jwy.apply_block_reflector_right(jnp.asarray(c.T), Vj, Tj,
                                               pol_j), atol=1e-4)
    _close(twy.reduced_q_from_vt(V, T, 40).numpy(),
           jwy.reduced_q_from_vt(Vj, Tj, 40))


# 256 x 200 at r = 64: three full panels and a ragged last one (w = 8).
@pytest.fixture(scope="module")
def ragged():
    return (np.random.default_rng(5).random((256, 200), dtype=np.float32)
            - 0.5)


@pytest.mark.parametrize("pol", ["fp32", "mixed"])
def test_block_qr_householder_matches_jax(ragged, pol):
    Qt, Rt = pt.block_qr(torch.from_numpy(ragged), 64,
                         pt.policy_by_name(pol), mode="complete",
                         panel_method="householder")
    Qj, Rj = jbq.block_qr(jnp.asarray(ragged), 64,
                          jpolicy.policy_by_name(pol), mode="complete",
                          panel_method="householder")
    assert Qt.shape == (256, 256) and Rt.shape == (256, 200)
    bits = 23 if pol == "fp32" else 8
    rt = pt.metrics.evaluate(torch.from_numpy(ragged), Qt, Rt, bits)
    rj = jmetrics.evaluate(ragged, np.asarray(Qj, np.float32),
                           np.asarray(Rj, np.float32), precision_bits=bits)
    assert rt.all_ok and rt.tight_ok, str(rt)
    if pol == "fp32":
        _close(Qt.numpy(), Qj, atol=1e-4)
        _close(Rt.numpy(), Rj, atol=1e-4)
    else:
        # bf16 roundings of the trailing products differ between the
        # packages: the metric triple within 2x of the JAX one.
        for f in ("backward", "orthogonality"):
            vt, vj = getattr(rt, f), getattr(rj, f)
            assert vt <= 2 * vj + 1e-9 and vj <= 2 * vt + 1e-9, (f, vt, vj)


@pytest.mark.parametrize("pol", ["fp32", "mixed"])
def test_block_qr_qtb_matches_jax(ragged, pol):
    b = np.random.default_rng(6).standard_normal((256, 3)).astype(np.float32)
    Rt, qt = pt.block_qr_qtb(torch.from_numpy(ragged), torch.from_numpy(b),
                             64, pt.policy_by_name(pol))
    Rj, qj = jbq.block_qr_qtb(jnp.asarray(ragged), jnp.asarray(b), 64,
                              jpolicy.policy_by_name(pol))
    assert Rt.shape == (200, 200) and qt.shape == (256, 3)
    if pol == "fp32":  # summation order only
        _close(Rt.numpy(), Rj, atol=1e-4)
        _close(qt.numpy(), qj, atol=1e-4)
    else:
        # bf16 trailing products, whose roundings differ between the
        # packages: normwise within 1e-2, a few bf16 units (2^-8 = 3.9e-3).
        assert _rel(Rt.numpy(), Rj) <= 1e-2
        assert _rel(qt.numpy(), qj) <= 1e-2
    # vector right-hand side: squeezed like the JAX package
    R1, q1 = pt.block_qr_qtb(torch.from_numpy(ragged),
                             torch.from_numpy(b[:, 0]), 64,
                             pt.policy_by_name(pol))
    assert q1.shape == (256,)
    _close(q1.numpy(), qt[:, 0].numpy(), atol=1e-6)


def test_cpu_auto_dispatch_runs_householder(ragged):
    # Off the accelerator auto resolves to 'householder', as in JAX.
    a = torch.from_numpy(ragged)
    Qa, Ra = pt.block_qr(a, 64, pt.POLICY_FP32, panel_method="auto")
    Qh, Rh = pt.block_qr(a, 64, pt.POLICY_FP32, panel_method="householder")
    torch.testing.assert_close(Ra, Rh, rtol=0, atol=0)
    torch.testing.assert_close(Qa, Qh, rtol=0, atol=0)
    Qq, Rq = pt.qr(a, 64, policy=pt.POLICY_MIXED)
    assert pt.metrics.evaluate(a, Qq, Rq, 8).all_ok


@pytest.mark.parametrize("shape", [(40, 8), (6, 30)])
def test_qr_unblocked_path_matches_jax(shape):
    # n <= 8 or m < n: the unblocked Householder QR (k = min(m, n)).
    a = _mat(*shape, seed=7)
    Qt, Rt = pt.qr(torch.from_numpy(a))
    Qj, Rj = jbq.qr(jnp.asarray(a))
    k = min(shape)
    assert Qt.shape == (shape[0], k) and Rt.shape == (k, shape[1])
    _close(Qt.numpy(), Qj)
    _close(Rt.numpy(), Rj)


def _zerocol_matrix(col):
    a = np.random.default_rng(0).standard_normal((512, 512)).astype(
        np.float32)
    a[:, col] = 0.0
    return a


def test_sync_recovers_rank_deficient_bgs1():
    # tests/test_scale_and_sync.py::test_sync_recovers_rank_deficient[bgs1]
    # on the port: the zero column poisons bgs1, and check='sync' retries
    # transparently through the Householder tier.
    a = _zerocol_matrix(300)
    _, Rd = pt.block_qr(torch.from_numpy(a), 64, pt.POLICY_MIXED,
                        panel_method="bgs1")
    assert not torch.isfinite(Rd[0, 0])
    Q, R = pt.block_qr(torch.from_numpy(a), 64, pt.POLICY_MIXED,
                       panel_method="bgs1", check="sync")
    assert torch.isfinite(R).all()
    rep = pt.metrics.evaluate(torch.from_numpy(a), Q, R, 8)
    assert rep.all_ok, str(rep)


def test_qtb_sync_recovers_rank_deficient_bgs1():
    a = _zerocol_matrix(300)
    b = np.random.default_rng(1).standard_normal((512,)).astype(np.float32)
    Rd, qd = pt.block_qr_qtb(torch.from_numpy(a), torch.from_numpy(b), 64,
                             pt.POLICY_MIXED, panel_method="bgs1")
    assert not torch.isfinite(Rd[0, 0]) and not torch.isfinite(qd[0])
    R, qtb = pt.block_qr_qtb(torch.from_numpy(a), torch.from_numpy(b), 64,
                             pt.POLICY_MIXED, panel_method="bgs1",
                             check="sync")
    assert torch.isfinite(R).all() and torch.isfinite(qtb).all()
    Rh, qh = pt.block_qr_qtb(torch.from_numpy(a), torch.from_numpy(b), 64,
                             pt.POLICY_MIXED, panel_method="householder")
    torch.testing.assert_close(R, Rh, rtol=0, atol=0)
    torch.testing.assert_close(qtb, qh, rtol=0, atol=0)


def test_sync_raises_on_nonfinite_input():
    a = _mat(256, 256, seed=8)
    a[3, 5] = np.nan
    with pytest.raises(pt.NonFiniteError, match="householder"):
        pt.block_qr(torch.from_numpy(a), 64, pt.POLICY_MIXED,
                    panel_method="bgs1", check="sync")
    with pytest.raises(pt.NonFiniteError):
        pt.block_qr_qtb(torch.from_numpy(a), torch.ones(256), 64,
                        check="sync")
