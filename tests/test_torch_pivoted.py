"""The port's rank-revealing path against the JAX package on the CPU: exact
QP3, RQRCP (with the JAX package's sketch matrices substituted), the
``_check_rqrcp`` contract of ``tests/test_pivoted.py``, ``numerical_rank``,
the exact fallback, and the least-squares solvers on a gauge-deficient
SLAM Jacobian."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.models import lstsq as jlstsq
from mixedprecisionblockqr_tpu.models import slam as jslam
from mixedprecisionblockqr_tpu.ops import pivoted as jpiv
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu_torch.models import slam as tslam
from mixedprecisionblockqr_tpu_torch.ops import pivoted as tpiv
from mixedprecisionblockqr_tpu_torch.utils.datagen import (
    gauge_deficient_system,
)


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return np.linalg.norm(np.asarray(t, np.float64) - j) / np.linalg.norm(j)


def test_exact_qp3_matches_jax():
    # Generic input: the same pivots; Q, R and Q^T B within 1e-5.
    rng = np.random.default_rng(0)
    a = rng.standard_normal((96, 64)).astype(np.float32)
    b = rng.standard_normal((96, 2)).astype(np.float32)
    Rt, Qt, qt, pt_ = tpiv._pivoted_qr_impl(torch.from_numpy(a),
                                            torch.from_numpy(b), True, True)
    Rj, Qj, qj, pj = jpiv._pivoted_qr_impl(jnp.asarray(a), jnp.asarray(b),
                                           True, True)
    np.testing.assert_array_equal(pt_.numpy(), np.asarray(pj))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj), atol=1e-5)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-5)


def _jax_omega(seed, d, m):
    key = jax.random.PRNGKey(seed)
    return lambda gen, j, d_, m_: torch.from_numpy(np.array(
        jax.random.normal(jax.random.fold_in(key, j), (d, m), jnp.float32)))


def test_rqrcp_matches_jax_with_its_sketches(monkeypatch):
    # 1024 x 512, r = 128: the port draws JAX's sketch matrices
    # (fold_in(PRNGKey(0), j)), so the pivots are identical and R and
    # Q^T B agree to 1e-5 normwise.
    rng = np.random.default_rng(1)
    a = rng.standard_normal((1024, 512)).astype(np.float32)
    b = rng.standard_normal((1024, 2)).astype(np.float32)
    monkeypatch.setattr(tpiv, "_sketch_matrix", _jax_omega(0, 136, 1024))
    Rt, _, qt, pt_, wt = tpiv._rqrcp_impl(torch.from_numpy(a),
                                          torch.from_numpy(b), False, True,
                                          128, 8, 0)
    Rj, _, qj, pj, wj = jpiv._rqrcp_impl(jnp.asarray(a), jnp.asarray(b),
                                         False, True, 128, 8, 0, False)
    np.testing.assert_array_equal(pt_.numpy(), np.asarray(pj))
    assert _rel(Rt.numpy(), Rj) <= 1e-5
    assert _rel(qt.numpy(), qj) <= 1e-5
    assert float(wt) < 1e-4 and float(wj) < 1e-4


def _check_rqrcp(a, block_size=128, rtol=5e-6):
    # tests/test_pivoted.py::_check_rqrcp on the port
    Q, R, perm = pt.pivoted_qr(torch.from_numpy(a), mode="reduced",
                               method="rqrcp", block_size=block_size)
    Q, R = Q.double().numpy(), R.double().numpy()
    perm = perm.numpy()
    m, n = a.shape
    k = min(m, n)
    scale = max(np.linalg.norm(a), 1e-30)
    assert np.linalg.norm(a[:, perm] - Q @ R) / scale < rtol
    assert np.max(np.abs(Q.T @ Q - np.eye(k))) < rtol
    assert sorted(perm.tolist()) == list(range(n))
    d = np.abs(np.diag(R))
    runmax = np.maximum.accumulate(d)[:-1]
    assert np.all(d[1:] <= 1.3 * runmax + rtol * (d[0] + 1e-30))
    return Q, R, perm


def test_rqrcp_contract_full_rank_and_graded():
    rng = np.random.default_rng(2)
    _check_rqrcp(rng.standard_normal((640, 512)).astype(np.float32))
    g = (rng.standard_normal((512, 512)) * np.logspace(0, -8, 512)).astype(
        np.float32)
    _, R, _ = _check_rqrcp(g, rtol=2e-5)
    r_port = pt.numerical_rank(R, m=512, device="cpu")
    r_jax = jpiv.numerical_rank(jnp.asarray(R.astype(np.float32)), m=512)
    assert r_port == r_jax


def test_rqrcp_exactly_singular_falls_back_to_exact():
    # Exactly-zero trailing panels poison the robust panels; the public
    # wrapper retries through exact QP3 and still reveals the rank.
    rng = np.random.default_rng(3)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    a[:, 100] = 0.0
    a[:, 200] = a[:, 50]
    a[:, 300:] = 0.0  # rank = 300 - 2
    _, _, _, _, worst = tpiv._rqrcp_impl(torch.from_numpy(a), None, False,
                                         False, 128, 8, 0)
    assert not float(worst) < 1e-4
    _, R, _ = _check_rqrcp(a)
    assert pt.numerical_rank(R, m=512, device="cpu") == 298


def test_numerical_rank_keys_on_max_diagonal():
    eps = np.finfo(np.float32).eps
    d = np.zeros((4, 4), np.float32)
    np.fill_diagonal(d, [0.8, 1.0, 0.5, eps * 4 * 0.9])
    assert pt.numerical_rank(torch.from_numpy(d)) == 3
    assert pt.numerical_rank(d, rcond=0.6, device="cpu") == 2
    assert jpiv.numerical_rank(jnp.asarray(d)) == 3


def test_pivoted_dispatch_and_guards():
    a = np.random.default_rng(4).standard_normal((96, 100)).astype(
        np.float32)
    with pytest.raises(ValueError):
        pt.pivoted_qr(torch.from_numpy(a), method="rqrcp", block_size=128)
    with pytest.raises(ValueError):
        pt.pivoted_qr(torch.ones((256, 256)), mode="complete",
                      method="rqrcp", block_size=64)
    # wide input: exact tier, complete Q
    Q, R, perm = pt.pivoted_qr(torch.from_numpy(a), mode="complete")
    assert Q.shape == (96, 96) and R.shape == (96, 100)
    np.testing.assert_allclose((Q @ R).numpy(), a[:, perm.numpy()],
                               atol=1e-4)
    assert tpiv._resolve_method("auto", 640, 512, "r", 128) == "rqrcp"
    assert tpiv._resolve_method("auto", 640, 384, "r", 128) == "exact"


@pytest.fixture(scope="module")
def gauge_deficient():
    # Rank 480, as chip_smoke.py's full-size 4096 x 2048 input is 1984.
    J, b = gauge_deficient_system(1024, 512, 32)
    x_np, _, rank, _ = np.linalg.lstsq(
        J.astype(np.float64), -b.astype(np.float64),
        rcond=np.finfo(np.float32).eps * 1024)
    return J, b, x_np, rank


def _resid(J, x, b):
    return np.linalg.norm(J.astype(np.float64) @ np.asarray(x, np.float64)
                          + b)


@pytest.mark.parametrize("entry", ["lstsq", "lstsq_pivoted"])
def test_lstsq_gauge_deficient_matches_jax_and_numpy(gauge_deficient, entry):
    # lstsq's tripwire reroutes to the pivoted path (RQRCP at n = 512):
    # the min-norm solution, x within 1e-4 of numpy's and of JAX's,
    # residual norm within 1e-5 relative.
    J, b, x_np, rank = gauge_deficient
    assert rank == 480
    fn_t = getattr(pt, entry)
    fn_j = getattr(jlstsq, entry)
    x_t = fn_t(torch.from_numpy(J), -torch.from_numpy(b)).numpy()
    x_j = np.asarray(fn_j(J, -b))
    assert _rel(x_t, x_np) <= 1e-4 and _rel(x_t, x_j) <= 1e-4
    r_np = _resid(J, x_np, b)
    assert abs(_resid(J, x_t, b) - r_np) <= 1e-5 * r_np
    R, _, _ = pt.pivoted_qr_qtb(torch.from_numpy(J), -torch.from_numpy(b))
    assert pt.numerical_rank(R, m=1024) == rank


def test_gauss_newton_step_matches_jax(gauge_deficient):
    # POLICY_MIXED: the bf16 trailing updates keep the dependent columns'
    # diagonal above the rank tripwire (6.2e-3 of the max against
    # eps_f32 * 1024 = 1.2e-4), so neither package reroutes: both return a
    # solution whose residual sits ~6% above the fp64 oracle's, with ||x||
    # ~21x the min-norm one (a property of the reference, recorded in
    # PERF.md).  The port reproduces it: residuals within 1% of the JAX
    # package's, x within 2% normwise.
    J, b, x_np, _ = gauge_deficient
    x_t = tslam.gauss_newton_step(torch.from_numpy(J),
                                  torch.from_numpy(b)).numpy()
    x_j = np.asarray(jslam.gauss_newton_step(J, b))
    r_t, r_j = _resid(J, x_t, b), _resid(J, x_j, b)
    assert abs(r_t - r_j) <= 1e-2 * r_j
    assert _rel(x_t, x_j) <= 2e-2
    # damped under POLICY_FP32: the stacked system [J; 0.1 I] is full
    # rank but has cond ~1e3, so x is compared through the residual, which
    # both packages bring within 1e-5 of the fp64 oracle's.
    n = J.shape[1]
    Js = np.concatenate([J, 0.1 * np.eye(n, dtype=np.float32)])
    bs = np.concatenate([b, np.zeros(n, np.float32)])
    x_o = np.linalg.lstsq(Js.astype(np.float64), -bs.astype(np.float64),
                          rcond=None)[0]
    x_t = tslam.gauss_newton_step(torch.from_numpy(J), torch.from_numpy(b),
                                  policy=pt.POLICY_FP32, damping=1e-2)
    x_j = jslam.gauss_newton_step(J, b, policy=jpolicy.POLICY_FP32,
                                  damping=1e-2)
    r_o = _resid(Js, x_o, bs)
    for x in (x_t.numpy(), x_j):
        assert abs(_resid(Js, x, bs) - r_o) <= 1e-5 * r_o


def test_lstsq_unported_methods_name_the_roadmap():
    a = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (64, 16)).astype(np.float32))
    # method='tsqr' and refine_steps are ported: they solve (fp32 against
    # the float64 oracle, a well-conditioned 64 x 16 system: 1e-4).
    want = np.linalg.lstsq(a.numpy().astype(np.float64), np.ones(64),
                           rcond=None)[0]
    for kw in ({"method": "tsqr"}, {"refine_steps": 1}):
        x = pt.lstsq(a, torch.ones(64), **kw)
        np.testing.assert_allclose(x.numpy(), want, atol=1e-4)
    # The Euroc-MAV file branch is ported: a case with a path loads the
    # file as the JAX package parses it.
    sample = os.path.join(os.path.dirname(__file__), "data",
                          "A_000000100.txt")
    a = tslam.JacobianCase("A_000000100.txt", 12, 9, path=sample).load()
    want = jslam.JacobianCase("A_000000100.txt", 12, 9, path=sample).load()
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, want)
    cases = tslam.enumerate_jacobians(synthetic_sizes=[(64, 32)])
    assert cases[0].load().shape == (64, 32)
