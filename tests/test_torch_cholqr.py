"""The port's CholeskyQR pieces and tiers against the JAX package on the
CPU: ``cholesky_qr2``, ``newton_inv``, ``yamamoto_reflector``, the cholqr
and ``householder_pallas`` branches of ``_block_qr_traced`` (the hybrid
rule, the ``cholqr1x2`` pair mode), the cholqr scan tier,
``block_recursive_qr``, ``block_qr_batched`` and the entry points' device
rule.

Under POLICY_FP32 both packages run the same operations and differ in
summation order only: 1e-5 of the entries' scale (max(1, max|x|)).  Under
mixed policies the bf16 roundings of the trailing products differ, so the
metric triple is held within 2x of the JAX one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.ops import blockqr as jbq
from mixedprecisionblockqr_tpu.ops import cholqr as jcq
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu.utils import checks as jchecks
from mixedprecisionblockqr_tpu.utils.datagen import conditioned_matrix
from mixedprecisionblockqr_tpu_torch.ops import blockqr as tbq
from mixedprecisionblockqr_tpu_torch.ops import cholqr as tcq

ATOL = 1e-5


def _close(t, j, atol=ATOL):
    j = np.asarray(j, np.float64)
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * scale)


def _mat(m, n, seed):
    return np.random.default_rng(seed).random((m, n), dtype=np.float32) - 0.5


@pytest.mark.parametrize("passes,shifted", [(1, False), (2, False),
                                            (2, True)])
def test_cholesky_qr2_matches_jax(passes, shifted):
    P = np.random.default_rng(0).random((512, 64)).astype(np.float32)
    Qt, Rt = pt.cholesky_qr2(torch.from_numpy(P), shifted=shifted,
                             passes=passes)
    Qj, Rj = jcq.cholesky_qr2(jnp.asarray(P), shifted=shifted,
                              passes=passes)
    _close(Qt.numpy(), Qj)
    _close(Rt.numpy(), Rj)
    assert np.allclose(np.tril(Rt.numpy(), -1), 0.0)


def test_cholesky_qr2_shifted_moderate_conditioning():
    # tests/test_cholqr.py: cond 2.5e3, where the shift keeps the second
    # pass inside the fp32 domain.  The Gram squares the condition, so the
    # packages' roundoff differs by ~cond * eps: checked by quality.
    A = conditioned_matrix(96, 2.5e3, seed=1).astype(np.float32)[:, :32]
    Q, R = pt.cholesky_qr2(torch.from_numpy(A), shifted=True)
    Qn = Q.double().numpy()
    np.testing.assert_allclose(Qn.T @ Qn, np.eye(32), atol=1e-4)
    assert np.linalg.norm(Qn @ R.double().numpy() - A) / np.linalg.norm(A) \
        < 1e-5


def test_cholesky_nan_on_singular_gram():
    # jnp.linalg.cholesky returns NaN on a Gram that is not SPD and the NaN
    # canary depends on it; the port turns cholesky_ex's info into NaN
    # instead of raising.
    P = np.random.default_rng(1).random((64, 16)).astype(np.float32)
    P[:, 5] = P[:, 2]
    P[:, 9] = 0.0
    _, Rj = jcq.cholesky_qr2(jnp.asarray(P), passes=1)
    Qt, Rt = pt.cholesky_qr2(torch.from_numpy(P), passes=1)
    assert not np.isfinite(np.asarray(Rj)).all()
    assert not torch.isfinite(Rt).all() and not torch.isfinite(Qt).all()
    G = torch.from_numpy(-np.eye(8, dtype=np.float32))
    R, Rinv = tcq._chol_and_inv(G)
    assert torch.isnan(R).all() and torch.isnan(Rinv).all()


def _yamamoto_S(m, r, seed):
    # A Yamamoto-class S (tests/test_ns_kernel.py:130-146): I - Q1^T with
    # Q1 the sign-fixed top block of an m x r orthonormal basis.
    rng = np.random.default_rng(seed)
    Qb, _ = np.linalg.qr(rng.standard_normal((m, r)))
    Qb = Qb * np.where(np.diag(Qb[:r]) > 0, -1.0, 1.0)[None, :]
    return (np.eye(r) - Qb[:r].T).astype(np.float32)


@pytest.mark.parametrize("iters", [5, 8, 12])
def test_newton_inv_matches_jax(iters):
    S = _yamamoto_S(512, 64, 7)
    Xt = tcq.newton_inv(torch.from_numpy(S), iters=iters)
    Xj = jcq.newton_inv(jnp.asarray(S), iters=iters)
    _close(Xt.numpy(), Xj)


def test_newton_inv_check_falls_back_on_device():
    # The rotation by pi about (1,1,1)/sqrt(3) (ops/cholqr.py:110-115 of the
    # JAX package) made nearly singular: Newton cannot converge, so the
    # residual check takes the LU inverse -- a torch.where, no sync.
    c = np.ones(3) / np.sqrt(3.0)
    Rot = 2.0 * np.outer(c, c) - np.eye(3)
    S = (np.eye(3) - 0.999 * Rot.T).astype(np.float32)
    Xt = tcq.newton_inv(torch.from_numpy(S), iters=6, check=True)
    Xj = jcq.newton_inv(jnp.asarray(S), iters=6, check=True)
    X0 = tcq.newton_inv(torch.from_numpy(S), iters=6)
    assert float((torch.eye(3) - torch.from_numpy(S) @ X0).abs().max()) > 1e-3
    np.testing.assert_allclose(Xt.numpy(), np.linalg.inv(S), rtol=1e-3)
    _close(Xt.numpy(), Xj, atol=1e-4)
    # An exactly singular S: the LU fallback is NaN, as XLA's inverse is
    # non-finite.
    Ssing = np.eye(3, dtype=np.float32) - Rot.T.astype(np.float32)
    assert not torch.isfinite(
        tcq.newton_inv(torch.from_numpy(Ssing), iters=6, check=True)).all()


@pytest.mark.parametrize("inv_method", ["newton", "lu"])
def test_yamamoto_reflector_matches_jax(inv_method):
    P = np.random.default_rng(2).random((96, 16)).astype(np.float32)
    Qt, Rt = pt.cholesky_qr2(torch.from_numpy(P))
    Qj, Rj = jcq.cholesky_qr2(jnp.asarray(P))
    outs_t = tcq.yamamoto_reflector(Qt, Rt, inv_method=inv_method)
    outs_j = jcq.yamamoto_reflector(Qj, Rj, inv_method=inv_method)
    for t, j in zip(outs_t, outs_j):
        _close(t.numpy(), j, atol=1e-4)
    Y, Sinv, Rf = (x.double().numpy() for x in outs_t)
    H = np.eye(96) - Y @ Sinv @ Y.T
    np.testing.assert_allclose(H.T @ H, np.eye(96), atol=1e-5)
    HtP = H.T @ P
    np.testing.assert_allclose(HtP[:16], Rf, atol=1e-4)
    np.testing.assert_allclose(HtP[16:], 0.0, atol=1e-4)


@pytest.mark.parametrize("iters", [2, 9])
def test_yamamoto_reflector_newton_iters_matches_jax(iters):
    """An explicit ``newton_iters`` replaces the aspect rule (96 / 16 = 6:
    8 iterations), in both packages."""
    P = np.random.default_rng(3).random((96, 16)).astype(np.float32)
    Qt, Rt = pt.cholesky_qr2(torch.from_numpy(P))
    Qj, Rj = jcq.cholesky_qr2(jnp.asarray(P))
    outs_t = tcq.yamamoto_reflector(Qt, Rt, inv_method="newton",
                                    newton_iters=iters)
    outs_j = jcq.yamamoto_reflector(Qj, Rj, inv_method="newton",
                                    newton_iters=iters)
    for t, j in zip(outs_t, outs_j):
        _close(t.numpy(), j, atol=1e-4)
    default = tcq.yamamoto_reflector(Qt, Rt, inv_method="newton")[1]
    assert not torch.equal(outs_t[1], default)


def test_newton_iters_for_aspect_matches_jax():
    for a in (1.0, 2.0, 3.99, 4.0, 7.5, 8.0, 32.0):
        assert tcq.newton_iters_for_aspect(a) == jcq.newton_iters_for_aspect(a)


# The shapes of tests/test_cholqr.py: tall panels (192 x 128, r = 32), the
# hybrid rule's square final panel (256^2, r = 128), pairs (384 x 256,
# r = 64), the ragged cholqr1 fallback of polar (200 x 120, r = 64).
FP32_CASES = [
    ("cholqr1", 192, 128, 32), ("cholqr2", 192, 128, 32),
    ("cholqr2s", 192, 128, 32), ("cholqr1", 256, 256, 128),
    ("cholqr2", 256, 256, 128), ("cholqr1x2", 384, 256, 64),
    ("householder_pallas", 192, 96, 32), ("cholqr1", 200, 120, 64),
]


@pytest.mark.parametrize("pm,m,n,r", FP32_CASES)
def test_block_qr_fp32_matches_jax(pm, m, n, r):
    a = _mat(m, n, 3)
    Qt, Rt = pt.block_qr(torch.from_numpy(a), r, pt.POLICY_FP32,
                         mode="complete", panel_method=pm)
    Qj, Rj = jbq.block_qr(jnp.asarray(a), r, jpolicy.POLICY_FP32,
                          mode="complete", panel_method=pm)
    assert Qt.shape == (m, m) and Rt.shape == (m, n)
    _close(Qt.numpy(), Qj)
    _close(Rt.numpy(), Rj)
    rep = pt.metrics.evaluate(torch.from_numpy(a), Qt, Rt, 23)
    assert rep.all_ok, str(rep)


def _within_2x(rt, rj):
    assert rt.all_ok and rj.all_ok, (str(rt), str(rj))
    for f in ("backward", "orthogonality"):
        vt, vj = getattr(rt, f), getattr(rj, f)
        assert vt <= 2 * vj + 1e-9 and vj <= 2 * vt + 1e-9, (f, vt, vj)


@pytest.mark.parametrize("pm,m,n,r,lm", [
    ("cholqr1", 256, 192, 64, "unroll"), ("cholqr2", 256, 192, 64, "unroll"),
    ("cholqr1", 256, 256, 128, "unroll"), ("cholqr1x2", 384, 256, 64,
                                           "unroll"),
    ("householder_pallas", 256, 192, 64, "unroll"),
    ("cholqr1", 256, 128, 32, "scan"), ("cholqr2s", 256, 128, 32, "scan"),
])
def test_block_qr_mixed_quality_matches_jax(pm, m, n, r, lm):
    a = _mat(m, n, 4)
    Qt, Rt = pt.block_qr(torch.from_numpy(a), r, pt.POLICY_MIXED,
                         mode="complete", panel_method=pm, loop_mode=lm)
    Qj, Rj = jbq.block_qr(jnp.asarray(a), r, jpolicy.POLICY_MIXED,
                          mode="complete", panel_method=pm, loop_mode=lm)
    rt = pt.metrics.evaluate(torch.from_numpy(a), Qt, Rt, 8)
    rj = jmetrics.evaluate(a, np.asarray(Qj, np.float32),
                           np.asarray(Rj, np.float32), precision_bits=8)
    _within_2x(rt, rj)


@pytest.mark.parametrize("pm", ["cholqr1", "cholqr2s"])
def test_block_qr_scan_fp32_matches_jax(pm):
    # tests/test_blockqr.py:172-185: the full-width masked step on every
    # panel but the last, the Householder final panel.
    a = _mat(256, 128, 11)
    Qt, Rt = pt.block_qr(torch.from_numpy(a), 32, pt.POLICY_FP32,
                         mode="complete", panel_method=pm, loop_mode="scan")
    Qj, Rj = jbq.block_qr(jnp.asarray(a), 32, jpolicy.POLICY_FP32,
                          mode="complete", panel_method=pm, loop_mode="scan")
    _close(Qt.numpy(), Qj)
    _close(Rt.numpy(), Rj)


@pytest.mark.parametrize("pm", ["cholqr1", "cholqr2", "cholqr1x2",
                                "householder_pallas"])
def test_block_qr_qtb_cholqr_matches_jax(pm):
    a = _mat(384, 256, 5)
    b = np.random.default_rng(6).standard_normal((384, 2)).astype(np.float32)
    Rt, qt = pt.block_qr_qtb(torch.from_numpy(a), torch.from_numpy(b), 64,
                             pt.POLICY_FP32, panel_method=pm)
    Rj, qj = jbq.block_qr_qtb(jnp.asarray(a), jnp.asarray(b), 64,
                              jpolicy.POLICY_FP32, panel_method=pm)
    _close(Rt.numpy(), Rj)
    _close(qt.numpy(), qj)


def test_cholqr2_keeps_fp64():
    # check_policy_method lets cholqr2 take POLICY_FP64, and the Cholesky
    # path (and the Householder tail of the hybrid rule) stays float64.
    a = np.random.default_rng(7).random((256, 256)) - 0.5
    Q, R = pt.block_qr(torch.from_numpy(a), 64, pt.POLICY_FP64,
                       mode="complete", panel_method="cholqr2")
    assert Q.dtype == torch.float64 and R.dtype == torch.float64
    Qj, Rj = jbq.block_qr(jnp.asarray(a), 64, jpolicy.POLICY_FP64,
                          mode="complete", panel_method="cholqr2")
    _close(R.numpy(), Rj, atol=1e-10)
    # (ops/metrics.py evaluates in fp32, so the float64 check is direct)
    Qn, Rn = Q.numpy(), R.numpy()
    assert np.linalg.norm(a - Qn @ Rn) / np.linalg.norm(a) < 1e-13
    assert np.abs(Qn.T @ Qn - np.eye(256)).max() < 1e-13


def test_cholqr_sync_retries_through_householder():
    # A zero column breaks the panel's Cholesky: 'defer' funnels the NaN
    # into R[0, 0]; 'sync' reruns through 'householder' and matches it.
    a = np.random.default_rng(0).standard_normal((256, 256)).astype(
        np.float32)
    a[:, 100] = 0.0
    A = torch.from_numpy(a)
    _, Rd = pt.block_qr(A, 64, pt.POLICY_MIXED, panel_method="cholqr1")
    assert not torch.isfinite(Rd[0, 0])
    Q, R = pt.block_qr(A, 64, pt.POLICY_MIXED, panel_method="cholqr1",
                       check="sync")
    Qh, Rh = pt.block_qr(A, 64, pt.POLICY_MIXED, panel_method="householder")
    torch.testing.assert_close(R, Rh, rtol=0, atol=0)
    _, Rj = jbq.block_qr(jnp.asarray(a), 64, jpolicy.POLICY_MIXED,
                         panel_method="cholqr1")
    assert not np.isfinite(np.asarray(Rj)[0, 0])


def test_scan_sync_retry_rule_matches_jax():
    # Scan retries through the scan-BGS tier 'bgs', or 'cholqr2s' outside
    # BGS's contract.
    for args in (("cholqr1", "scan", "mixed", "complete", 512, 512),
                 ("cholqr1", "scan", "mixed", "complete", 768, 512),
                 ("cholqr1", "scan", "fp64", "reduced", 512, 512),
                 ("cholqr2s", "scan", "fp64", "reduced", 512, 512),
                 ("polar", "unroll", "fp32", "reduced", 512, 512),
                 ("householder", "unroll", "fp32", "reduced", 512, 512)):
        pm, lm, pol, mode, m, n = args
        assert (tbq._sync_retry_method(pm, lm, pt.policy_by_name(pol), mode,
                                       m, n)
                == jbq._sync_retry_method(pm, lm,
                                          jpolicy.policy_by_name(pol), mode,
                                          m, n)), args
    a = np.random.default_rng(0).standard_normal((256, 256)).astype(
        np.float32)
    a[:, 40] = 0.0
    # A zero column poisons the cholqr scan; the retry through 'bgs' scan
    # runs and, the matrix being rank-deficient, fails too, in both
    # packages.
    with pytest.raises(pt.NonFiniteError, match="even via 'bgs'"):
        pt.block_qr(torch.from_numpy(a), 32, pt.POLICY_MIXED,
                    panel_method="cholqr1", loop_mode="scan", check="sync")
    with pytest.raises(jchecks.NonFiniteError, match="even via 'bgs'"):
        jbq.block_qr(jnp.asarray(a), 32, jpolicy.POLICY_MIXED,
                     panel_method="cholqr1", loop_mode="scan", check="sync")


def test_block_recursive_qr_matches_jax():
    a = _mat(300, 200, 8)
    Qt, Rt = pt.block_recursive_qr(torch.from_numpy(a), min_block=32)
    Qj, Rj = jbq.block_recursive_qr(jnp.asarray(a), min_block=32)
    assert Qt.shape == (300, 200) and Rt.shape == (200, 200)
    _close(Qt.numpy(), Qj)
    _close(Rt.numpy(), Rj)
    with pytest.raises(ValueError, match="reduced"):
        pt.block_recursive_qr(torch.from_numpy(a), mode="complete")


@pytest.mark.parametrize("pm,mode", [("householder", "reduced"),
                                     ("cholqr2", "complete"),
                                     ("polar", "r")])
def test_block_qr_batched_matches_jax(pm, mode):
    a = np.stack([_mat(256, 128, s) for s in (9, 10, 11)])
    out_t = pt.block_qr_batched(torch.from_numpy(a), 32, pt.POLICY_FP32,
                                mode=mode, panel_method=pm)
    out_j = jbq.block_qr_batched(jnp.asarray(a), 32, jpolicy.POLICY_FP32,
                                 mode=mode, panel_method=pm)
    if mode == "r":
        out_t, out_j = (out_t,), (out_j,)
    for t, j in zip(out_t, out_j):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t.numpy(), j)
    with pytest.raises(ValueError, match="batch"):
        pt.block_qr_batched(torch.from_numpy(a[0]))


def test_numpy_input_needs_a_device_without_cuda(monkeypatch):
    # Entry points run on the card unless asked for the CPU: with no CUDA
    # device a numpy input raises and names device='cpu'; with
    # device='cpu' it runs there, and a CPU tensor stays where it is.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _mat(96, 64, 12)
    b = np.ones(96, np.float32)
    Ru = np.triu(a[:64]) + 4.0 * np.eye(64, dtype=np.float32)
    calls = {
        "back_substitution": lambda **k: pt.back_substitution(Ru, b[:64],
                                                              **k),
        "numerical_rank": lambda **k: pt.numerical_rank(Ru, **k),
        "block_qr": lambda **k: pt.block_qr(a, 32, **k),
        "qr": lambda **k: pt.qr(a, 32, **k),
        "block_qr_qtb": lambda **k: pt.block_qr_qtb(a, b, 32, **k),
        "householder_qr": lambda **k: pt.householder_qr(a, **k),
        "pivoted_qr": lambda **k: pt.pivoted_qr(a, **k),
        "pivoted_qr_qtb": lambda **k: pt.pivoted_qr_qtb(a, b, **k),
        "lstsq": lambda **k: pt.lstsq(a, b, 32, **k),
        "lstsq_pivoted": lambda **k: pt.lstsq_pivoted(a, b, **k),
        "gauss_newton_step": lambda **k: pt.gauss_newton_step(a, b, **k),
        "block_recursive_qr": lambda **k: pt.block_recursive_qr(a, **k),
        "block_qr_batched": lambda **k: pt.block_qr_batched(a[None], 32,
                                                            **k),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        out = call(device="cpu")
        if name == "numerical_rank":  # an int: the rank of the CPU call
            assert out == 64
            continue
        first = out[0] if isinstance(out, tuple) else out
        assert first.device.type == "cpu", name
    Q, R = pt.block_qr(torch.from_numpy(a), 32)
    assert Q.device.type == "cpu"
