"""The port's single-device TSQR (``parallel/tsqr.py``) against the JAX
package on the CPU: Q and R of the same numpy inputs (no sign
canonicalization: both run Householder panels with the same convention),
the leaf count, the reduction tree, the batched form, the CholeskyQR
leaves and the validation errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.parallel import tsqr as jt
from mixedprecisionblockqr_tpu.utils.datagen import conditioned_matrix
from mixedprecisionblockqr_tpu_torch.ops import metrics as tmetrics
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import LAUNCHES
from mixedprecisionblockqr_tpu_torch.parallel import tsqr as tt

# fp32, the same panels and products, summation order only: 1e-5 of the
# entries' scale (max(1, max|x|)).
ATOL = 1e-5
SHAPES = [(96, 3, 4), (256, 16, 4), (1024, 32, 8), (999, 8, 4)]


def _close(t, j, atol=ATOL):
    j = np.asarray(j, np.float64)
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * scale)


def _check(A, Q, R, tol=1e-5):
    """The reference test's quality check (tests/test_tsqr.py:25-28)."""
    assert float(tmetrics.backward_error(torch.as_tensor(A), Q, R)) < tol
    assert float(tmetrics.orthogonality_error(Q)) < tol
    assert float(tmetrics.lower_trapezoid_error(R)) == 0.0


@pytest.mark.parametrize("m,n,L", SHAPES)
def test_tsqr_matches_jax(m, n, L):
    A = np.random.default_rng(m).random((m, n)).astype(np.float32)
    before = dict(LAUNCHES)
    Q, R = pt.tsqr(torch.from_numpy(A), n_leaves=L)
    assert dict(LAUNCHES) == before  # the CPU runs panel_factor's loop
    Qj, Rj = jt.tsqr(A, n_leaves=L)
    assert Q.shape == (m, n) and R.shape == (n, n)
    _close(Q, Qj)
    _close(R, Rj)
    _check(A, Q, R)


@pytest.mark.parametrize("m,n", [(m, n) for m, n, _ in SHAPES]
                         + [(100000, 64), (2048, 24), (255, 64), (64, 64),
                            (4096, 8)])
def test_pick_leaves_matches_jax(m, n):
    assert tt._pick_leaves(m, n, None) == jt._pick_leaves(m, n, None)
    assert tt._pick_leaves(m, n, 4) == 4


def test_pick_leaves_of_the_chip_cell():
    """100000 x 64: 64 leaves, so 64 leaf and 63 tree panels."""
    assert tt._pick_leaves(100000, 64, None) == 64


def test_tsqr_auto_leaves_match_jax():
    A = np.random.default_rng(7).random((2048, 24)).astype(np.float32)
    Q, R = pt.tsqr(torch.from_numpy(A))
    Qj, Rj = jt.tsqr(A)
    _close(Q, Qj)
    _close(R, Rj)


@pytest.mark.parametrize("method,L", [("householder", 8), ("cholqr2", 4)])
def test_reduction_tree_matches_jax(method, L):
    rng = np.random.default_rng(2)
    n = 8
    Rs = np.stack([np.triu(rng.random((n, n))) + np.eye(n)
                   for _ in range(L)]).astype(np.float32)
    F, R = tt.reduction_tree(torch.from_numpy(Rs), method)
    Fj, Rj = jt.reduction_tree(jnp.asarray(Rs), method)
    _close(F, Fj)
    _close(R, Rj)
    Fs = F.double().reshape(L * n, n).numpy()
    np.testing.assert_allclose(Fs @ R.double().numpy(), Rs.reshape(L * n, n),
                               atol=1e-4)


def test_tsqr_batched_matches_jax():
    A = np.random.default_rng(3).random((4, 256, 8)).astype(np.float32)
    Qs, Rs = pt.tsqr_batched(torch.from_numpy(A), n_leaves=4)
    Qj, Rj = jt.tsqr_batched(jnp.asarray(A), n_leaves=4)
    assert Qs.shape == (4, 256, 8) and Rs.shape == (4, 8, 8)
    _close(Qs, Qj)
    _close(Rs, Rj)
    for i in range(4):
        _check(A[i], Qs[i], Rs[i])


@pytest.mark.parametrize("method,L", [("cholqr2", 8), ("cholqr2s", None),
                                      ("cholqr2s", 8)])
def test_tsqr_cholqr_leaves_match_jax(method, L):
    if method == "cholqr2":
        A = np.random.default_rng(6).random((2048, 24)).astype(np.float32)
        tol = 1e-5
    else:
        # cond 1e5, tall (tests/test_tsqr.py:101-133): the shifted leaves'
        # orthogonality is the reference's 1e-3
        base = conditioned_matrix(48, 1e5, seed=3).astype(np.float32)
        lift, _ = np.linalg.qr(np.random.default_rng(4).standard_normal(
            (4096, 48)))
        A = (lift @ base).astype(np.float32)
        tol = 1e-3
    Q, R = pt.tsqr(torch.from_numpy(A), n_leaves=L, method=method)
    _, Rj = jt.tsqr(A, n_leaves=L, method=method)
    _close(R, Rj, atol=1e-4)
    assert float(tmetrics.backward_error(torch.from_numpy(A), Q, R)) < 1e-5
    assert float(tmetrics.orthogonality_error(Q)) < tol


def test_tsqr_validation_errors():
    A = torch.from_numpy(
        np.random.default_rng(5).random((256, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="unknown tsqr method"):
        pt.tsqr(A, method="nonsense")
    with pytest.raises(ValueError, match="power of two"):
        pt.tsqr(A, n_leaves=3)
    with pytest.raises(ValueError, match="m >= n"):
        pt.tsqr(A[:8])
    with pytest.raises(ValueError, match="power of two"):
        pt.tsqr_batched(A[None], n_leaves=6)
    with pytest.raises(ValueError, match="power-of-two leaf count"):
        tt.reduction_tree(torch.zeros((3, 4, 4)))


@pytest.mark.parametrize("method", ["cholqr2", "householder"])
def test_tsqr_short_leaf_validation(method):
    """ceil(256 / 8) = 32 < 64: rejected, as in the JAX package."""
    A = torch.from_numpy(
        np.random.default_rng(6).random((256, 64)).astype(np.float32))
    with pytest.raises(ValueError, match="leaf height"):
        pt.tsqr(A, n_leaves=8, method=method)
    with pytest.raises(ValueError, match="leaf height"):
        pt.tsqr_batched(A[None], n_leaves=8)
