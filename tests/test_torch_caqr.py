"""The port's single-device CAQR (``parallel/caqr.py``) against the JAX
package on the CPU: Q and R of the same numpy inputs, the row-block rule
and its clamp, the ``apply_q`` / ``apply_qt`` operators, and the JAX
package's stored factors replayed by the port's ``apply_qt``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.parallel import caqr as jc
from mixedprecisionblockqr_tpu_torch.ops import metrics as tmetrics
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import LAUNCHES
from mixedprecisionblockqr_tpu_torch.parallel import caqr as tc

# fp32, the same panels and products, summation order only: 1e-5 of the
# entries' scale (max(1, max|x|)).
ATOL = 1e-5
SHAPES = [(96, 24, 8, 2), (192, 48, 16, 4), (144, 36, 12, 2), (24, 6, 3, 4)]


def _close(t, j, atol=ATOL):
    j = np.asarray(j, np.float64)
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * scale)


def _mat(m, n, seed):
    return np.random.default_rng(seed).random((m, n)).astype(np.float32)


@pytest.mark.parametrize("m,n,r,L", SHAPES)
def test_caqr_matches_jax(m, n, r, L):
    A = _mat(m, n, m + n)
    before = dict(LAUNCHES)
    Q, R = pt.caqr(torch.from_numpy(A), block_size=r, row_blocks=L)
    assert dict(LAUNCHES) == before  # the CPU runs panel_factor's loop
    Qj, Rj = jc.caqr(A, block_size=r, row_blocks=L)
    assert Q.shape == (m, n) and R.shape == (n, n)
    _close(Q, Qj)
    _close(R, Rj)
    # the reference test's bounds (tests/test_caqr.py:20-27)
    assert float(tmetrics.backward_error(torch.from_numpy(A), Q, R)) < 1e-5
    assert float(tmetrics.orthogonality_error(Q)) < 1e-4
    assert float(tmetrics.lower_trapezoid_error(R)) == 0.0


def test_caqr_complete_mode_matches_jax():
    A = _mat(96, 24, 0)
    Q, R = pt.caqr(torch.from_numpy(A), block_size=8, row_blocks=2,
                   mode="complete")
    Qj, Rj = jc.caqr(A, block_size=8, row_blocks=2, mode="complete")
    assert Q.shape == (96, 96) and R.shape == (96, 24)
    _close(Q, Qj)
    _close(R, Rj)


@pytest.mark.parametrize("height,r", [(4096, 128), (2176, 128), (2048, 1024),
                                      (96, 8), (64, 16), (16, 16), (100, 7),
                                      (8192, 64)])
@pytest.mark.parametrize("requested", [None, 1, 2, 8, 64])
def test_pick_row_blocks_matches_jax(height, r, requested):
    assert (tc._pick_row_blocks(height, r, requested)
            == jc._pick_row_blocks(height, r, requested))


def test_apply_q_qt_roundtrip():
    m, n = 128, 32
    A = _mat(m, n, 1)
    factors, R = tc.caqr_factor(torch.from_numpy(A), block_size=16,
                                row_blocks=2)
    X = torch.from_numpy(_mat(m, 5, 2))
    # fp32 reflectors applied twice: the reference test's 1e-4
    np.testing.assert_allclose(
        tc.apply_q(factors, tc.apply_qt(factors, X)).numpy(), X.numpy(),
        atol=1e-4)
    QtA = tc.apply_qt(factors, torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(QtA[:n], R.numpy(), atol=1e-4)
    np.testing.assert_allclose(QtA[n:], 0.0, atol=1e-3)


@pytest.mark.parametrize("m,n,r,L", [(64, 32, 32, 8), (64, 64, 16, 2)])
def test_caqr_row_block_clamp_matches_jax(m, n, r, L):
    """An explicit row_blocks is a per-panel upper bound: the square case's
    last 16 x 16 panel takes one block instead of raising."""
    A = _mat(m, n, 3)
    Q, R = pt.caqr(torch.from_numpy(A), block_size=r, row_blocks=L)
    Qj, Rj = jc.caqr(A, block_size=r, row_blocks=L)
    _close(Q, Qj)
    _close(R, Rj)
    assert float(tmetrics.backward_error(torch.from_numpy(A), Q, R)) < 1e-5


def test_padded_rows_stay_zero_in_v():
    """102 rows over 4 blocks of 26: the last leaf has 2 zero rows of
    padding, and its stored V is zero there (caqr.py:153-156 of the
    reference)."""
    A = torch.from_numpy(_mat(102, 8, 4))
    factors, _ = tc.caqr_factor(A, block_size=8, row_blocks=4)
    pf = factors.panels[0]
    L, h, _ = pf.leaf_v.shape
    assert (L, h) == (4, 26)
    pad = L * h - 102
    assert pad == 2 and bool((pf.leaf_v[-1, h - pad:] == 0).all())


def test_jax_factors_replay_through_port_apply_qt():
    """The JAX package's caqr_factor factors, carried over with
    factors_from_numpy, give the JAX package's Q^T X through the port's
    apply_qt, and Q (Q^T X) = X."""
    m, n = 144, 36
    A = _mat(m, n, 5)
    X = _mat(m, 3, 6)
    jf, _ = jc.caqr_factor(A, block_size=12, row_blocks=4)
    panels = [{"row_offset": p.row_offset, "col_offset": p.col_offset,
               "width": p.width, "leaf_v": np.array(p.leaf_v),
               "leaf_t": np.array(p.leaf_t),
               "tree_v": [np.array(v) for v in p.tree_v],
               "tree_t": [np.array(t) for t in p.tree_t]}
              for p in jf.panels]
    tf = tc.factors_from_numpy(m, n, panels, device="cpu")
    assert len(tf.panels) == 3 and tf.panels[1].row_offset == 12
    Y = tc.apply_qt(tf, torch.from_numpy(X))
    _close(Y, jc.apply_qt(jf, jnp.asarray(X)))
    _close(tc.apply_q(tf, Y), X, atol=1e-4)


def test_caqr_validation_errors():
    with pytest.raises(ValueError, match="m >= n"):
        tc.caqr_factor(torch.zeros((8, 16)))
    with pytest.raises(ValueError, match="power of two"):
        tc.caqr_factor(torch.from_numpy(_mat(96, 8, 7)), block_size=8,
                       row_blocks=3)
