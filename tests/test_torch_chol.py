"""``chol_rinv`` (kernel K9) of the port against the JAX package's Pallas
kernel, run in interpret mode on the CPU, at r = 32, 64 and 128.  On CPU
tensors the port's wrapper runs its plain PyTorch version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops.pallas import chol as jchol
from mixedprecisionblockqr_tpu_torch.ops.kernels import chol as tchol


def _gram(r, seed=0, m=512):
    P = np.random.default_rng(seed).random((m, r), dtype=np.float32) - 0.5
    return (P.astype(np.float64).T @ P.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("r", [32, 64, 128])
def test_chol_rinv_matches_jax(r):
    # Same blocked algorithm in true fp32 on both sides: 1e-4 of max|R|
    # (and of max|Rinv|).
    G = _gram(r)
    Rj, Rij = jchol.chol_rinv(jnp.asarray(G), interpret=True)
    Rt, Rit = tchol.chol_rinv(torch.from_numpy(G))
    Rj, Rij = np.asarray(Rj), np.asarray(Rij)
    np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-4 * np.abs(Rj).max())
    np.testing.assert_allclose(Rit.numpy(), Rij,
                               atol=1e-4 * np.abs(Rij).max())


@pytest.mark.parametrize("r", [32, 64, 128])
def test_chol_rinv_factors_and_inverts(r):
    G = _gram(r, seed=1)
    R, Rinv = tchol.chol_rinv(torch.from_numpy(G))
    Rd, Rid = R.double().numpy(), Rinv.double().numpy()
    assert np.abs(Rd.T @ Rd - G).max() <= 1e-5 * np.abs(G).max()
    assert np.abs(Rd @ Rid - np.eye(r)).max() <= 1e-4
    np.testing.assert_allclose(
        Rd, np.linalg.cholesky(G.astype(np.float64)).T,
        atol=1e-4 * np.abs(Rd).max())
    # strictly lower parts are exact zeros, the diagonal is positive
    assert (np.tril(R.numpy(), -1) == 0).all()
    assert (np.tril(Rinv.numpy(), -1) == 0).all()
    assert (np.diag(R.numpy()) > 0).all()


def test_chol_rinv_panel_is_orthonormal():
    # The kernel's use: a CholeskyQR panel is a product, this call, a
    # product.
    P = np.random.default_rng(2).random((512, 64), dtype=np.float32) - 0.5
    Pt = torch.from_numpy(P)
    R, Rinv = tchol.chol_rinv(Pt.T @ Pt)
    Q = (Pt @ Rinv).double().numpy()
    assert np.abs(Q.T @ Q - np.eye(64)).max() <= 1e-5
    assert np.abs(Q @ R.double().numpy() - P).max() <= 1e-5


@pytest.mark.parametrize("r", [48, 16, 0])
def test_size_must_be_a_multiple_of_32(r):
    with pytest.raises(ValueError, match="% 32 == 0"):
        tchol.chol_rinv(torch.eye(r))
    if r == 48:
        with pytest.raises(ValueError, match="% 32 == 0"):
            jchol.chol_rinv(jnp.eye(r), interpret=True)


def test_not_square_raises():
    with pytest.raises(ValueError, match="square"):
        tchol.chol_rinv(torch.zeros((64, 32)))


def test_indefinite_input_gives_nan_not_an_error():
    # sqrt of a negative pivot is NaN and spreads, in both packages: the
    # drivers' NaN canary reads it; nothing raises.
    G = _gram(64, seed=3)
    G[40, 40] = -1.0
    Rj, Rij = jchol.chol_rinv(jnp.asarray(G), interpret=True)
    Rt, Rit = tchol.chol_rinv(torch.from_numpy(G))
    assert np.isnan(np.asarray(Rj)).any() and np.isnan(np.asarray(Rij)).any()
    assert torch.isnan(Rt).any() and torch.isnan(Rit).any()
    # the first block, factored before the bad pivot, is finite in both
    assert torch.isfinite(Rt[:32, :32]).all()
    assert np.array_equal(np.isnan(Rt.numpy()), np.isnan(np.asarray(Rj)))


@pytest.mark.parametrize("r", range(32, 2049, 32))
def test_layout_fits_the_card_for_every_size(r):
    # The rule the wrapper passes to the kernel: one cluster of at most 8
    # CTAs that together hold all r / 32 column blocks, each CTA's shared
    # memory within an H100 block's 232,448 bytes, on one of the two routes.
    lay = tchol.chol_layout(r)
    assert 1 <= lay.cluster <= tchol.MAX_CLUSTER
    assert lay.stripe % 32 == 0 and lay.chunk % 32 == 0
    assert (lay.cluster - 1) * lay.stripe < r <= lay.cluster * lay.stripe
    assert lay.smem_bytes <= tchol.SMEM_LIMIT
    staged = 4 * 32 * (lay.chunk + 4)
    assert 32 * (lay.chunk + 4) >= 8192  # the back-fill's partial sums
    if lay.in_smem:
        assert lay.chunk == max(r, tchol.MIN_CHUNK)
        assert lay.smem_bytes == 4 * (tchol._BASE_FLOATS + r * lay.stripe) + staged
    else:
        assert lay.chunk == min(r, tchol.INPLACE_CHUNK)
        assert lay.smem_bytes == 4 * tchol._BASE_FLOATS + staged


def test_layout_routes():
    # Up to r = 512 the columns stay in shared memory (64 per CTA, eight
    # CTAs at 512); beyond, the kernel works in place in R and Rinv.
    assert [tchol.chol_layout(r).cluster for r in (32, 96, 320, 512)] == [
        1, 2, 5, 8]
    assert all(tchol.chol_layout(r).in_smem for r in range(32, 513, 32))
    assert not any(tchol.chol_layout(r).in_smem
                   for r in range(544, 2049, 32))
    assert tchol.chol_layout(1024).stripe == 128


def test_bound_uses_the_kernels_cluster():
    from mixedprecisionblockqr_tpu_torch.utils import bounds

    row = bounds.chol_rinv_bound(512)
    assert row["cluster_sms"] == tchol.chol_layout(512).cluster == 8
    # the same operations on 8 of 132 SMs
    assert row["cluster_bound_ms"] == pytest.approx(
        2 * 512 ** 3 / 3 / (bounds.PEAK_F32 * 8 / bounds.SMS) * 1e3)
    assert row["bound_ms"] < row["cluster_bound_ms"]
    # bytes: G's upper triangle read, R and Rinv written; at r = 256 they
    # set the whole card's bound
    row = bounds.chol_rinv_bound(256)
    nbytes = (256 * 257 // 2 + 2 * 256 * 256) * 4
    assert row["bound_by"] == "bytes"
    assert row["bound_ms"] == pytest.approx(
        nbytes / bounds.HBM_BYTES_PER_S * 1e3)

