"""The port's differentiable QR (``ops/autodiff.py``) and
``lstsq_autodiff`` against the JAX package on the CPU: the same numpy
inputs through ``jax.grad`` of the reference and ``torch.autograd`` of the
port (both run the Householder tier on the CPU, so the factors carry the
same signs and no canonicalization is needed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu as mpq
import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.ops import autodiff as jad
from mixedprecisionblockqr_tpu_torch.ops import autodiff as tad
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import LAUNCHES

# The reference test's tolerance for gradients of fp32 factorizations
# (tests/test_autodiff.py:42-57).
TOL = 2e-4


def _weights(m, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    wq = rng.standard_normal((m, n)).astype(np.float32)
    wr = rng.standard_normal((n, n)).astype(np.float32)
    return A, wq, wr


def _torch_grad(A, loss, **kw):
    At = torch.from_numpy(A).requires_grad_()
    Q, R = pt.qr_autodiff(At, **kw)
    loss(Q, R).backward()
    return At.grad.numpy()


@pytest.mark.parametrize("M", [
    np.arange(9.0, dtype=np.float32).reshape(3, 3),
    np.random.default_rng(0).standard_normal((7, 7)).astype(np.float32),
])
def test_copyltu_matches_jax(M):
    got = tad.copyltu(torch.from_numpy(M)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jad.copyltu(jnp.asarray(M))))
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("shape", [(48, 48), (96, 64)])
def test_qr_autodiff_grad_matches_jax(shape):
    A, wq, wr = _weights(*shape, seed=3)

    def jloss(X):
        Q, R = jad.qr_autodiff(X, block_size=16)
        return jnp.sum(wq * Q) + jnp.sum(wr * R)

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(A)))
    g = _torch_grad(
        A, lambda Q, R: (torch.from_numpy(wq) * Q).sum()
        + (torch.from_numpy(wr) * R).sum(), block_size=16)
    np.testing.assert_allclose(g, g_ref, rtol=TOL, atol=TOL)


def test_qr_autodiff_none_cotangent_matches_jax():
    """A loss on R only: Q's cotangent is None and counts as zeros."""
    A, _, wr = _weights(96, 64, seed=4)

    def jloss(X):
        return jnp.sum(wr * jad.qr_autodiff(X, block_size=16)[1])

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(A)))
    g = _torch_grad(A, lambda Q, R: (torch.from_numpy(wr) * R).sum(),
                    block_size=16)
    np.testing.assert_allclose(g, g_ref, rtol=TOL, atol=TOL)


def test_qr_autodiff_matches_finite_differences():
    """Central differences on the raw map (tests/test_autodiff.py:60-88):
    the fp32 forward gives the loss ~1e-6 relative noise, so eps = 1e-3 and
    the reference's 3e-2 relative bound."""
    rng = np.random.default_rng(5)
    A0 = rng.standard_normal((24, 16))
    wq = torch.from_numpy(rng.standard_normal((24, 16)))
    wr = torch.from_numpy(rng.standard_normal((16, 16)))

    def loss(Q, R):
        return (wq * Q).sum() + (wr * R).sum()

    g = _torch_grad(A0, loss, block_size=8)
    assert g.dtype == np.float64

    def f(X):
        with torch.no_grad():
            return float(loss(*pt.qr_autodiff(torch.from_numpy(X),
                                              block_size=8)))

    eps = 1e-3
    for i, j in [(0, 0), (3, 7), (11, 2), (23, 15), (17, 9)]:
        Ap, Am = A0.copy(), A0.copy()
        Ap[i, j] += eps
        Am[i, j] -= eps
        fd = (f(Ap) - f(Am)) / (2 * eps)
        assert abs(fd - g[i, j]) < 3e-2 * max(1.0, abs(fd)), (i, j, fd,
                                                               g[i, j])


def test_qr_autodiff_mixed_policy_gives_twice_a():
    """sum(R^2) = ||A||_F^2 for any sign convention, so gA = 2A; a mixed
    policy's forward still gives an fp32 gradient (the reference's 5e-2)."""
    A = np.random.default_rng(11).standard_normal((32, 32)).astype(np.float32)
    g = _torch_grad(A, lambda Q, R: (R.float() ** 2).sum(), block_size=16,
                    policy=pt.POLICY_MIXED)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, 2 * A, rtol=5e-2, atol=5e-2)


def test_qr_autodiff_keeps_dtype_and_propagates_nan():
    A = np.random.default_rng(12).standard_normal((32, 32)).astype(np.float32)
    Ab = torch.from_numpy(A).bfloat16().requires_grad_()
    Q, R = pt.qr_autodiff(Ab, block_size=16)
    (R.float() ** 2).sum().backward()
    assert Ab.grad.dtype == torch.bfloat16
    # The forward is check='defer': a NaN reaches the gradient, no raise.
    An = torch.from_numpy(A).clone()
    An[3, 4] = float("nan")
    An.requires_grad_()
    Q, R = pt.qr_autodiff(An, block_size=16)
    (Q.sum() + R.sum()).backward()
    assert torch.isnan(An.grad).any()


def test_make_differentiable_qr_is_cached_and_cpu_runs_no_kernel():
    f1 = pt.make_differentiable_qr(16)
    assert pt.make_differentiable_qr(16) is f1
    assert pt.make_differentiable_qr(32) is not f1
    before = dict(LAUNCHES)
    A = torch.from_numpy(_weights(64, 32, 6)[0]).requires_grad_()
    Q, R = f1(A)
    (Q.sum() + R.sum()).backward()
    assert dict(LAUNCHES) == before


def test_lstsq_autodiff_matches_jax():
    rng = np.random.default_rng(13)
    A = rng.standard_normal((48, 32)).astype(np.float32)
    b = rng.standard_normal((48,)).astype(np.float32)
    t = rng.standard_normal((32,)).astype(np.float32)

    def jloss(A, b):
        return jnp.sum((mpq.lstsq_autodiff(A, b, block_size=16) - t) ** 2)

    gA_r, gb_r = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(A),
                                                 jnp.asarray(b))
    At = torch.from_numpy(A).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    x = pt.lstsq_autodiff(At, bt, block_size=16)
    x_ref = np.asarray(mpq.lstsq_autodiff(jnp.asarray(A), jnp.asarray(b),
                                          block_size=16))
    np.testing.assert_allclose(x.detach().numpy(), x_ref, rtol=TOL,
                               atol=TOL)
    ((x - torch.from_numpy(t)) ** 2).sum().backward()
    np.testing.assert_allclose(At.grad.numpy(), np.asarray(gA_r), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_r), rtol=TOL,
                               atol=TOL)


def test_lstsq_autodiff_matrix_rhs():
    """A (m, k) right-hand side gives (n, k), column for column the vector
    solve."""
    rng = np.random.default_rng(14)
    A = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    X = pt.lstsq_autodiff(A, B, block_size=8)
    assert X.shape == (24, 3)
    for k in range(3):
        np.testing.assert_allclose(
            X[:, k].detach().numpy(),
            pt.lstsq_autodiff(A, B[:, k], block_size=8).detach().numpy(),
            rtol=1e-6, atol=1e-6)
