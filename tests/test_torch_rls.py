"""The port's recursive least squares (``RLSState``, ``rls_init``,
``rls_update``, ``rls_solve``) against the JAX package on the CPU and a
float64 oracle, the cases of ``tests/test_lstsq.py``: the state (R, Q^T b)
within 1e-5 relative of the JAX state (the same Householder factorization
and the same row fold), x within 1e-4 of float64 ``np.linalg.lstsq`` of
the stacked system, and R exactly upper triangular after every fold."""

import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.models import lstsq as jl
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import LAUNCHES


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return np.linalg.norm(np.asarray(t, np.float64) - j) / np.linalg.norm(j)


def _same_state(st, sj):
    assert isinstance(st, pt.RLSState)
    assert tuple(st.R.shape) == sj.R.shape
    assert tuple(st.qtb.shape) == sj.qtb.shape
    assert _rel(st.R, sj.R) <= 1e-5 and _rel(st.qtb, sj.qtb) <= 1e-5
    assert bool((torch.tril(st.R, -1) == 0).all())


def _oracle(A, b):
    return np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64),
                           rcond=None)[0]


# (m, n, rhs columns or None, the row batches folded in turn)
CASES = {
    "streaming": (5, 64, 12, None, (4, 1, 5)),
    "multi_rhs": (6, 40, 8, 3, (5,)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rls_matches_jax_and_float64(case):
    seed, m, n, nrhs, batches = CASES[case]
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    bshape = (m,) if nrhs is None else (m, nrhs)
    b = rng.standard_normal(bshape).astype(np.float32)
    st = pt.rls_init(torch.from_numpy(A), torch.from_numpy(b))
    sj = jl.rls_init(A, b)
    _same_state(st, sj)
    np.testing.assert_allclose(pt.rls_solve(st).numpy(), _oracle(A, b),
                               atol=1e-4)
    k = sum(batches)
    rows = rng.standard_normal((k, n)).astype(np.float32)
    betas = rng.standard_normal((k,) if nrhs is None else (k, nrhs)).astype(
        np.float32)
    lo = 0
    before = dict(LAUNCHES)
    for size in batches:
        r, be = rows[lo:lo + size], betas[lo:lo + size]
        if size == 1:  # a single row as a vector, its beta as a scalar
            r, be = r[0], be[0]
        st = pt.rls_update(st, torch.from_numpy(np.asarray(r)),
                           torch.from_numpy(np.asarray(be)))
        sj = jl.rls_update(sj, r, be)
        _same_state(st, sj)
        lo += size
    assert dict(LAUNCHES) == before  # the CPU runs the plain fold
    x = pt.rls_solve(st)
    np.testing.assert_allclose(x.numpy(), np.asarray(jl.rls_solve(sj)),
                               atol=1e-5)
    np.testing.assert_allclose(
        x.numpy(), _oracle(np.vstack([A, rows]),
                           np.concatenate([b, betas])), atol=1e-4)


def test_rls_init_needs_an_overdetermined_system():
    with pytest.raises(ValueError, match="overdetermined"):
        pt.rls_init(torch.zeros(4, 6), torch.zeros(4))


def test_rls_init_numpy_goes_to_the_device_rule():
    A = np.random.default_rng(7).standard_normal((20, 5)).astype(np.float32)
    st = pt.rls_init(A, np.ones(20, np.float32), device="cpu")
    assert st.R.device.type == "cpu" and st.R.shape == (5, 5)
