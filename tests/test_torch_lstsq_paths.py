"""The port's ``lstsq`` TSQR and refinement paths, ``lstsq_batched`` and
the small utilities the port's modules lacked (``metrics.strip_r``,
``datagen.size_sweep``, ``timing.time_fn`` / ``time_step_amortized`` /
``trace`` / ``device_peak_tflops``) against the JAX package on the CPU,
on the inputs of tests/test_lstsq.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.models import lstsq as jls
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.utils import datagen as jdatagen
from mixedprecisionblockqr_tpu_torch.models import lstsq as tls
from mixedprecisionblockqr_tpu_torch.ops import metrics as tmetrics
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import LAUNCHES
from mixedprecisionblockqr_tpu_torch.utils import datagen as tdatagen
from mixedprecisionblockqr_tpu_torch.utils import timing


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return np.linalg.norm(np.asarray(t, np.float64) - j) / np.linalg.norm(j)


def test_lstsq_tsqr_matches_jax():
    """tests/test_lstsq.py:110's system (2048 x 24): 16 leaves on both
    sides; fp32, summation order only: 1e-5 relative."""
    rng = np.random.default_rng(3)
    A = rng.random((2048, 24)).astype(np.float32)
    b = rng.random(2048).astype(np.float32)
    for steps in (0, 1):
        x = tls.lstsq(torch.from_numpy(A), torch.from_numpy(b),
                      method="tsqr", refine_steps=steps)
        x_ref = np.asarray(jls.lstsq(A, b, method="tsqr",
                                     refine_steps=steps))
        assert _rel(x, x_ref) < 1e-5
    want = np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64),
                           rcond=None)[0]
    np.testing.assert_allclose(x.numpy(), want, atol=1e-3)


def test_lstsq_refine_matches_jax_and_recovers_accuracy():
    """tests/test_lstsq.py:178's cond-1e5 system: the refined solution
    agrees with the JAX package's within kappa * eps_f32 relative (the
    forward error bound of an fp32 solve, which amplifies the two
    factorizations' summation-order difference), lies no further from the
    true x than twice the JAX package's, and halves the error of the
    unrefined solve."""
    A = jdatagen.conditioned_matrix(96, 1e5, seed=9).astype(np.float32)
    xt = np.random.default_rng(10).random(96).astype(np.float32)
    b = (A.astype(np.float64) @ xt).astype(np.float32)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x0 = tls.lstsq(At, bt, block_size=32).numpy()
    x2 = tls.lstsq(At, bt, block_size=32, refine_steps=2).numpy()
    x2_ref = np.asarray(jls.lstsq(A, b, block_size=32, refine_steps=2))
    assert _rel(x2, x2_ref) < 1e5 * np.finfo(np.float32).eps
    assert _rel(x2, xt) <= 2 * _rel(x2_ref, xt)
    assert np.linalg.norm(x2 - xt) < 0.5 * np.linalg.norm(x0 - xt)


def test_lstsq_refine_matrix_rhs_matches_jax():
    rng = np.random.default_rng(9)
    A = rng.random((128, 64)).astype(np.float32)
    B = rng.random((128, 2)).astype(np.float32)
    X = tls.lstsq(torch.from_numpy(A), torch.from_numpy(B), refine_steps=1)
    assert X.shape == (64, 2)
    assert _rel(X, jls.lstsq(A, B, refine_steps=1)) < 1e-5


def test_lstsq_refine_path_guards(monkeypatch):
    """quality= is refused on the CAQR path; a rank-deficient system trips
    the diagonal check and reroutes to lstsq_pivoted (tests/test_lstsq.py:
    90-108)."""
    rng = np.random.default_rng(9)
    A = rng.random((128, 64)).astype(np.float32)
    b = rng.random(128).astype(np.float32)
    with pytest.raises(ValueError, match="quality"):
        tls.lstsq(torch.from_numpy(A), torch.from_numpy(b),
                  panel_method="auto", quality="high", refine_steps=1)
    Ad = A.copy()
    Ad[:, -1] = Ad[:, 0]
    calls = []
    pivoted = tls.lstsq_pivoted

    def spy(*args, **kw):
        calls.append(1)
        return pivoted(*args, **kw)

    monkeypatch.setattr(tls, "lstsq_pivoted", spy)
    x = tls.lstsq(torch.from_numpy(Ad), torch.from_numpy(b), refine_steps=2)
    assert calls == [1]
    xr = np.linalg.lstsq(Ad.astype(np.float64), b.astype(np.float64),
                         rcond=None)[0]
    assert abs(np.linalg.norm(Ad @ x.numpy() - b)
               - np.linalg.norm(Ad @ xr - b)) < 1e-3
    # rcond=0 switches the tripwire off: no reroute
    tls.lstsq(torch.from_numpy(A), torch.from_numpy(b), refine_steps=1,
              rcond=0)
    assert calls == [1]


@pytest.mark.parametrize("k", [None, 3])
def test_lstsq_batched_matches_jax(k):
    """tests/test_lstsq.py:167's batch; a (batch, m, k) right-hand side
    keeps its k columns.  fp32 summation order: 1e-5 relative."""
    rng = np.random.default_rng(7)
    A = rng.random((4, 80, 32)).astype(np.float32)
    xt = rng.random((4, 32) if k is None else (4, 32, k)).astype(np.float32)
    b = (np.einsum("bmn,bn->bm", A, xt) if k is None
         else np.einsum("bmn,bnk->bmk", A, xt))
    before = dict(LAUNCHES)
    X = pt.lstsq_batched(torch.from_numpy(A), torch.from_numpy(b),
                         block_size=16)
    assert dict(LAUNCHES) == before  # the CPU runs panel_factor's loop
    X_ref = np.asarray(jls.lstsq_batched(A, b, block_size=16))
    assert X.shape == X_ref.shape == xt.shape
    assert _rel(X, X_ref) < 1e-5
    np.testing.assert_allclose(X.numpy(), xt, atol=5e-3)


def test_strip_r_matches_jax():
    a = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    np.testing.assert_array_equal(tmetrics.strip_r(torch.from_numpy(a)),
                                  np.asarray(jmetrics.strip_r(jnp.asarray(a))))


@pytest.mark.parametrize("args", [(), (64, 2048, 2), (10, 1000, 3),
                                  (128, 100, 2)])
def test_size_sweep_matches_jax(args):
    assert (list(tdatagen.size_sweep(*args))
            == list(jdatagen.size_sweep(*args)))


def test_time_fn_on_cpu():
    calls = []

    def f(x, scale=1.0):
        calls.append(1)
        return x * scale

    sec, out = timing.time_fn(f, torch.ones(4), warmup=2, iters=5, scale=3.0)
    assert sec >= 0.0 and len(calls) == 7
    assert torch.equal(out, torch.full((4,), 3.0))


def test_time_step_amortized_on_cpu():
    steps = []

    def step(x):
        steps.append(1)
        return x * 0.5 + 1.0

    t = timing.time_step_amortized(step, torch.ones(8), iters=4, repeats=2)
    assert t > 0.0
    # one warm-up run of 1, then repeats x (1 + (1 + iters)) applications
    assert len(steps) == 1 + 2 * (1 + 5)


def test_trace_scope_and_chrome_trace(tmp_path):
    with timing.trace("plain_scope"):
        torch.ones(3).sum()
    with timing.trace("traced", log_dir=str(tmp_path)):
        torch.ones(3).sum()
    assert os.path.getsize(tmp_path / "traced.trace.json") > 0


def test_device_peak_tflops_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this case checks the answer without a CUDA device")
    assert timing.device_peak_tflops() is None
    assert timing.device_peak_tflops("float32") is None
