"""The port's policies, metrics, budgets and helpers against the JAX package.

Inputs are made with numpy from a seed and the same arrays go to both
packages; JAX runs on the CPU (tests/conftest.py).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.ops import polar as jpolar
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu.utils import datagen as jdatagen
from mixedprecisionblockqr_tpu.utils import flops as jflops
from mixedprecisionblockqr_tpu_torch.ops import metrics as tmetrics
from mixedprecisionblockqr_tpu_torch.ops import polar as tpolar
from mixedprecisionblockqr_tpu_torch.ops import policy as tpolicy
from mixedprecisionblockqr_tpu_torch.utils import datagen as tdatagen
from mixedprecisionblockqr_tpu_torch.utils import flops as tflops

POLICY_NAMES = ["fp32", "mixed", "mixed_fast", "bf16", "bf16_fast", "fp64"]
REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", POLICY_NAMES)
def test_policy_fields_match_jax(name):
    jp, tp = jpolicy.policy_by_name(name), tpolicy.policy_by_name(name)
    for field in ("panel", "trailing", "q_update", "accum"):
        assert tpolicy.dtype_name(getattr(tp, field)) == jnp.dtype(
            getattr(jp, field)).name, field
    qs_j = None if jp.q_store is None else jnp.dtype(jp.q_store).name
    qs_t = None if tp.q_store is None else tpolicy.dtype_name(tp.q_store)
    assert qs_t == qs_j
    assert tp.precision_bits == jp.precision_bits
    assert tp.name == jp.name


def test_policy_by_name_rejects_unknown():
    with pytest.raises(ValueError, match="unknown dtype policy"):
        tpolicy.policy_by_name("fp8")


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_matmul_contract_matches_jax(in_dtype):
    # bf16 inputs: exact products of the rounded operands, fp32
    # accumulation -- only the summation order differs (rtol 1e-5).
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal((48, 40)).astype(np.float32)
    ref = np.asarray(jpolicy.matmul(jnp.asarray(a), jnp.asarray(b),
                                    in_dtype=getattr(jnp, in_dtype)))
    out = tpolicy.matmul(torch.from_numpy(a), torch.from_numpy(b),
                         in_dtype=getattr(torch, in_dtype)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_high_precision_split_beats_bf16():
    # Emulated HIGH (3-pass bf16 split) drops only the lo*lo term: a
    # 2^-16-class error, about 2^-8 of the single-pass bf16 error.
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    exact = (a.double() @ b.double())
    err_high = float((tpolicy.mm_high(a, b).double() - exact).abs().max())
    err_bf16 = float((tpolicy.mm_bf16(a, b).double() - exact).abs().max())
    assert err_high < 1e-2 * err_bf16
    assert err_high < 1e-3


@pytest.mark.parametrize("caller_tf32", [False, True])
def test_mm_f32_restores_callers_tf32_setting(caller_tf32):
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = caller_tf32
    try:
        a = torch.ones((4, 4))
        tpolicy.matmul(a, a)
        tpolicy.mm_high(a, a)
        assert flags.allow_tf32 is caller_tf32
    finally:
        flags.allow_tf32 = prev


def _metric_inputs():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((96, 64)).astype(np.float32)
    Q = rng.standard_normal((96, 64)).astype(np.float32)
    R = rng.standard_normal((64, 64)).astype(np.float32)
    return A, Q, R


@pytest.mark.parametrize("metric", ["backward_error", "orthogonality_error",
                                    "lower_trapezoid_error"])
def test_metrics_match_jax(metric):
    # Non-orthogonal random Q and R keep every metric O(1), so the fp32
    # summation-order difference stays far below rtol 1e-5.
    A, Q, R = _metric_inputs()
    args = {"backward_error": (A, Q, R), "orthogonality_error": (Q,),
            "lower_trapezoid_error": (R,)}[metric]
    ref = float(getattr(jmetrics, metric)(*[jnp.asarray(x) for x in args]))
    out = float(getattr(tmetrics, metric)(*[torch.from_numpy(x)
                                            for x in args]))
    assert out == pytest.approx(ref, rel=1e-5)


def test_evaluate_and_limits_match_jax():
    A, Q, R = _metric_inputs()
    rj = jmetrics.evaluate(A, jnp.asarray(Q), jnp.asarray(R), precision_bits=8)
    rt = tmetrics.evaluate(torch.from_numpy(A), torch.from_numpy(Q),
                           torch.from_numpy(R), precision_bits=8)
    for f in ("backward", "orthogonality", "lower_trapezoid"):
        assert getattr(rt, f) == pytest.approx(getattr(rj, f), rel=1e-5)
    for f in ("limit", "tight", "all_ok", "tight_ok"):
        assert getattr(rt, f) == getattr(rj, f)
    for bits, m in ((8, 2048), (23, 6), (52, 100000)):
        assert tmetrics.error_limit(bits, m) == jmetrics.error_limit(bits, m)
        assert tmetrics.tight_limit(bits, m) == jmetrics.tight_limit(bits, m)


@pytest.mark.parametrize("full_rows", [None, True, False])
def test_evaluate_accepts_r_has_full_rows_like_jax(full_rows):
    # The JAX package accepts the keyword and ignores it: the same report.
    A, Q, R = _metric_inputs()
    rj = jmetrics.evaluate(A, jnp.asarray(Q), jnp.asarray(R), precision_bits=8,
                           R_has_full_rows=full_rows)
    rt = tmetrics.evaluate(torch.from_numpy(A), torch.from_numpy(Q),
                           torch.from_numpy(R), precision_bits=8,
                           R_has_full_rows=full_rows)
    plain = tmetrics.evaluate(torch.from_numpy(A), torch.from_numpy(Q),
                              torch.from_numpy(R), precision_bits=8)
    assert rt == plain
    for f in ("backward", "orthogonality", "lower_trapezoid"):
        assert getattr(rt, f) == pytest.approx(getattr(rj, f), rel=1e-5)
    for f in ("limit", "tight", "all_ok", "tight_ok"):
        assert getattr(rt, f) == getattr(rj, f)


@pytest.mark.parametrize("aspect", [1, 2, 3.9, 4, 7.5, 8, 15, 16, 64])
def test_iteration_budgets_match_jax(aspect):
    it = tpolar.tri_iters_for_aspect(aspect)
    assert it == jpolar.tri_iters_for_aspect(aspect)
    assert tpolar.tri_head_iters(it) == jpolar.tri_head_iters(it)
    for n in range(0, 12):
        assert tpolar.ns_omega_iters(n) == jpolar.ns_omega_iters(n)


def test_flops_and_conditioned_matrix_match_jax():
    for m, n in ((2048, 2048), (4096, 1024), (100000, 64)):
        assert tflops.qr_flops(m, n) == jflops.qr_flops(m, n)
        assert tflops.tsqr_flops(m, n) == jflops.tsqr_flops(m, n)
    np.testing.assert_array_equal(tdatagen.conditioned_matrix(32, 1e3, 5),
                                  jdatagen.conditioned_matrix(32, 1e3, 5))


def test_random_matrix_uses_generator():
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = tdatagen.random_matrix(g1, 16, 8)
    b = tdatagen.random_matrix(g2, 16, 8)
    assert a.shape == (16, 8) and a.dtype == torch.float32
    assert torch.equal(a, b) and bool(((a >= 0) & (a < 1)).all())


def test_import_leaves_jax_out():
    code = ("import sys, mixedprecisionblockqr_tpu_torch; "
            "import mixedprecisionblockqr_tpu_torch.ops.kernels.ns; "
            "import mixedprecisionblockqr_tpu_torch.ops.kernels._build; "
            "import mixedprecisionblockqr_tpu_torch.utils.timing; "
            "sys.exit(1 if 'jax' in sys.modules else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_checks_raise_on_nonfinite():
    bad = torch.tensor([[1.0, float("nan")]])
    with pytest.raises(pt.NonFiniteError, match="B contains NaN"):
        pt.utils.checks.assert_all_finite(torch.ones(2), bad,
                                          names=["A", "B"])
