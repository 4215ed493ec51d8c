"""The port's Block Gram-Schmidt slice under the mixed policy, its NaN
canary and its refusals, against the JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.ops import blockqr as jbq
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu_torch.ops import blockqr as tbq
from mixedprecisionblockqr_tpu_torch.ops import policy as tpolicy

TIERS = ("bgs1", "bgs2", "bgs")


@pytest.fixture(scope="module")
def a512():
    return np.random.default_rng(2).random((512, 512), dtype=np.float32) - 0.5


@pytest.fixture(scope="module")
def jax_mixed(a512):
    out = {}
    for pm in TIERS:
        Q, R = jbq.block_qr(jnp.asarray(a512), 32,
                            jpolicy.POLICY_MIXED_FAST, mode="complete",
                            panel_method=pm, group_panels=8)
        out[pm] = jmetrics.evaluate(a512, np.asarray(Q, np.float32),
                                    np.asarray(R, np.float32),
                                    precision_bits=8)
    return out


def _port_mixed(a, pm):
    Q, R = pt.block_qr(torch.from_numpy(a), 32, pt.POLICY_MIXED_FAST,
                       mode="complete", panel_method=pm, group_panels=8)
    assert Q.dtype == (torch.bfloat16 if pm == "bgs1" else torch.float32)
    return pt.metrics.evaluate(torch.from_numpy(a), Q, R, 8)


def _within_2x(rt, rj):
    assert rt.all_ok and rj.all_ok, (str(rt), str(rj))
    for f in ("backward", "orthogonality", "lower_trapezoid"):
        vt, vj = getattr(rt, f), getattr(rj, f)
        assert vt <= 2 * vj + 1e-12 and vj <= 2 * vt + 1e-12, (f, vt, vj)


@pytest.mark.parametrize("pm", TIERS)
def test_slice_mixed_quality_matches_jax(a512, jax_mixed, pm, monkeypatch):
    # bf16 roundings differ between the packages, so the check is the
    # metric triple: each within 2x of the JAX one, all_ok in both.
    # XLA:CPU runs Precision.HIGH (bgs2's scrub) as full fp32, while the
    # port emulates HIGH with the 3-pass bf16 split on every device; for
    # the comparison the emulation is swapped for fp32 as well.
    monkeypatch.setattr(tpolicy, "mm_high", tpolicy.mm_f32)
    _within_2x(_port_mixed(a512, pm), jax_mixed[pm])


def test_bgs2_emulated_high_keeps_its_rung(a512, jax_mixed):
    # With the real 3-pass emulation bgs2's orthogonality sits at the
    # 2^-16 class of HIGH, far below bgs1's single-pass floor.
    rt = _port_mixed(a512, "bgs2")
    assert rt.all_ok, str(rt)
    assert rt.orthogonality <= 1e-5
    assert rt.orthogonality < 1e-3 * jax_mixed["bgs1"].orthogonality
    assert rt.backward <= 2 * jax_mixed["bgs2"].backward


@pytest.fixture(scope="module")
def cond1e9():
    rng = np.random.default_rng(13)
    n = 512
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((U * np.logspace(0, -9, n)) @ V.T).astype(np.float32)


def test_canary_fires_in_both_packages(cond1e9):
    # cond 1e9 is beyond the three-pass chain's fp32 Gram domain: the
    # robust tail must poison R[0, 0] (tests/test_ns_kernel.py:259-277).
    Rj, _, _ = jbq._block_qr_bgs(jnp.asarray(cond1e9), 128,
                                 jpolicy.POLICY_FP32, True, None, 4, False,
                                 reorth=False, ns_impl="group")
    Rt, Qt, _ = tbq._block_qr_bgs(torch.from_numpy(cond1e9), 128,
                                  tpolicy.POLICY_FP32, True, group_panels=4,
                                  reorth=False)
    assert not np.isfinite(np.asarray(Rj)[0, 0])
    assert not torch.isfinite(Rt[0, 0]) and not torch.isfinite(Qt[0, 0])


def test_sync_check_raises_on_breakdown(cond1e9):
    # 'defer' returns the poisoned factors without synchronizing; 'sync'
    # retries through the Householder tier, and raises only when that
    # fails too (a NaN input).
    Q, R = pt.block_qr(torch.from_numpy(cond1e9), 128, pt.POLICY_FP32,
                       mode="complete", panel_method="bgs1")
    assert not torch.isfinite(R[0, 0])
    Q, R = pt.block_qr(torch.from_numpy(cond1e9), 128, pt.POLICY_FP32,
                       mode="complete", panel_method="bgs1", check="sync")
    assert torch.isfinite(R).all() and Q.dtype == torch.float32
    rep = pt.metrics.evaluate(torch.from_numpy(cond1e9), Q, R, 23)
    assert rep.all_ok, str(rep)
    bad = cond1e9.copy()
    bad[7, 3] = np.nan
    with pytest.raises(pt.NonFiniteError, match="even via 'householder'"):
        pt.block_qr(torch.from_numpy(bad), 128, pt.POLICY_FP32,
                    mode="complete", panel_method="bgs1", check="sync")


@pytest.mark.parametrize("scale", [1e6, 1e-12])
def test_scaled_input_no_poison(scale):
    # tests/test_scale_and_sync.py:44-57 on the port: the scale-normalized
    # guard keeps x1e6 and x1e-12 inputs finite.
    a = (np.random.default_rng(0).random((512, 512)) * scale).astype(
        np.float32)
    Q, R = pt.block_qr(torch.from_numpy(a), 64, pt.POLICY_MIXED,
                       panel_method="bgs1", check="sync")
    assert torch.isfinite(R[0, 0])
    rep = pt.metrics.evaluate(torch.from_numpy(a), Q, R, 8)
    assert rep.all_ok, str(rep)


def test_cpu_auto_dispatch_runs_householder():
    # Off the accelerator auto resolves to 'householder', as in the JAX
    # package.
    a = torch.rand((256, 256), generator=torch.Generator().manual_seed(0))
    Q, R = pt.block_qr(a, 64, pt.POLICY_MIXED_FAST, mode="complete",
                       panel_method="auto", quality="fast")
    Qh, Rh = pt.block_qr(a, 64, pt.POLICY_MIXED_FAST, mode="complete",
                         panel_method="householder")
    torch.testing.assert_close(R, Rh, rtol=0, atol=0)
    assert Q.shape == (256, 256) and Q.dtype == torch.bfloat16
    Q, R = pt.qr(a, policy=pt.POLICY_MIXED)
    assert pt.metrics.evaluate(a, Q, R, 8).all_ok


@pytest.mark.parametrize("pm,lm,item", [
    ("bgs1", "scan", "Scan tier"),
])
def test_unported_tiers_raise(pm, lm, item):
    # Every tier of the dispatch table is ported: the BGS scan tier, the
    # last to raise NotImplementedError, now returns its factorization
    # (held against the JAX package in test_torch_scan.py).
    a = torch.rand((256, 256), generator=torch.Generator().manual_seed(1))
    Q, R = pt.block_qr(a, 64, pt.POLICY_MIXED, panel_method=pm, loop_mode=lm)
    assert Q.shape == (256, 256) and R.shape == (256, 256)
    rep = pt.metrics.evaluate(a, Q, R, 8)
    assert rep.all_ok, str(rep)


def test_block_qr_modes_and_reduced_shapes():
    a = torch.from_numpy(
        np.random.default_rng(3).random((384, 256), dtype=np.float32))
    Q, R = pt.block_qr(a, 32, pt.POLICY_FP32, panel_method="bgs")
    assert Q.shape == (384, 256) and R.shape == (256, 256)
    Rr = pt.block_qr(a, 32, pt.POLICY_FP32, mode="r", panel_method="bgs")
    torch.testing.assert_close(Rr, R, rtol=0, atol=0)
    rep = pt.metrics.evaluate(a, Q, R, 23)
    assert rep.all_ok, str(rep)
    with pytest.raises(ValueError, match="POLICY_FP64"):
        pt.block_qr(a.double(), 32, pt.POLICY_FP64, panel_method="bgs1")
