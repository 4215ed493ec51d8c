"""The port's scan-BGS tier (``_block_qr_bgs_scan``) and its checkpointed
driver (``block_qr_resumable``) against the JAX package on the CPU, where
the JAX tier runs its Pallas panels in interpret mode.

Under POLICY_FP32 both packages run the same operations; the port projects
against the written prefix of its Q buffer where the JAX tier projects
against the whole buffer (zeros included), so they differ in summation
order only: 1e-4 of the entries' scale.  Under POLICY_MIXED_FAST the bf16
roundings differ: the metric triple within 2x and R within a relative
Frobenius distance.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.models import resumable as jres
from mixedprecisionblockqr_tpu.ops import blockqr as jbq
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu_torch.models import resumable as tres
from mixedprecisionblockqr_tpu_torch.ops import blockqr as tbq
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns

R = 32
#: panel_method -> (reorth, reorth_grouped), as the drivers wire them
TIERS = {"bgs1": (False, False), "bgs2": (True, True), "bgs": (True, False)}


def _mat(m, n, seed):
    return np.random.default_rng(seed).random((m, n), dtype=np.float32) - 0.5


def _close(t, j, atol=1e-4):
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * max(1.0, float(np.abs(j).max())))


def _both(a, b, pm, g, jpol, tpol):
    reorth, grouped = TIERS[pm]
    out_j = jbq._block_qr_bgs_scan(
        jnp.asarray(a), R, jpol, True, None if b is None else jnp.asarray(b),
        reorth=reorth, group_panels=g, reorth_grouped=grouped)
    out_t = tbq._block_qr_bgs_scan(
        torch.from_numpy(a), R, tpol, True,
        None if b is None else torch.from_numpy(b),
        reorth=reorth, group_panels=g, reorth_grouped=grouped)
    return out_j, out_t


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("shape", [(256, 256), (384, 256)])
@pytest.mark.parametrize("pm", list(TIERS))
def test_scan_fp32_matches_jax(pm, shape, g):
    a = _mat(*shape, seed=5)
    b = _mat(shape[0], 3, seed=6)
    a0 = a.copy()
    (Rj, Qj, Bj), (Rt, Qt, Bt) = _both(a, b, pm, g, jpolicy.POLICY_FP32,
                                       pt.POLICY_FP32)
    assert np.array_equal(a, a0), "the driver modified its input"
    assert tuple(Rt.shape) == (shape[0], 256) and Qt.dtype == torch.float32
    _close(Rt.numpy(), Rj)
    _close(Qt.numpy(), Qj)
    _close(Bt.numpy(), Bj)
    assert (np.tril(Rt.numpy(), -1) == 0).all()
    rep = pt.metrics.evaluate(torch.from_numpy(a), Qt, Rt[:256], 23)
    assert rep.backward < rep.limit, str(rep)
    if pm != "bgs1":  # the reorth tiers meet the fp32 criteria
        assert rep.all_ok, str(rep)


@pytest.mark.parametrize("pm", list(TIERS))
def test_scan_without_b_matches_jax(pm):
    a = _mat(256, 256, seed=7)
    (Rj, Qj, Bj), (Rt, Qt, Bt) = _both(a, None, pm, 1, jpolicy.POLICY_FP32,
                                       pt.POLICY_FP32)
    assert Bj is None and Bt is None
    _close(Rt.numpy(), Rj)
    _close(Qt.numpy(), Qj)
    R_only, Qn, _ = tbq._block_qr_bgs_scan(torch.from_numpy(a), R,
                                           pt.POLICY_FP32, False,
                                           reorth=TIERS[pm][0])
    assert Qn is None and torch.equal(R_only, Rt)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("pm", list(TIERS))
def test_scan_mixed_quality_matches_jax(pm, g):
    a = _mat(256, 256, seed=8)
    (Rj, Qj, _), (Rt, Qt, _) = _both(a, None, pm, g,
                                     jpolicy.POLICY_MIXED_FAST,
                                     pt.POLICY_MIXED_FAST)
    # bgs1 keeps the compact Q, the reorth tiers return fp32
    want = torch.bfloat16 if pm == "bgs1" else torch.float32
    assert Qt.dtype == want and str(Qj.dtype) == str(want).split(".")[1]
    rj = jmetrics.evaluate(a, np.asarray(Qj, np.float32),
                           np.asarray(Rj, np.float32), precision_bits=8)
    rt = pt.metrics.evaluate(torch.from_numpy(a), Qt, Rt, 8)
    assert rt.all_ok and rj.all_ok, (str(rt), str(rj))
    for f in ("backward", "orthogonality"):
        vt, vj = getattr(rt, f), getattr(rj, f)
        assert vt <= 2 * vj + 1e-12 and vj <= 2 * vt + 1e-12, (f, vt, vj)
    rel = (np.linalg.norm(Rt.numpy() - np.asarray(Rj, np.float32))
           / np.linalg.norm(np.asarray(Rj, np.float32)))
    # bf16 projections round differently (bgs1: 2^-9 per entry); the
    # reorth tiers project in fp32 and agree to fp32 roundoff.
    assert rel <= (1e-2 if pm == "bgs1" else 1e-5), rel


def test_scan_group_fallback_and_rescrub_span(monkeypatch):
    # g falls back to 1 unless it divides the panel count and the tier is
    # single-pass or grouped-reorth; the rescrub covers the last
    # ceil(max(2, nb // 8) / g) steps, each panel against everything
    # written before it (in-group panels included).
    a = torch.from_numpy(_mat(384, 384, seed=9))  # nb = 12
    seen = []
    rescrub = tbq._rescrub_panel

    def recording(Qpre, qk, t):
        seen.append(Qpre.shape[1])
        return rescrub(Qpre, qk, t)

    monkeypatch.setattr(tbq, "_rescrub_panel", recording)
    for kw, nsteps, widths in (
        (dict(reorth=False, group_panels=4), 3, []),
        (dict(reorth=False, group_panels=5), 12, []),          # 5 !| 12
        (dict(reorth=True, group_panels=4), 12, [320, 352]),   # 'bgs': g = 1
        (dict(reorth=True, group_panels=4, reorth_grouped=True), 3,
         [256, 288, 320, 352]),
        (dict(reorth=True, group_panels=1), 12, [320, 352]),
    ):
        seen.clear()
        _, _, n = tbq._bgs_scan_machinery(a, None, R, pt.POLICY_FP32,
                                          chain_mid=False, **kw)
        assert n == nsteps, kw
        tbq._block_qr_bgs_scan(a, R, pt.POLICY_FP32, True, **kw)
        assert seen == widths, (kw, seen)


def test_scan_panel_gate_picks_k3_or_k1_composition(monkeypatch):
    # m * r * 4 * 5 <= 14 MiB: the fused panel (K3, robust); taller panels
    # take the three-chain composition over K1.
    a = torch.from_numpy(_mat(128, 64, seed=10))
    calls = []
    k3, comp = tbq.panel_qr_fused, tbq.tri_cholqr_robust_fused
    monkeypatch.setattr(tbq, "panel_qr_fused",
                        lambda P, **kw: calls.append(("k3", kw)) or k3(P, **kw))
    monkeypatch.setattr(
        tbq, "tri_cholqr_robust_fused",
        lambda P, **kw: calls.append(("k1", kw)) or comp(P, **kw))
    R1, Q1, _ = tbq._block_qr_bgs_scan(a, R, pt.POLICY_FP32, True,
                                       reorth=False)
    assert calls == [("k3", dict(robust=True, chain_mid=False))] * 2
    calls.clear()
    monkeypatch.setattr(tbq, "SCAN_FUSED_PANEL_MAX_BYTES", 128 * R * 4 * 5 - 1)
    R2, Q2, _ = tbq._block_qr_bgs_scan(a, R, pt.POLICY_FP32, True,
                                       reorth=False)
    assert calls == [("k1", dict(chain_mid=False))] * 2
    _close(R2.numpy(), R1.numpy())
    _close(Q2.numpy(), Q1.numpy())
    assert 5734 * 128 * 4 * 5 <= 14 * 2**20 < 5735 * 128 * 4 * 5


@pytest.mark.parametrize("pm", list(TIERS))
def test_block_qr_scan_runs_the_scan_tier(pm):
    # block_qr(..., loop_mode='scan') reaches the tier with the drivers'
    # wiring (reorth for bgs / bgs2, grouped for bgs2, chain_mid off).
    a = _mat(256, 256, seed=11)
    A = torch.from_numpy(a)
    Q, Rr = pt.block_qr(A, R, pt.POLICY_FP32, mode="complete",
                        panel_method=pm, loop_mode="scan", group_panels=4)
    reorth, grouped = TIERS[pm]
    Rd, Qd, _ = tbq._block_qr_bgs_scan(A, R, pt.POLICY_FP32, True,
                                       reorth=reorth, group_panels=4,
                                       reorth_grouped=grouped)
    assert torch.equal(Q, Qd) and torch.equal(Rr, Rd)
    Qj, Rj = jbq.block_qr(jnp.asarray(a), R, jpolicy.POLICY_FP32,
                          mode="complete", panel_method=pm, loop_mode="scan",
                          group_panels=4)
    _close(Rr.numpy(), Rj)
    _close(Q.numpy(), Qj)


def test_auto_dispatch_beyond_12288_resolves_to_bgs_scan():
    for pol, quality, want in (
        ("mixed_fast", "fast", ("bgs1", "scan", 4)),
        ("mixed_fast", "balanced", ("bgs2", "scan", 4)),
        ("mixed", "high", ("bgs", "scan", 4)),
        ("fp32", None, ("bgs", "scan", 4)),
    ):
        got = tbq.resolve_panel_config(
            16384, 16384, 128, pt.policy_by_name(pol), "auto", "unroll", 4,
            mode="complete", on_gpu=True, quality=quality)
        ref = jbq.resolve_panel_config(
            16384, 16384, 128, jpolicy.policy_by_name(pol), "auto", "unroll",
            4, mode="complete", on_tpu=True, quality=quality)
        assert got == want == tuple(ref), (pol, quality, got, ref)


def test_scan_canary_on_nan_input():
    a = _mat(256, 256, seed=12)
    a[100, 70] = np.nan
    Q, Rr = pt.block_qr(torch.from_numpy(a), R, pt.POLICY_FP32,
                        panel_method="bgs1", loop_mode="scan")
    assert not torch.isfinite(Rr[0, 0]) and not torch.isfinite(Q[0, 0])
    with pytest.raises(pt.NonFiniteError, match="even via 'bgs'"):
        pt.block_qr(torch.from_numpy(a), R, pt.POLICY_FP32,
                    panel_method="bgs1", loop_mode="scan", check="sync")


def test_scan_sync_retry_runs_bgs_scan(monkeypatch):
    # A poisoned cholqr scan retries through the all-robust 'bgs' scan
    # tier: the result is that tier's.
    a = _mat(256, 256, seed=13)
    A = torch.from_numpy(a)

    def poisoned(A, block_size, policy, want_q, B=None, panel_method=""):
        Rf = torch.full((A.shape[0], A.shape[1]), float("nan"))
        return Rf, torch.zeros((A.shape[0], A.shape[0])), None

    monkeypatch.setattr(tbq, "_block_qr_scan", poisoned)
    Q, Rr = pt.block_qr(A, R, pt.POLICY_MIXED, panel_method="cholqr1",
                        loop_mode="scan", check="sync")
    Qb, Rb = pt.block_qr(A, R, pt.POLICY_MIXED, panel_method="bgs",
                         loop_mode="scan")
    assert torch.equal(Rr, Rb) and torch.equal(Q, Qb)
    assert Q.dtype == torch.float32
    assert pt.metrics.evaluate(A, Q, Rr, 8).all_ok


def test_scan_cpu_wrappers_launch_nothing():
    tns.reset_launches()
    pt.block_qr(torch.from_numpy(_mat(128, 64, seed=14)), R, pt.POLICY_FP32,
                panel_method="bgs", loop_mode="scan")
    assert not any(tns.LAUNCHES.values())


# -- checkpoint / resume ---------------------------------------------------


def _resume_kw(**over):
    kw = dict(block_size=R, policy=pt.POLICY_FP32, group_panels=2,
              reorth=False, segment_groups=1)
    kw.update(over)
    return kw


def test_resumed_equals_uninterrupted_bitwise(tmp_path):
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (256, 256)).astype(np.float32))
    ck = str(tmp_path / "interrupted")
    out = pt.block_qr_resumable(a, ck, max_segments=1, **_resume_kw())
    assert out is None and tres._latest_step(ck) == 1
    calls = 1
    while out is None:
        out = pt.block_qr_resumable(a, ck, max_segments=1, **_resume_kw())
        calls += 1
        assert len(os.listdir(ck)) == 1  # the previous step was pruned
    assert calls == 4 and os.listdir(ck) == ["step_4"]
    Qu, Ru = pt.block_qr_resumable(a, str(tmp_path / "one"), **_resume_kw())
    assert torch.equal(out[0], Qu) and torch.equal(out[1], Ru)
    R1, Q1, _ = tbq._block_qr_bgs_scan(a, R, pt.POLICY_FP32, True,
                                       reorth=False, group_panels=2)
    assert torch.equal(Qu, Q1) and torch.equal(Ru, R1)
    # a further call restores the final carry without recomputing
    Q2, R2 = pt.block_qr_resumable(a, ck, **_resume_kw())
    assert torch.equal(Q2, Qu) and torch.equal(R2, Ru)
    pt.clear_checkpoints(ck)
    assert tres._latest_step(ck) is None
    pt.clear_checkpoints(ck)  # safe on a missing path


def test_resumed_bf16_carry_is_bitwise(tmp_path):
    # bgs1 under a compact policy carries a bf16 Q buffer through the
    # checkpoint.
    a = torch.from_numpy(_mat(256, 256, seed=15))
    kw = _resume_kw(policy=pt.POLICY_MIXED_FAST, segment_groups=3)
    ck = str(tmp_path / "ck")
    assert pt.block_qr_resumable(a, ck, max_segments=1, **kw) is None
    Qi, Ri = pt.block_qr_resumable(a, ck, **kw)
    Qu, Ru = pt.block_qr_resumable(a, str(tmp_path / "one"), **kw)
    assert Qi.dtype == torch.bfloat16
    assert torch.equal(Qi, Qu) and torch.equal(Ri, Ru)


def test_half_written_checkpoint_is_ignored(tmp_path):
    a = torch.from_numpy(_mat(128, 128, seed=16))
    ck = tmp_path / "ck"
    assert pt.block_qr_resumable(a, str(ck), max_segments=1,
                                 **_resume_kw()) is None
    (ck / "step_2.tmp").write_bytes(b"torn write")
    assert tres._latest_step(str(ck)) == 1
    Q, Rr = pt.block_qr_resumable(a, str(ck), **_resume_kw())
    Qu, Ru = pt.block_qr_resumable(a, str(tmp_path / "one"), **_resume_kw())
    assert torch.equal(Q, Qu) and torch.equal(Rr, Ru)


@pytest.mark.parametrize("reorth,g", [(False, 2), (True, 1)])
def test_resumable_matches_jax(tmp_path, reorth, g):
    a = np.random.default_rng(3).standard_normal((256, 256)).astype(
        np.float32)
    b = np.random.default_rng(4).standard_normal((256, 3)).astype(np.float32)
    kw = dict(block_size=R, group_panels=g, reorth=reorth, segment_groups=3)
    Qj, Rj, Bj = jres.block_qr_resumable(
        a, str(tmp_path / "j"), policy=jpolicy.POLICY_FP32, B=jnp.asarray(b),
        **kw)
    Qt, Rt, Bt = pt.block_qr_resumable(
        torch.from_numpy(a), str(tmp_path / "t"), policy=pt.POLICY_FP32,
        B=torch.from_numpy(b), **kw)
    _close(Rt.numpy(), Rj)
    _close(Qt.numpy(), Qj)
    _close(Bt.numpy(), Bj)
    np.testing.assert_allclose(Bt.numpy(), Qt.numpy().T @ b, rtol=1e-4,
                               atol=1e-4)
    if reorth:
        rep = pt.metrics.evaluate(torch.from_numpy(a), Qt, Rt, 23)
        assert rep.all_ok and rep.tight_ok, str(rep)


def test_resumable_tall_returns_reduced_factors(tmp_path):
    a = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (128, 64)).astype(np.float32))
    Q, Rr = pt.block_qr_resumable(a, str(tmp_path / "ck"), block_size=R,
                                  segment_groups=8)
    assert Q.shape == (128, 64) and Rr.shape == (64, 64)
    assert pt.metrics.evaluate(a, Q, Rr, 23).all_ok


def test_resumable_contract_errors(tmp_path):
    a = torch.from_numpy(_mat(64, 32, seed=17))
    with pytest.raises(ValueError, match="complete mode only for m == n"):
        pt.block_qr_resumable(a, str(tmp_path / "x"), mode="complete")
    bad = torch.from_numpy(_mat(256, 200, seed=18))
    with pytest.raises(ValueError, match="block_size"):
        pt.block_qr_resumable(bad, str(tmp_path / "x"))
    with pytest.raises(ValueError, match="m >= n"):
        pt.block_qr_resumable(a.T.contiguous(), str(tmp_path / "x"),
                              block_size=R)
    assert not (tmp_path / "x").exists()


def test_resumable_follows_the_device_rule(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _mat(64, 64, seed=19)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.block_qr_resumable(a, str(tmp_path / "ck"), block_size=R)
    Q, _ = pt.block_qr_resumable(a, str(tmp_path / "ck"), block_size=R,
                                 device="cpu")
    assert Q.device.type == "cpu"
