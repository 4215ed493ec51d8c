"""Panel widths outside (32, 64, 128): the chain kernels' layout rules on a
sample of r, and the port against the JAX package on the CPU at such
widths.

Up to 128 each rule runs a width on the shared-memory route of the
smallest instantiation R in (32, 64, 128) that holds it; above, on the L2
route (operands in a global scratch, at most 16 CTAs).  The C entries check
the layout they are given against the same rule, so the rule is tested
here on shapes alone.  The parity cases run the port's plain kernel
versions against the JAX package (Pallas in interpret mode or its XLA
branch) with the tolerances of the r = 32 / 64 / 128 tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.models import lstsq as jlstsq
from mixedprecisionblockqr_tpu.ops import blockqr as jbq
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.utils.datagen import (
    gauge_deficient_system,
)

WIDTHS = (1, 16, 48, 96, 100, 125, 128, 129, 192, 256, 512)
RULES = {"ns_layout": tns.ns_layout, "ninv_layout": tns.ninv_layout,
         "combine_layout": tns.combine_layout,
         "group_layout": lambda r: tns.group_layout(2048, r).chain}


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("r", WIDTHS)
def test_layout_rules_take_every_width(rule, r):
    lay = RULES[rule](r)
    assert lay.smem_bytes <= tns.SMEM_LIMIT and 1 <= lay.ctas <= 16
    if r <= 128:
        R = min(x for x in (32, 64, 128) if x >= r)
        assert (lay.inst, lay.route, lay.scratch_floats) == (R, "smem", 0)
    else:
        assert (lay.inst, lay.route) == (0, "l2")
        # every operand the route keeps whole, rows padded to 16 bytes
        assert lay.scratch_floats % (r * -(-r // 4) * 4) == 0
        assert lay.scratch_floats > 0


@pytest.mark.parametrize("r", [129, 192, 256, 512, 1024])
def test_l2_route_clusters_follow_the_card(r):
    # ceil(r / 16) CTAs, at most 16 and at most the card's largest
    # cluster; the combine's L2 route a cluster of its ceil(r / 32) row
    # blocks a column block, capped alike.
    assert tns.ns_layout(r).ctas == min(16, -(-r // 16))
    assert tns.ns_layout(r, 8).ctas == tns.ninv_layout(r, 8).ctas == 8
    assert tns.combine_layout(r).ctas == min(16, -(-r // 32))
    assert tns.combine_layout(r, 2).ctas == 2


@pytest.mark.parametrize("r", [0, tns.MAX_WIDTH + 1])
def test_layout_rules_name_the_largest_width(r):
    for rule in (tns.ns_layout, tns.ninv_layout, tns.combine_layout):
        with pytest.raises(ValueError, match="MAX_WIDTH = 1024"):
            rule(r)


@pytest.mark.parametrize("r,bn,bm_panel", [(48, 64, 16), (100, 128, 16),
                                           (125, 128, 16), (192, 128, 16),
                                           (256, 128, 16), (16, 32, 32)])
def test_group_layout_column_tile_is_the_instantiation(r, bn, bm_panel):
    lay = tns.group_layout(2048, r)
    assert (lay.bn, lay.bm_panel) == (bn, bm_panel)
    assert lay.args() == (*lay[:5], *tns._c_layout(lay.chain))
    assert len(lay.args()) == 10


def test_cpu_wrappers_take_any_width_and_count_nothing():
    tns.reset_launches()
    rng = np.random.default_rng(0)
    for r in (48, 100, 192):
        P = torch.from_numpy(rng.standard_normal((4 * r, r)).astype(
            np.float32))
        G = P.T @ P
        X, t, res = tns.ns_chain(G, iters=12)
        assert float(res) < 1e-4
        np.testing.assert_allclose((X.T @ G @ X).numpy(), np.eye(r),
                                   atol=1e-3)
        S = torch.eye(r) * 1.2
        Xs, rs = tns.ninv_chain(S, iters=6)
        assert float(rs) < 1e-4
        T = [torch.eye(r) + 0.1 * torch.from_numpy(
            rng.standard_normal((r, r)).astype(np.float32)) for _ in "123"]
        assert torch.equal(tns.tri_combine(*T), tns.tri_combine_plain(*T))
    assert not any(tns.LAUNCHES.values())
    assert tns.PIECE_LAUNCHES == {"tri_combine": 0}


@pytest.fixture(scope="module")
def a384():
    return np.random.default_rng(0).random((384, 384), dtype=np.float32) - 0.5


@pytest.mark.parametrize("pm", ["bgs1", "bgs2"])
@pytest.mark.parametrize("r", [96, 192])
def test_bgs_at_other_widths_matches_jax(a384, pm, r):
    # The fp32 parity of tests/test_torch_blockqr.py (atol 1e-4) at r = 96
    # (4 panels, on R = 128) and r = 192 (2 panels, the L2 route's width).
    A = torch.from_numpy(a384)
    Q, R = pt.block_qr(A, r, pt.POLICY_FP32, mode="complete",
                       panel_method=pm, group_panels=8)
    Qj, Rj = jbq.block_qr(jnp.asarray(a384), r, jpolicy.POLICY_FP32,
                          mode="complete", panel_method=pm, group_panels=8)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), atol=1e-4)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-4)
    assert pt.metrics.evaluate(A, Q, R, 23).all_ok


def test_bgs_at_r50_matches_jax():
    # 200^2 at r = 50: four panels of a width that is not a multiple of 4.
    a = np.random.default_rng(3).random((200, 200), dtype=np.float32) - 0.5
    Q, R = pt.block_qr(torch.from_numpy(a), 50, pt.POLICY_FP32,
                       mode="complete", panel_method="bgs1")
    Qj, Rj = jbq.block_qr(jnp.asarray(a), 50, jpolicy.POLICY_FP32,
                          mode="complete", panel_method="bgs1")
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), atol=1e-4)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-4)


def test_polar_at_r192_matches_jax_quality():
    # tests/test_torch_polar.py's mixed-quality gate (the metric triple
    # within 2x) on a tall complete Q at r = 192: K1 and K4 at 192.
    a = np.random.default_rng(4).standard_normal((768, 384)).astype(
        np.float32)
    Qt, Rt = pt.block_qr(torch.from_numpy(a), 192, pt.POLICY_MIXED,
                         mode="complete", panel_method="polar")
    Qj, Rj = jbq.block_qr(jnp.asarray(a), 192, jpolicy.POLICY_MIXED,
                          mode="complete", panel_method="polar")
    rt = pt.metrics.evaluate(torch.from_numpy(a), Qt, Rt, 8)
    rj = jmetrics.evaluate(a, np.asarray(Qj, np.float32),
                           np.asarray(Rj, np.float32), precision_bits=8)
    assert rt.all_ok and rt.tight_ok and rj.all_ok, (str(rt), str(rj))
    for f in ("backward", "orthogonality"):
        vt, vj = getattr(rt, f), getattr(rj, f)
        assert vt <= 2 * vj + 1e-9 and vj <= 2 * vt + 1e-9, (f, vt, vj)


def test_lstsq_block48_matches_jax_and_numpy():
    # tests/test_torch_pivoted.py's gauge-deficient solve (x within 1e-4 of
    # numpy's and of JAX's, residual within 1e-5) at block_size=48: the
    # blocked Householder stage runs 48-wide panels; the tripwire's
    # lstsq_pivoted keeps its own block of 128 in both packages.
    J, b = gauge_deficient_system(1024, 512, 32)
    x_np = np.linalg.lstsq(J.astype(np.float64), -b.astype(np.float64),
                           rcond=np.finfo(np.float32).eps * 1024)[0]
    x_t = pt.lstsq(torch.from_numpy(J), -torch.from_numpy(b),
                   block_size=48).numpy()
    x_j = np.asarray(jlstsq.lstsq(J, -b, block_size=48))

    def rel(x, y):
        return np.linalg.norm(x - y) / np.linalg.norm(y)

    assert rel(x_t, x_np) <= 1e-4 and rel(x_t, x_j) <= 1e-4

    def resid(x):
        return np.linalg.norm(J.astype(np.float64) @ x.astype(np.float64) + b)

    assert abs(resid(x_t) - resid(x_np)) <= 1e-5 * resid(x_np)


def test_rqrcp_block48_solve_matches_jax_and_numpy():
    # RQRCP itself at block_size=48 (576 = 12 panels of 48: K3, K7 and the
    # chains at 48 on the card), then lstsq_pivoted's min-norm solve on its
    # factor, in both packages: x within 1e-4 of numpy's, ranks equal.
    from mixedprecisionblockqr_tpu.ops import pivoted as jpiv

    J, b = gauge_deficient_system(1024, 576, 32)
    x_np, _, rank, _ = np.linalg.lstsq(
        J.astype(np.float64), -b.astype(np.float64),
        rcond=np.finfo(np.float32).eps * 1024)

    def solve(R, qtb, perm):
        R, qtb = np.asarray(R, np.float64), np.asarray(qtb, np.float64)
        d = np.abs(np.diag(R))
        k = int((d > np.finfo(np.float32).eps * 1024 * d.max()).sum())
        y = np.linalg.lstsq(R[:k], qtb[:k], rcond=None)[0]
        x = np.zeros_like(y)
        x[np.asarray(perm)] = y
        return x, k

    R, qtb, perm = pt.pivoted_qr_qtb(torch.from_numpy(J),
                                     -torch.from_numpy(b), method="rqrcp",
                                     block_size=48)
    assert pt.numerical_rank(R, m=1024) == rank == 544
    x_t, k_t = solve(R.numpy(), qtb.numpy(), perm.numpy())
    Rj, qj, pj = jpiv.pivoted_qr_qtb(J, -b, method="rqrcp", block_size=48)
    x_j, k_j = solve(Rj, qj, pj)
    assert k_t == k_j == rank

    def rel(x, y):
        return np.linalg.norm(x - y) / np.linalg.norm(y)

    assert rel(x_t, x_np) <= 1e-4 and rel(x_j, x_np) <= 1e-4
    x_p = pt.lstsq_pivoted(torch.from_numpy(J), -torch.from_numpy(b))
    assert rel(x_p.numpy(), x_np) <= 1e-4
