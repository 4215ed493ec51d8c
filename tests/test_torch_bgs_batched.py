"""The BGS tiers on a stack, as the JAX package ``vmap``s them, on the CPU:
``block_qr_batched`` with ``bgs``, ``bgs1`` and ``bgs2`` (one stacked
``_block_qr_bgs`` call: the batched K2 / K1 entries, here their plain
versions), ``block_qr_batched_sharded`` on a one-rank gloo mesh, the NaN
canary a member, and the plain versions of K1, K2 and the combine on
stacks.

Inputs are numpy draws from a seed, B = 3, block 16: a 96 x 64 stack (four
panels, groups of two) and a 64 x 64 stack for ``mode='complete'``.
Under POLICY_FP32 the port and the JAX package differ in summation order
only: 1e-5 of the entries' scale, max(1, max|x|).  A stack and its
members' 2-D calls differ in the batched products' order: 1e-6.  A stack
of one is the 2-D call bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import mixedprecisionblockqr_tpu_torch as pt
import torch_dist_cases as C
import torch_dist_reference as ref
from mixedprecisionblockqr_tpu.ops import blockqr as jbq
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu_torch.ops import blockqr as tbq
from mixedprecisionblockqr_tpu_torch.ops import policy as tpolicy
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns

RTOL = 1e-5
MEMBER_TOL = 1e-6
TIERS = ("bgs", "bgs1", "bgs2")
SHAPES = {"reduced": (96, 64), "r": (96, 64), "complete": (64, 64)}


def _stack(shape, seed, batch=3):
    return np.random.default_rng(seed).random(
        (batch, *shape), dtype=np.float32) - 0.5


def _close(t, j, atol=RTOL):
    j = np.asarray(j, np.float64)
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * scale)


def _member(x, y):
    """A stack's member against its own call: within MEMBER_TOL of the
    member's largest entry (the batched products' summation order)."""
    torch.testing.assert_close(x, y, rtol=0,
                               atol=MEMBER_TOL * float(y.abs().max()))


def _tier_kw(pm):
    """``_block_qr_bgs``'s arguments for a tier, as ``_driver`` sets them."""
    return dict(reorth=pm in ("bgs", "bgs2"), mid_tier=pm == "bgs2",
                chain_mid=pm == "bgs1")


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
@pytest.mark.parametrize("pm", TIERS)
def test_block_qr_batched_bgs_matches_jax(pm, mode, monkeypatch):
    # XLA:CPU runs Precision.HIGH (bgs2's scrub) as full fp32; the port's
    # emulated HIGH is swapped for fp32 as well (test_torch_blockqr.py).
    monkeypatch.setattr(tpolicy, "mm_high", tpolicy.mm_f32)
    a = _stack(SHAPES[mode], 40)
    out_t = pt.block_qr_batched(torch.from_numpy(a), 16, pt.POLICY_FP32,
                                mode=mode, panel_method=pm)
    out_j = jbq.block_qr_batched(jnp.asarray(a), 16, jpolicy.POLICY_FP32,
                                 mode=mode, panel_method=pm)
    if mode == "r":
        out_t, out_j = (out_t,), (out_j,)
    for t, j in zip(out_t, out_j):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t.numpy(), j)


def test_block_qr_batched_bgs1_mixed_quality_matches_jax():
    """bf16 roundings differ between the packages: each member's metric
    triple within 2x of the JAX member's, all_ok in both."""
    a = _stack((128, 64), 41)
    Qt, Rt = pt.block_qr_batched(torch.from_numpy(a), 16,
                                 pt.POLICY_MIXED_FAST, panel_method="bgs1")
    Qj, Rj = jbq.block_qr_batched(jnp.asarray(a), 16,
                                  jpolicy.POLICY_MIXED_FAST,
                                  panel_method="bgs1")
    assert Qt.dtype == torch.bfloat16
    for i in range(3):
        rt = pt.metrics.evaluate(torch.from_numpy(a[i]), Qt[i], Rt[i], 8)
        rj = jmetrics.evaluate(a[i], np.asarray(Qj[i], np.float32),
                               np.asarray(Rj[i], np.float32),
                               precision_bits=8)
        assert rt.all_ok and rj.all_ok, (str(rt), str(rj))
        for f in ("backward", "orthogonality", "lower_trapezoid"):
            vt, vj = getattr(rt, f), getattr(rj, f)
            assert vt <= 2 * vj + 1e-12 and vj <= 2 * vt + 1e-12, (i, f, vt,
                                                                   vj)


@pytest.mark.parametrize("ns_impl", ["group", "panel"])
@pytest.mark.parametrize("pm", TIERS)
def test_bgs_stack_is_each_member(pm, ns_impl):
    """The stacked driver against each member's 2-D call, on both routes,
    with B riding along (Q^T B)."""
    a = torch.from_numpy(_stack((96, 64), 42))
    b = torch.from_numpy(_stack((96, 2), 43))
    R, Q, QtB = tbq._block_qr_bgs(a, 16, pt.POLICY_FP32, True, b,
                                  group_panels=2, ns_impl=ns_impl,
                                  **_tier_kw(pm))
    assert R.shape == (3, 96, 64) and Q.shape == (3, 96, 64)
    assert QtB.shape == (3, 64, 2)
    for i in range(3):
        Ri, Qi, QtBi = tbq._block_qr_bgs(a[i], 16, pt.POLICY_FP32, True,
                                         b[i], group_panels=2,
                                         ns_impl=ns_impl, **_tier_kw(pm))
        for x, y in ((R[i], Ri), (Q[i], Qi), (QtB[i], QtBi)):
            _member(x, y)


@pytest.mark.parametrize("pm", TIERS)
def test_block_qr_batched_bgs_one_member_is_the_2d_call(pm):
    """A stack of one runs the 2-D driver: bit for bit block_qr's result."""
    a = torch.from_numpy(_stack((96, 64), 44, batch=1))
    Qb, Rb = pt.block_qr_batched(a, 16, pt.POLICY_FP32, panel_method=pm)
    Q, R = pt.block_qr(a[0], 16, pt.POLICY_FP32, panel_method=pm)
    assert torch.equal(Qb[0], Q) and torch.equal(Rb[0], R)


@pytest.mark.parametrize("pm", TIERS)
def test_block_qr_batched_bgs_nan_poisons_its_member_only(pm):
    a = _stack((96, 64), 45)
    a[1, 50, 30] = np.nan
    Q, R = pt.block_qr_batched(torch.from_numpy(a), 16, pt.POLICY_FP32,
                               panel_method=pm)
    assert torch.isnan(R[1, 0, 0]) and torch.isnan(Q[1, 0, 0])
    for i in (0, 2):
        assert torch.isfinite(R[i]).all() and torch.isfinite(Q[i]).all()
    _, Rj = jbq.block_qr_batched(jnp.asarray(a), 16, jpolicy.POLICY_FP32,
                                 panel_method=pm)
    assert np.isnan(np.asarray(Rj)[1, 0, 0])
    assert np.isfinite(np.asarray(Rj)[[0, 2]]).all()


def test_bgs_stack_refuses_proj_entry():
    """K5 has no batched entry: proj_entry takes one matrix."""
    a = torch.from_numpy(_stack((96, 64), 46))
    with pytest.raises(ValueError, match="proj_entry"):
        tbq._block_qr_bgs(a, 16, pt.POLICY_MIXED_FAST, True, reorth=False,
                          proj_entry=True)


def _grams(seed, batch=3, m=96, r=16):
    P = torch.from_numpy(_stack((m, r), seed, batch))
    return P, (P.mT @ P).contiguous()


@pytest.mark.parametrize("kw", [
    dict(iters=10), dict(iters=14, shift=1e-3), dict(iters=6, chain_mid=True),
    dict(iters=14, shift=1e-3, omega=False, chain_mid=True),
    dict(iters=10, fuse_xw=False)],
    ids=["plain", "shift", "chain_mid", "shift_mid", "classic"])
def test_ns_chain_plain_stack_is_each_member(kw):
    P, G = _grams(47)
    G[1] *= 1e4  # a member of another scale keeps its own shift and guard
    X, t, resid = ns.ns_chain_plain(G, **kw)
    assert X.shape == t.shape == (3, 16, 16) and resid.shape == (3,)
    for i in range(3):
        Xi, ti, ri = ns.ns_chain_plain(G[i], **kw)
        _member(X[i], Xi)
        _member(t[i], ti)
        assert abs(float(resid[i]) - float(ri)) <= MEMBER_TOL


def test_ns_chain_plain_stack_refine_is_each_member():
    """The identity-seeded refine chain on near-identity Grams."""
    P, G = _grams(48)
    X0, _, _ = ns.ns_chain_plain(G, iters=10)
    Qn = P @ X0
    Gn = (Qn.mT @ Qn).contiguous()
    X, t, resid = ns.ns_chain_plain(Gn, iters=4, refine=True)
    assert bool((resid < 1e-4).all())
    for i in range(3):
        Xi, ti, ri = ns.ns_chain_plain(Gn[i], iters=4, refine=True)
        _member(X[i], Xi)
        _member(t[i], ti)


def test_ns_chain_batched_on_the_cpu_is_the_plain_version():
    """On the CPU the batched wrapper runs the plain version and launches
    nothing."""
    _, G = _grams(49)
    ns.reset_launches()
    out = ns.ns_chain_batched(G, iters=6, chain_mid=True)
    assert not any(ns.LAUNCHES.values()) and not any(
        ns.BATCH_LAUNCHES.values())
    for x, y in zip(out, ns.ns_chain_plain(G, iters=6, chain_mid=True)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bf16", [False, True])
def test_bgs_group_fused_plain_stack_is_each_member(bf16):
    """Four panels, the last one robust, under the fp32 and the bf16 flags:
    the stack against each member's group and the batched wrapper's CPU
    route against the plain version."""
    Pg = torch.from_numpy(_stack((96, 64), 50))
    iters, robust = (12, 6, 6, 10), (False, False, False, True)
    kw = dict(bf16_dots=bf16, chain_mid=bf16)
    Q, Rg, worst = ns.bgs_group_fused_plain(Pg, 16, iters, robust, **kw)
    assert Q.shape == (3, 96, 64) and Rg.shape == (3, 64, 64)
    assert worst.shape == (3,)
    for i in range(3):
        Qi, Ri, wi = ns.bgs_group_fused_plain(Pg[i], 16, iters, robust, **kw)
        _member(Q[i], Qi)
        _member(Rg[i], Ri)
        assert (float(worst[i]) < 1e-4) == (float(wi) < 1e-4)
    for x, y in zip(ns.bgs_group_fused_batched(Pg, 16, iters, robust, **kw),
                    (Q, Rg, worst)):
        assert torch.equal(x, y)


def test_tri_combine_plain_stack_is_each_member():
    P = torch.from_numpy(_stack((96, 16), 51))
    T1, T2, T3 = ns.robust_products(P)
    assert T1.shape == (3, 16, 16)
    out = ns.tri_combine_plain(T1, T2, T3)
    for i in range(3):
        ti = ns.robust_products(P[i])
        _member(out[i], ns.tri_combine_plain(*ti))


def test_tri_cholqr_robust_fused_stack_is_each_member():
    P = torch.from_numpy(_stack((96, 16), 52))
    Q, t, X, resid = ns.tri_cholqr_robust_fused(P, sign_fix=True)
    assert resid.shape == (3,)
    for i in range(3):
        Qi, ti, Xi, ri = ns.tri_cholqr_robust_fused(P[i], sign_fix=True)
        for x, y in ((Q[i], Qi), (t[i], ti), (X[i], Xi)):
            _member(x, y)


def test_rescrub_panel_stack_is_each_member():
    Qpre, _ = torch.linalg.qr(torch.from_numpy(_stack((96, 32), 53)))
    qk, t = torch.linalg.qr(torch.from_numpy(_stack((96, 16), 54)))
    outs = tbq._rescrub_panel(Qpre, qk, t)
    assert outs[3].shape == (3,)
    for i in range(3):
        for x, y in zip(outs, tbq._rescrub_panel(Qpre[i], qk[i], t[i])):
            _member(x[i], y)


@pytest.fixture(scope="module")
def batch_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield pt.make_mesh((1,), ("batch",), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_block_qr_batched_sharded_bgs1_world1_matches_jax(batch_mesh):
    case = {"kind": "batched", "a": (55, (3, 96, 64), True),
            "kw": {"block_size": 16, "panel_method": "bgs1"}}
    Q, R = C.run_port(case, batch_mesh)
    Qj, Rj = ref.reference(case, 1)
    assert Q.shape == Qj.shape and R.shape == Rj.shape
    _close(Q.numpy(), Qj)
    _close(R.numpy(), Rj)
