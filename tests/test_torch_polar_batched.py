"""The ``polar`` tier on a stack, as the JAX package ``vmap``s it, on the
CPU: ``block_qr_batched(..., panel_method='polar')`` (one stacked
``_block_qr_grouped`` call: the batched K1 and K4 entries, here their plain
versions), ``block_qr_batched_sharded`` on a one-rank gloo mesh, the NaN
canary a member, the plain versions of K4 and ``tri_cholqr_fused`` on
stacks, K4's batched C entry and its bound.

Inputs are numpy draws from a seed, B = 3, block 16: a 128 x 64 stack
(four tall panels), a 64 x 64 stack (tall panels, the LU fallback armed at
aspect < 4, a robust tail panel and the square final panel) and a 96 x 64
stack with groups of two.  Under POLICY_FP32 the port and the JAX package
differ in summation order only: 1e-5 of the entries' scale, max(1,
max|x|).  A stack and its members' 2-D calls differ in the batched
products' order: 1e-6 of the same scale, 2e-6 on the square stack, whose
aspect-2 panel's LU fallback and three robust tail chains carry the
batched products' roundoff further (1.3e-6 measured on the CPU).  A stack
of one is the 2-D call bit for bit.
"""

import ctypes

import jax
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
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns
from mixedprecisionblockqr_tpu_torch.utils import bounds

RTOL = 1e-5
MEMBER_TOL = 1e-6
SHAPES = {"reduced": (128, 64), "r": (128, 64), "complete": (64, 64)}
#: (shape, group_panels, tolerance) of the stack-against-members cases.
GROUPED = {"128x64_g4": ((128, 64), 4, MEMBER_TOL),
           "64x64_g4": ((64, 64), 4, 2 * MEMBER_TOL),
           "96x64_g2": ((96, 64), 2, MEMBER_TOL)}


def _stack(shape, seed, batch=3):
    return np.random.default_rng(seed).random(
        (batch, *shape), dtype=np.float32) - 0.5


def _close(t, j, atol=RTOL):
    j = np.asarray(j, np.float64)
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * scale)


def _member(x, y, tol=MEMBER_TOL):
    """A stack's member against its own call: within ``tol`` of the
    entries' scale, max(1, max|y|) (the batched products' summation
    order)."""
    torch.testing.assert_close(
        x, y, rtol=0, atol=tol * max(1.0, float(y.abs().max())))


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_block_qr_batched_polar_matches_jax(mode):
    a = _stack(SHAPES[mode], 60)
    out_t = pt.block_qr_batched(torch.from_numpy(a), 16, pt.POLICY_FP32,
                                mode=mode, panel_method="polar")
    out_j = jbq.block_qr_batched(jnp.asarray(a), 16, jpolicy.POLICY_FP32,
                                 mode=mode, panel_method="polar")
    if mode == "r":
        out_t, out_j = (out_t,), (out_j,)
    for t, j in zip(out_t, out_j):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t.numpy(), j)


def test_polar_stack_groups_of_two_match_jax():
    """The 96 x 64 stack with groups of two panels, against the JAX driver
    under ``jax.vmap`` with the same group size."""
    a = _stack((96, 64), 61)
    R, Q, _ = tbq._block_qr_grouped(torch.from_numpy(a), 16, pt.POLICY_FP32,
                                    True, group_panels=2)
    Rj, Qj, _ = jax.jit(jax.vmap(lambda x: jbq._block_qr_grouped(
        x, 16, jpolicy.POLICY_FP32, True, None, group_panels=2)))(
            jnp.asarray(a))
    _close(R.numpy(), Rj)
    _close(Q.numpy(), Qj)


def test_block_qr_batched_polar_mixed_quality_matches_jax():
    """bf16 roundings differ between the packages: each member's metric
    triple within 2x of the JAX member's, all_ok in both."""
    a = _stack((128, 64), 62)
    Qt, Rt = pt.block_qr_batched(torch.from_numpy(a), 16,
                                 pt.POLICY_MIXED_FAST, mode="complete",
                                 panel_method="polar")
    Qj, Rj = jbq.block_qr_batched(jnp.asarray(a), 16,
                                  jpolicy.POLICY_MIXED_FAST, mode="complete",
                                  panel_method="polar")
    assert Qt.shape == (3, 128, 128)
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


@pytest.mark.parametrize("case", sorted(GROUPED))
def test_polar_stack_is_each_member(case):
    """The stacked driver against each member's 2-D call, with B riding
    along (Q^T B)."""
    shape, g, tol = GROUPED[case]
    a = torch.from_numpy(_stack(shape, 63))
    b = torch.from_numpy(_stack((shape[0], 2), 64))
    R, Q, QtB = tbq._block_qr_grouped(a, 16, pt.POLICY_FP32, True, b,
                                      group_panels=g)
    assert R.shape == (3, *shape) and Q.shape == (3, shape[0], shape[0])
    assert QtB.shape == (3, shape[0], 2)
    for i in range(3):
        Ri, Qi, QtBi = tbq._block_qr_grouped(a[i], 16, pt.POLICY_FP32, True,
                                             b[i], group_panels=g)
        for x, y in ((R[i], Ri), (Q[i], Qi), (QtB[i], QtBi)):
            _member(x, y, tol)


def test_block_qr_batched_polar_one_member_is_the_2d_call():
    """A stack of one runs the 2-D driver: bit for bit block_qr's result."""
    a = torch.from_numpy(_stack((64, 64), 65, batch=1))
    Qb, Rb = pt.block_qr_batched(a, 16, pt.POLICY_FP32, mode="complete",
                                 panel_method="polar")
    Q, R = pt.block_qr(a[0], 16, pt.POLICY_FP32, mode="complete",
                       panel_method="polar")
    assert torch.equal(Qb[0], Q) and torch.equal(Rb[0], R)


def test_block_qr_batched_polar_nan_poisons_its_member_only():
    a = _stack((128, 64), 66)
    a[1, 50, 30] = np.nan
    Q, R = pt.block_qr_batched(torch.from_numpy(a), 16, pt.POLICY_FP32,
                               panel_method="polar")
    assert torch.isnan(R[1, 0, 0]) and torch.isnan(Q[1, 0, 0])
    for i in (0, 2):
        assert torch.isfinite(R[i]).all() and torch.isfinite(Q[i]).all()
    _, Rj = jbq.block_qr_batched(jnp.asarray(a), 16, jpolicy.POLICY_FP32,
                                 panel_method="polar")
    assert np.isnan(np.asarray(Rj)[1, 0, 0])
    assert np.isfinite(np.asarray(Rj)[[0, 2]]).all()


def _yamamoto_stack(seed, m=64, r=16, batch=3):
    """Sign-fixed Yamamoto S matrices of uniform m x r panels."""
    Qb, _ = torch.linalg.qr(torch.from_numpy(_stack((m, r), seed, batch)))
    D = torch.where(torch.diagonal(Qb[:, :r], dim1=-2, dim2=-1) > 0, -1.0,
                    1.0)
    return (torch.eye(r) - (Qb * D[:, None, :])[:, :r].mT).contiguous()


@pytest.mark.parametrize("iters", [5, 12])
def test_ninv_chain_plain_stack_is_each_member(iters):
    """One inverse and one residual a member; a singular member and a NaN
    member keep their own residual and leave the others alone."""
    S = _yamamoto_stack(67)
    S[1, :, 3] = 0.0  # singular: its residual stays ~1, above 1e-3
    S[2, 4, 9] = float("nan")
    X, resid = ns.ninv_chain_plain(S, iters)
    assert X.shape == (3, 16, 16) and resid.shape == (3,)
    assert float(resid[0]) < 1e-3 and float(resid[1]) >= 1e-3
    assert torch.isnan(resid[2]) and torch.isfinite(X[:2]).all()
    for i in range(3):
        Xi, ri = ns.ninv_chain_plain(S[i], iters)
        assert ri.shape == ()
        assert torch.equal(torch.isnan(ri), torch.isnan(resid[i]))
        if i < 2:
            _member(X[i], Xi)
            assert abs(float(resid[i]) - float(ri)) <= MEMBER_TOL * max(
                1.0, float(ri))


def test_ninv_chain_batched_on_the_cpu_is_the_plain_version():
    """On the CPU the batched wrapper runs the plain version and launches
    nothing."""
    S = _yamamoto_stack(68)
    ns.reset_launches()
    out = ns.ninv_chain_batched(S, 8)
    assert not any(ns.LAUNCHES.values()) and not any(
        ns.BATCH_LAUNCHES.values()) and not any(ns.BATCH_MEMBERS.values())
    for x, y in zip(out, ns.ninv_chain_plain(S, 8)):
        assert torch.equal(x, y)


def test_tri_cholqr_fused_stack_is_each_member():
    P = torch.from_numpy(_stack((96, 16), 69))
    Q, t, X, resid = ns.tri_cholqr_fused(P, iters=8)
    assert Q.shape == (3, 96, 16) and resid.shape == (3,)
    assert bool((torch.diagonal(Q[:, :16], dim1=-2, dim2=-1) <= 0).all())
    for i in range(3):
        Qi, ti, Xi, ri = ns.tri_cholqr_fused(P[i], iters=8)
        for x, y in ((Q[i], Qi), (t[i], ti), (X[i], Xi)):
            _member(x, y)
        assert (float(resid[i]) ** 2 < 1e-4) == (float(ri) ** 2 < 1e-4)


def test_ninv_chain_batched_entry_takes_the_batch():
    """The batched C entry takes S, X, resid, the scratch, then B, r, iters,
    the layout's five numbers and the stream: the single entry's arguments
    with B before r; the resident-cluster query takes r, the layout and an
    int pointer."""

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    lib = _build._declare(Lib())
    single = lib.mpbqr_ninv_chain.argtypes
    args = lib.mpbqr_ninv_chain_batched.argtypes
    assert args.count(ctypes.c_void_p) == 5  # S, X, resid, scratch, stream
    assert args == [*single[:4], ctypes.c_int, *single[4:]]
    assert lib.mpbqr_ninv_chain_batched.restype is ctypes.c_int
    res = lib.mpbqr_ninv_chain_resident.argtypes
    assert res[:6] == [ctypes.c_int] * 6 and len(res) == 7


@pytest.mark.parametrize("B,r,iters", [(8, 128, 5), (16, 128, 12),
                                       (4, 256, 5)])
def test_ninv_chain_batched_bound_is_b_members(B, r, iters):
    one = bounds.ninv_chain_bound(r, iters)
    row = bounds.ninv_chain_batched_bound(B, r, iters)
    ops = B * (2 * iters + 1) * 2 * r ** 3
    assert row["bound_by"] == "operations"
    assert row["bound_ms"] == pytest.approx(ops / bounds.PEAK_F32 * 1e3,
                                            rel=1e-12)
    assert row["bound_ms"] == pytest.approx(B * one["bound_ms"], rel=1e-12)
    assert row["member_floor_ms"] == one["cluster_bound_ms"]
    assert row["cluster_sms"] == one["cluster_sms"] == ns.ninv_layout(
        r).ctas


@pytest.fixture(scope="module")
def batch_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield pt.make_mesh((1,), ("batch",), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_block_qr_batched_sharded_polar_world1_matches_jax(batch_mesh):
    case = {"kind": "batched", "a": (70, (3, 96, 64), True),
            "kw": {"block_size": 16, "panel_method": "polar"}}
    Q, R = C.run_port(case, batch_mesh)
    Qj, Rj = ref.reference(case, 1)
    assert Q.shape == Qj.shape and R.shape == Rj.shape
    _close(Q.numpy(), Qj)
    _close(R.numpy(), Rj)
