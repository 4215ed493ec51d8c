"""The port's batched entry points as the JAX package ``vmap``s them, on the
CPU: ``block_qr_batched`` (each reflector tier on the whole stack),
``lstsq_batched``, ``block_qr_batched_sharded`` on a one-rank gloo mesh,
CAQR's stacked replays (``apply_qt`` / ``apply_q`` / ``caqr``), and the
CholeskyQR / Yamamoto helpers on stacks.

Inputs are numpy draws from a seed, B = 3: 96 x 64 at block 16 and a
ragged 100 x 40 at block 16 (a last panel of 8 columns).  Under
POLICY_FP32 the port and the JAX package differ in summation order only:
1e-5 relative (the entries' scale, max(1, max|x|), or the relative
Frobenius norm, as each test says).  A stack of one is the 2-D call bit
for bit, and a NaN in one member poisons that member's canary only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import mixedprecisionblockqr_tpu_torch as pt
import torch_dist_cases as C
import torch_dist_reference as ref
from mixedprecisionblockqr_tpu.models import lstsq as jls
from mixedprecisionblockqr_tpu.ops import blockqr as jbq
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu.parallel import caqr as jc
from mixedprecisionblockqr_tpu_torch.models import lstsq as tls
from mixedprecisionblockqr_tpu_torch.ops import cholqr as tcq
from mixedprecisionblockqr_tpu_torch.ops import policy as tpol
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import LAUNCHES
from mixedprecisionblockqr_tpu_torch.parallel import caqr as tc
from mixedprecisionblockqr_tpu_torch.parallel import tsqr as tts

RTOL = 1e-5
TIERS = ("householder", "householder_pallas", "cholqr1", "cholqr2",
         "cholqr2s", "cholqr1x2")
SHAPES = {"96x64": (96, 64), "ragged100x40": (100, 40)}


def _stack(shape, seed, batch=3):
    return np.random.default_rng(seed).random(
        (batch, *shape), dtype=np.float32) - 0.5


def _close(t, j, atol=RTOL):
    j = np.asarray(j, np.float64)
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * scale)


def _rel(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
@pytest.mark.parametrize("pm", TIERS)
def test_block_qr_batched_tier_matches_jax(pm, mode):
    a = _stack(SHAPES["96x64"], 20)
    out_t = pt.block_qr_batched(torch.from_numpy(a), 16, pt.POLICY_FP32,
                                mode=mode, panel_method=pm)
    out_j = jbq.block_qr_batched(jnp.asarray(a), 16, jpolicy.POLICY_FP32,
                                 mode=mode, panel_method=pm)
    if mode == "r":
        out_t, out_j = (out_t,), (out_j,)
    for t, j in zip(out_t, out_j):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t.numpy(), j)


@pytest.mark.parametrize("pm", TIERS)
def test_block_qr_batched_ragged_matches_jax(pm):
    a = _stack(SHAPES["ragged100x40"], 21)
    Qt, Rt = pt.block_qr_batched(torch.from_numpy(a), 16, pt.POLICY_FP32,
                                 panel_method=pm)
    Qj, Rj = jbq.block_qr_batched(jnp.asarray(a), 16, jpolicy.POLICY_FP32,
                                  panel_method=pm)
    assert Qt.shape == (3, 100, 40) and Rt.shape == (3, 40, 40)
    _close(Qt.numpy(), Qj)
    _close(Rt.numpy(), Rj)


@pytest.mark.parametrize("pm", TIERS)
def test_block_qr_batched_one_member_is_the_2d_call(pm):
    """A stack of one runs the 2-D driver: bit for bit block_qr's result."""
    a = torch.from_numpy(_stack(SHAPES["ragged100x40"], 22, batch=1))
    Qb, Rb = pt.block_qr_batched(a, 16, pt.POLICY_FP32, panel_method=pm)
    Q, R = pt.block_qr(a[0], 16, pt.POLICY_FP32, panel_method=pm)
    assert torch.equal(Qb[0], Q) and torch.equal(Rb[0], R)


@pytest.mark.parametrize("pm", ["householder", "cholqr2", "cholqr1x2"])
def test_block_qr_batched_nan_poisons_its_member_only(pm):
    a = _stack(SHAPES["96x64"], 23)
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


def test_block_qr_batched_member_loop_tiers_stack():
    """polar, the last tier that ran member by member, runs on the whole
    stack too: each member within 1e-6 of its 2-D call, the batched
    products' summation order.  (The BGS and polar tiers against the JAX
    package: tests/test_torch_bgs_batched.py,
    tests/test_torch_polar_batched.py.)"""
    a = torch.from_numpy(_stack((128, 64), 24))
    Qb, Rb = pt.block_qr_batched(a, 16, pt.POLICY_FP32, panel_method="polar")
    for i in range(3):
        Q, R = pt.block_qr(a[i], 16, pt.POLICY_FP32, panel_method="polar")
        for x, y in ((Qb[i], Q), (Rb[i], R)):
            torch.testing.assert_close(
                x, y, rtol=0, atol=1e-6 * max(1.0, float(y.abs().max())))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("k", [None, 2])
def test_lstsq_batched_matches_jax(shape, k):
    m, n = SHAPES[shape]
    rng = np.random.default_rng(25)
    A = rng.random((3, m, n)).astype(np.float32)
    xt = rng.random((3, n) if k is None else (3, n, k)).astype(np.float32)
    b = (np.einsum("bmn,bn->bm", A, xt) if k is None
         else np.einsum("bmn,bnk->bmk", A, xt))
    before = dict(LAUNCHES)
    X = pt.lstsq_batched(torch.from_numpy(A), torch.from_numpy(b),
                         block_size=16)
    assert dict(LAUNCHES) == before  # the CPU runs panel_factor's loop
    X_ref = np.asarray(jls.lstsq_batched(A, b, block_size=16))
    assert X.shape == X_ref.shape == xt.shape
    assert _rel(X, X_ref) < RTOL


@pytest.mark.parametrize("k", [None, 3])
def test_back_substitution_stack_is_each_member(k):
    """One solve and one product a block of rows for the whole stack: each
    member as the 2-D back substitution gives it, to summation order."""
    rng = np.random.default_rng(26)
    R = np.triu(rng.random((3, 40, 40))).astype(np.float32) + 4 * np.eye(
        40, dtype=np.float32)
    b = rng.random((3, 40) if k is None else (3, 40, k)).astype(np.float32)
    x = tls._back_substitution(torch.from_numpy(R), torch.from_numpy(b), 16)
    assert x.shape == b.shape
    for i in range(3):
        xi = tls._back_substitution(torch.from_numpy(R[i]),
                                    torch.from_numpy(b[i]), 16)
        torch.testing.assert_close(x[i], xi, rtol=RTOL, atol=RTOL)


@pytest.fixture(scope="module")
def batch_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield pt.make_mesh((1,), ("batch",), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("pm", ["cholqr2", "householder", "cholqr1x2"])
def test_block_qr_batched_sharded_world1_matches_jax(batch_mesh, pm):
    case = {"kind": "batched", "a": (27, (3, 96, 64), True),
            "kw": {"block_size": 16, "panel_method": pm}}
    Q, R = C.run_port(case, batch_mesh)
    Qj, Rj = ref.reference(case, 1)
    assert Q.shape == Qj.shape and R.shape == Rj.shape
    assert _rel(Q, Qj) <= RTOL and _rel(R, Rj) <= RTOL


def test_tsqr_batched_sharded_2d_world1_matches_jax(batch_mesh):
    """One all-gather of the rank's R stack and one stacked reduction
    tree, CholeskyQR2 leaves (the default) and Householder leaves."""
    mesh = pt.make_mesh((1, 1), ("batch", "rows"), device_type="cpu")
    for leaf in ("cholqr2", "householder"):
        case = {"kind": "tsqr2d", "a": (28, (3, 256, 16), False),
                "kw": {"leaf_method": leaf}, "mesh": ((1, 1),
                                                      ("batch", "rows"))}
        Q, R = C.run_port(case, mesh)
        Qj, Rj = ref.reference(case, 1)
        assert _rel(Q, Qj) <= RTOL and _rel(R, Rj) <= RTOL


def _caqr_case():
    return np.random.default_rng(29).random((256, 48), dtype=np.float32)


def test_caqr_stacked_replays_match_jax():
    """apply_qt / apply_q / caqr with four row blocks (two tree levels) a
    panel against the JAX package's CAQR."""
    A = _caqr_case()
    X = np.random.default_rng(30).random((256, 5), dtype=np.float32)
    factors, R = tc.caqr_factor(torch.from_numpy(A), block_size=16,
                                row_blocks=4)
    fj, Rj = jc.caqr_factor(jnp.asarray(A), block_size=16, row_blocks=4)
    assert len(factors.panels[0].tree_v) == 2
    _close(R.numpy(), Rj)
    _close(tc.apply_qt(factors, torch.from_numpy(X)).numpy(),
           jc.apply_qt(fj, jnp.asarray(X)))
    _close(tc.apply_q(factors, torch.from_numpy(X)).numpy(),
           jc.apply_q(fj, jnp.asarray(X)))
    for mode in ("reduced", "complete"):
        Qt, Rt = tc.caqr(torch.from_numpy(A), 16, row_blocks=4, mode=mode)
        Qj, Rjm = jc.caqr(jnp.asarray(A), 16, row_blocks=4, mode=mode)
        _close(Qt.numpy(), Qj)
        _close(Rt.numpy(), Rjm)


def _replay_by_loop(X, factors, transpose):
    """The replay one leaf and one pair at a time (the loop the stacked
    application replaces), for reference."""
    X = X.clone()
    panels = factors.panels if transpose else factors.panels[::-1]
    for pf in panels:
        lam, r = pf.row_offset, pf.width
        L, h, _ = pf.leaf_v.shape
        blocks = tc._padded_blocks(X[lam:], L, h)

        def leaves():
            for i in range(L):
                V, T = pf.leaf_v[i], pf.leaf_t[i]
                blocks[i] = (pt.apply_block_reflector_left_t(blocks[i], V, T)
                             if transpose else tc._apply_q_left(blocks[i], V,
                                                                T))

        def tree():
            levels = range(len(pf.tree_v))
            for lev in (levels if transpose else reversed(levels)):
                s = 1 << lev
                for j in range(pf.tree_v[lev].shape[0]):
                    i0, i1 = 2 * s * j, 2 * s * j + s
                    V, T = pf.tree_v[lev][j], pf.tree_t[lev][j]
                    st = torch.cat([blocks[i0, :r], blocks[i1, :r]])
                    st = (pt.apply_block_reflector_left_t(st, V, T)
                          if transpose else tc._apply_q_left(st, V, T))
                    blocks[i0, :r], blocks[i1, :r] = st[:r], st[r:]

        if transpose:
            leaves()
            tree()
        else:
            tree()
            leaves()
        X[lam:] = blocks.reshape(L * h, -1)[:X.shape[0] - lam]
    return X


@pytest.mark.parametrize("transpose", [True, False])
def test_caqr_stacked_replay_equals_the_loop(transpose):
    """One stacked application over the leaves and one a tree level give
    what one application a leaf and a pair gives, to summation order."""
    A = torch.from_numpy(_caqr_case())
    X = torch.from_numpy(np.random.default_rng(31).random(
        (256, 7), dtype=np.float32))
    factors, _ = tc.caqr_factor(A, block_size=16, row_blocks=8)
    got = (tc.apply_qt if transpose else tc.apply_q)(factors, X)
    torch.testing.assert_close(got, _replay_by_loop(X, factors, transpose),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("passes,shifted", [(1, False), (2, False),
                                            (2, True)])
def test_cholesky_qr2_stack_is_each_member(passes, shifted):
    P = _stack((96, 16), 32)
    P[1] *= 1e3  # members of other scales keep their own shift
    Q, R = tcq.cholesky_qr2(torch.from_numpy(P), shifted=shifted,
                            passes=passes)
    for i in range(3):
        Qi, Ri = tcq.cholesky_qr2(torch.from_numpy(P[i]), shifted=shifted,
                                  passes=passes)
        _close(Q[i].numpy(), Qi.numpy())
        _close(R[i].numpy(), Ri.numpy())


def test_cholesky_qr2_stack_nan_is_its_member_only():
    P = _stack((96, 16), 33)
    P[2, :, 3] = 0.0  # a zero column: the member's Gram is not SPD
    Q, R = tcq.cholesky_qr2(torch.from_numpy(P), passes=1)
    assert torch.isfinite(Q[:2]).all() and torch.isfinite(R[:2]).all()
    assert torch.isnan(Q[2]).all() and torch.isnan(R[2]).all()


@pytest.mark.parametrize("iters", [4, 12])
def test_newton_inv_stack_is_each_member(iters):
    rng = np.random.default_rng(34)
    S = (np.eye(16) + 0.2 * rng.standard_normal((3, 16, 16))).astype(
        np.float32)
    X = tcq.newton_inv(torch.from_numpy(S), iters=iters)
    for i in range(3):
        _close(X[i].numpy(),
               tcq.newton_inv(torch.from_numpy(S[i]), iters=iters).numpy())


def test_newton_inv_check_falls_back_per_member():
    """Only the member whose Newton residual fails takes the LU inverse."""
    rng = np.random.default_rng(35)
    S = (np.eye(16) + 0.1 * rng.standard_normal((3, 16, 16))).astype(
        np.float32)
    S[1] = (np.eye(16) + 3.0 * rng.standard_normal((16, 16))).astype(
        np.float32)  # outside the disk: Newton diverges
    St = torch.from_numpy(S)
    X = tcq.newton_inv(St, iters=6, check=True)
    X0 = tcq.newton_inv(St, iters=6)
    assert torch.equal(X[0], X0[0]) and torch.equal(X[2], X0[2])
    _close(X[1].numpy(), tcq.lu_inv(St[1]).numpy())
    for i in range(3):
        _close(X[i].numpy(),
               tcq.newton_inv(St[i], iters=6, check=True).numpy())


@pytest.mark.parametrize("inv_method", ["lu", "newton"])
def test_yamamoto_reflector_stack_is_each_member(inv_method):
    P = torch.from_numpy(_stack((96, 16), 36))
    Q, R = tcq.cholesky_qr2(P)
    outs = tcq.yamamoto_reflector(Q, R, inv_method=inv_method, check=True)
    for i in range(3):
        each = tcq.yamamoto_reflector(Q[i], R[i], inv_method=inv_method,
                                      check=True)
        for x, y in zip(outs, each):
            _close(x[i].numpy(), y.numpy())


def test_tsqr_cholqr2_leaves_stacked():
    """CholeskyQR2 leaves and tree levels in one stacked call each: the
    JAX package's TSQR to summation order."""
    from mixedprecisionblockqr_tpu.parallel import tsqr as jts

    a = np.random.default_rng(37).random((512, 16), dtype=np.float32)
    for method in ("cholqr2", "cholqr2s"):
        Qt, Rt = tts.tsqr(torch.from_numpy(a), n_leaves=4, method=method)
        Qj, Rj = jts.tsqr(jnp.asarray(a), n_leaves=4, method=method)
        _close(Qt.numpy(), Qj)
        _close(Rt.numpy(), Rj)


def test_mm_bf16_stacks_on_the_cpu():
    """3-D bf16 operands: exact products of the bf16-rounded operands with
    fp32 accumulation, as each member's 2-D product."""
    rng = np.random.default_rng(38)
    a = torch.from_numpy(rng.standard_normal((3, 40, 24)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 24, 8)).astype(np.float32))
    out = tpol.mm_bf16(a, b)
    assert out.dtype == torch.float32 and out.shape == (3, 40, 8)
    for i in range(3):
        torch.testing.assert_close(out[i], tpol.mm_bf16(a[i], b[i]),
                                   rtol=RTOL, atol=RTOL)
