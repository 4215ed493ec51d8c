"""K6 over a batch of panels (``panel_factor_fused_batched``) and the
callers that factor a TSQR / CAQR level in one call, against the JAX
package on the CPU.  The JAX package ``vmap``s its Pallas kernel (run here
in interpret mode); on CPU tensors the port's batched wrapper runs its
plain version member by member, and the callers' batched levels run
``panel_factor``'s loop.  The CUDA entries are held against the plain
version, and each member bit for bit against a single launch, on the card
by chip_smoke.py."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops.pallas import panel as jpanel
from mixedprecisionblockqr_tpu.parallel import caqr as jc
from mixedprecisionblockqr_tpu.parallel import tsqr as jt
from mixedprecisionblockqr_tpu_torch.ops import blockqr as tbq
from mixedprecisionblockqr_tpu_torch.ops import householder as thh
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.ops.kernels import panel as tpanel
from mixedprecisionblockqr_tpu_torch.ops.policy import POLICY_FP32, POLICY_FP64
from mixedprecisionblockqr_tpu_torch.parallel import caqr as tc
from mixedprecisionblockqr_tpu_torch.parallel import tsqr as tt


def _close(t, j, atol):
    # atol of the entries' scale, max(1, max|x|)
    j = np.asarray(j, np.float64)
    scale = max(1.0, float(np.abs(j).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * scale)


def _stack(B, m, w, seed):
    return (np.random.default_rng(seed).random((B, m, w), dtype=np.float32)
            - 0.5)


BATCHES = [(3, 40, 16), (2, 70, 40)]


@pytest.mark.parametrize("B, m, w", BATCHES)
def test_batched_plain_matches_jax_vmap(B, m, w):
    # (a) the batched plain version against jax.vmap of the Pallas kernel,
    # to test_torch_panel_factor.py's tolerances: 1e-5 of the entries'
    # scale for V and T, 1e-4 for R.
    P = _stack(B, m, w, seed=B + m)
    before = (dict(tns.LAUNCHES), dict(tns.BATCH_MEMBERS))
    Vt, Tt, Rt = tpanel.panel_factor_fused_batched(torch.from_numpy(P))
    assert (dict(tns.LAUNCHES), dict(tns.BATCH_MEMBERS)) == before
    Vj, Tj, Rj = jax.vmap(
        lambda p: jpanel.panel_factor_fused(p, interpret=True))(
            jnp.asarray(P))
    assert Vt.shape == Rt.shape == (B, m, w) and Tt.shape == (B, w, w)
    _close(Vt.numpy(), Vj, 1e-5)
    _close(Tt.numpy(), Tj, 1e-5)
    _close(Rt.numpy(), Rj, 1e-4)


@pytest.mark.parametrize("B, m, w", BATCHES)
def test_batched_plain_is_the_single_plain_per_member(B, m, w):
    # (b) member by member, bit for bit the single panel's plain version
    P = torch.from_numpy(_stack(B, m, w, seed=7))
    V, T, R = tpanel.panel_factor_fused_batched_plain(P)
    for i in range(B):
        for got, want in zip((V[i], T[i], R[i]),
                             tpanel.panel_factor_fused_plain(P[i])):
            assert torch.equal(got, want)


@pytest.mark.parametrize("B, m, w", [(1, 1563, 64), (64, 1563, 64),
                                     (64, 128, 64), (8, 512, 128),
                                     (64, 1024, 128), (32, 512, 128),
                                     (4, 8192, 128), (3, 40, 16),
                                     (200, 5000, 100), (17, 80, 80)])
@pytest.mark.parametrize("max_cluster", [16, 8])
def test_batched_layout_rule(B, m, w, max_cluster):
    # (c) every member's rows covered, at most max_cluster CTAs, within the
    # shared memory, never more CTAs than the single panel's layout, and
    # the batch fills the card's SMs at one CTA each where panel_layout's
    # would not.
    lay = tpanel.batched_layout(B, m, w, max_cluster)
    one = tpanel.panel_layout(m, w, max_cluster)
    assert 1 <= lay.cluster <= min(max_cluster, one.cluster)
    assert lay.cluster * lay.rows >= m and lay.rows == -(-m // lay.cluster)
    assert lay.smem_bytes == tpanel._smem_bytes(w, lay.rows, lay.in_smem)
    assert lay.smem_bytes <= tpanel.SMEM_LIMIT
    if B * one.cluster <= tpanel.CARD_SMS or not one.in_smem:
        assert lay == one
    else:
        assert lay.in_smem
        assert lay.cluster >= tpanel.fewest_layout(m, w, max_cluster).cluster
    if B == 1:
        assert lay == one


def test_batched_layout_of_the_chip_cells():
    # tsqr 100000 x 64's 64 leaves of 1563 rows: 2 CTAs of 782 rows each
    # (128 CTAs, one wave) instead of panel_layout's 13; its tree levels
    # (at most 32 nodes of 128 x 64) keep panel_layout's one CTA
    assert tpanel.batched_layout(64, 1563, 64) == tpanel.PanelLayout(
        2, 782, True, tpanel._smem_bytes(64, 782, True))
    assert tpanel.batched_layout(32, 128, 64) == tpanel.panel_layout(128, 64)


@pytest.mark.parametrize("B, m, w", [(1, 2048, 256), (64, 1024, 256),
                                     (32, 512, 256), (4, 1024, 256),
                                     (3, 300, 200)])
def test_wide_batched_layout_rule(B, m, w):
    lay = tpanel.wide_batched_layout(B, m, w)
    one = tpanel.wide_layout(m, w)
    assert [st.cols for st in lay.steps] == [st.cols for st in one.steps]
    for st, st1 in zip(lay.steps, one.steps):
        c, e = st.cols
        assert st.panel == tpanel.batched_layout(B, m - c, e - c)
        # the products are laid out per member, as for one panel
        assert (st.update, st.merge) == (st1.update, st1.merge)
    if B == 1:
        assert lay == one


@pytest.mark.parametrize("call", [
    lambda: tpanel.batched_layout(0, 64, 8),
    lambda: tpanel.batched_layout(2, 8, 64),
    lambda: tpanel.batched_layout(2, 64, 129),
    lambda: tpanel.wide_batched_layout(0, 300, 200),
    lambda: tpanel.wide_batched_layout(2, 100, 200),
])
def test_batched_layouts_refuse(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_householder_panels_stack_panel_factor(dtype):
    # (d) on the CPU (and for float64 anywhere) the batched caller runs
    # panel_factor member by member: bit for bit the stacked singles
    P = torch.from_numpy(_stack(3, 48, 12, seed=5)).to(dtype)
    policy = POLICY_FP64 if dtype == torch.float64 else POLICY_FP32
    before = dict(tns.LAUNCHES)
    V, T, R = tbq._householder_panels(P, policy, fused=False)
    fused = tt.householder_panels(P, policy)
    assert dict(tns.LAUNCHES) == before
    for i in range(3):
        want = thh.panel_factor(P[i])
        for got in (V, T, R), fused:
            assert all(torch.equal(g[i], x) for g, x in zip(got, want))
    assert V.dtype == dtype


def test_batched_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpanel.panel_factor_fused_batched(torch.zeros((2, 8, 4),
                                                      device="meta"))


def test_batched_entries_take_the_batch(monkeypatch):
    # The C entries: the batched K6 takes the single entry's arguments with
    # B before m; the batched wide route its with B before m, its scratch
    # query (B, m, w, sub).  A 3-D stack takes them, a 2-D panel the single
    # entries.
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build._declare(Lib())
    one = lib.mpbqr_panel_factor.argtypes
    assert lib.mpbqr_panel_factor_batched.argtypes == (
        one[:5] + [ctypes.c_int] + one[5:])
    wide = lib.mpbqr_panel_factor_wide.argtypes
    assert lib.mpbqr_panel_factor_wide_batched.argtypes == (
        wide[:5] + [ctypes.c_int] + wide[5:])
    assert lib.mpbqr_panel_factor_wide_batched_scratch_floats.argtypes == [
        ctypes.c_int] * 4
    assert lib.mpbqr_panel_factor_resident.restype is ctypes.c_int

    seen = {}

    class Fake:
        def __getattr__(self, name):
            def fn(*a):
                seen[name] = a
                return 64 if name.endswith("floats") else 0
            return fn

    monkeypatch.setattr(tpanel, "_stream", lambda t: ctypes.c_void_p(0))
    lay = tpanel.batched_layout(5, 90, 30)
    V, T, R = tpanel._launch(Fake(), torch.zeros((5, 90, 30)), lay)
    a = seen["mpbqr_panel_factor_batched"]
    assert a[5:12] == (5, 90, 30, lay.cluster, lay.rows, int(lay.in_smem),
                       lay.smem_bytes)
    assert V.shape == R.shape == (5, 90, 30) and T.shape == (5, 30, 30)
    wl = tpanel.wide_batched_layout(4, 300, 200)
    V, T, R = tpanel._launch_wide(Fake(), torch.zeros((4, 300, 200)), wl)
    assert seen["mpbqr_panel_factor_wide_batched_scratch_floats"] == (
        4, 300, 200, 128)
    a = seen["mpbqr_panel_factor_wide_batched"]
    assert a[5:9] == (4, 300, 200, 128) and a[10] == len(wl.steps) == 2
    assert list(a[9]) == [x for st in wl.steps for x in st.args()]
    assert V.shape == R.shape == (4, 300, 200) and T.shape == (4, 200, 200)
    tpanel._launch(Fake(), torch.zeros((90, 30)), tpanel.panel_layout(90, 30))
    assert seen["mpbqr_panel_factor"][5:7] == (90, 30)


# (e) the batched callers against the JAX package, with the tolerances of
# test_torch_tsqr.py / test_torch_caqr.py: 1e-5 of the entries' scale.
ATOL = 1e-5


@pytest.mark.parametrize("shape, L", [((3, 200, 12), 4), ((2, 96, 8), None)])
def test_tsqr_batched_levels_match_jax(shape, L):
    A = np.random.default_rng(11).random(shape).astype(np.float32)
    Q, R = tt.tsqr_batched(torch.from_numpy(A), n_leaves=L)
    Qj, Rj = jt.tsqr_batched(jnp.asarray(A), n_leaves=L)
    assert Q.shape == shape and R.shape == (shape[0],) + (shape[2],) * 2
    _close(Q.numpy(), Qj, ATOL)
    _close(R.numpy(), Rj, ATOL)


def test_reduction_tree_of_four_matches_jax():
    rng = np.random.default_rng(12)
    n = 6
    Rs = np.stack([np.triu(rng.random((n, n))) + np.eye(n)
                   for _ in range(4)]).astype(np.float32)
    F, R = tt.reduction_tree(torch.from_numpy(Rs))
    Fj, Rj = jt.reduction_tree(jnp.asarray(Rs))
    assert F.shape == (4, n, n) and R.shape == (n, n)
    _close(F.numpy(), Fj, ATOL)
    _close(R.numpy(), Rj, ATOL)


def test_caqr_factor_and_apply_qt_match_jax():
    # 4 row blocks a panel: leaves and two tree levels, each one batched
    # call; the stored factors keep their shapes
    A = np.random.default_rng(13).random((160, 24)).astype(np.float32)
    X = np.random.default_rng(14).random((160, 3)).astype(np.float32)
    factors, R = tc.caqr_factor(torch.from_numpy(A), block_size=8,
                                row_blocks=4)
    fj, Rj = jc.caqr_factor(jnp.asarray(A), block_size=8, row_blocks=4)
    _close(R.numpy(), Rj, ATOL)
    pf = factors.panels[0]
    assert pf.leaf_v.shape == (4, 40, 8) and pf.leaf_t.shape == (4, 8, 8)
    assert [v.shape for v in pf.tree_v] == [(2, 16, 8), (1, 16, 8)]
    assert [t.shape for t in pf.tree_t] == [(2, 8, 8), (1, 8, 8)]
    for p, q in zip(factors.panels, fj.panels):
        _close(p.leaf_v.numpy(), q.leaf_v, ATOL)
        _close(p.leaf_t.numpy(), q.leaf_t, ATOL)
        for a, b in zip(p.tree_v + p.tree_t, q.tree_v + q.tree_t):
            _close(a.numpy(), b, ATOL)
    _close(tc.apply_qt(factors, torch.from_numpy(X)).numpy(),
           jc.apply_qt(fj, jnp.asarray(X)), ATOL)
