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
from mixedprecisionblockqr_tpu_torch.utils import bounds


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


# The H100's resident cluster counts as the card reports them
# (utils/bounds.py::h100_resident, from utils/panel_probe.py --batched's
# resident table); the layouts read the card's own counts on CUDA.
H100 = bounds.h100_resident


def _candidates(m, w, max_cluster):
    # batched_layout's candidates: panel_layout's cluster down to
    # fewest_layout's, rows in shared memory
    top = tpanel.panel_layout(m, w, max_cluster)
    low = tpanel.fewest_layout(m, w, max_cluster).cluster
    return [tpanel.PanelLayout(c, -(-m // c), True,
                               tpanel._smem_bytes(w, -(-m // c), True))
            for c in range(top.cluster, low - 1, -1)]


@pytest.mark.parametrize("B, m, w", [(1, 1563, 64), (64, 1563, 64),
                                     (64, 128, 64), (8, 512, 128),
                                     (64, 1024, 128), (32, 512, 128),
                                     (4, 8192, 128), (3, 40, 16),
                                     (200, 5000, 100), (17, 80, 80)])
@pytest.mark.parametrize("max_cluster", [16, 8])
def test_batched_layout_rule(B, m, w, max_cluster):
    # (c) every member's rows covered, at most max_cluster CTAs, within the
    # shared memory, never more CTAs than the single panel's layout nor
    # fewer than fewest_layout's; of those candidates the fewest waves by
    # the card's resident clusters, then the most CTAs a member.
    lay = tpanel.batched_layout(B, m, w, H100, max_cluster)
    one = tpanel.panel_layout(m, w, max_cluster)
    assert 1 <= lay.cluster <= min(max_cluster, one.cluster)
    assert lay.cluster * lay.rows >= m and lay.rows == -(-m // lay.cluster)
    assert lay.smem_bytes == tpanel._smem_bytes(w, lay.rows, lay.in_smem)
    assert lay.smem_bytes <= tpanel.SMEM_LIMIT
    if B == 1 or not one.in_smem:
        assert lay == one
        return
    assert lay.in_smem
    assert lay.cluster >= tpanel.fewest_layout(m, w, max_cluster).cluster
    cands = _candidates(m, w, max_cluster)
    assert lay in cands
    best = min(tpanel.waves(B, c, H100) for c in cands)
    assert tpanel.waves(B, lay, H100) == best
    assert all(tpanel.waves(B, c, H100) > best
               for c in cands if c.cluster > lay.cluster)


def test_batched_layout_of_the_chip_cells():
    # tsqr 100000 x 64's 64 leaves of 1563 rows: 2 CTAs of 782 rows each
    # (one wave) instead of panel_layout's 13; its tree levels (at most 32
    # nodes of 128 x 64) keep panel_layout's one CTA
    assert tpanel.batched_layout(64, 1563, 64, H100) == tpanel.PanelLayout(
        2, 782, True, tpanel._smem_bytes(64, 782, True))
    assert tpanel.batched_layout(32, 128, 64, H100) == tpanel.panel_layout(
        128, 64)


def test_h100_resident_table():
    # the counts the card reports: a cluster lies inside one GPC, so 7 of
    # 16, 13 or 11 CTAs are resident at once, and at least 8 of 9 CTAs
    for cluster, rows, n in ((16, 128, 7), (13, 158, 7), (11, 187, 7)):
        lay = tpanel.PanelLayout(cluster, rows, True,
                                 tpanel._smem_bytes(128, rows, True))
        assert H100(lay) == n, (cluster, H100(lay))
    nine = tpanel.PanelLayout(9, 228, True,
                              tpanel._smem_bytes(128, 228, True))
    assert H100(nine) >= 8


@pytest.mark.parametrize("B, m, w, want", [
    # the batched solve's first panel step: one wave, not panel_layout's
    # 16 x 128 in two
    (8, 2048, 128, None),
    # B = 1 is panel_layout
    (1, 2048, 128, (16, 128)),
    # fewest_layout (6 x 342) is the lower limit, however many waves
    (64, 2048, 128, None),
    # rows that fit shared memory nowhere keep the in-place route
    (8, 8192, 128, (16, 512)),
    (64, 1563, 64, (2, 782)),
])
def test_batched_layout_on_the_h100(B, m, w, want):
    lay = tpanel.batched_layout(B, m, w, H100)
    one = tpanel.panel_layout(m, w)
    fewest = tpanel.fewest_layout(m, w)
    if want is not None:
        assert (lay.cluster, lay.rows) == want
    if B == 1 or not one.in_smem:
        assert lay == one
    else:
        assert fewest.cluster <= lay.cluster <= one.cluster
    if (B, m) == (8, 2048):
        assert tpanel.waves(B, lay, H100) == 1
        assert tpanel.waves(B, one, H100) == 2
        assert lay.cluster < one.cluster
    if (B, m) == (64, 2048):
        assert lay.cluster >= fewest.cluster == 6


def test_batched_layout_needs_the_counts():
    # B > 1 asks the card; B = 1 and the in-place route do not
    with pytest.raises(ValueError, match="resident"):
        tpanel.batched_layout(8, 2048, 128)
    assert tpanel.batched_layout(1, 2048, 128) == tpanel.panel_layout(
        2048, 128)
    assert tpanel.batched_layout(8, 8192, 128) == tpanel.panel_layout(
        8192, 128)

    def refuse(lay):
        raise AssertionError("asked")
    assert tpanel.batched_layout(8, 8192, 128, refuse) == (
        tpanel.panel_layout(8192, 128))


@pytest.mark.parametrize("B, m, w", [(1, 2048, 256), (64, 1024, 256),
                                     (32, 512, 256), (4, 1024, 256),
                                     (3, 300, 200)])
def test_wide_batched_layout_rule(B, m, w):
    lay = tpanel.wide_batched_layout(B, m, w, H100)
    one = tpanel.wide_layout(m, w)
    assert [st.cols for st in lay.steps] == [st.cols for st in one.steps]
    for st in lay.steps:
        c, e = st.cols
        b, mk, n2 = e - c, m - c, w - e
        assert st.panel == tpanel.batched_layout(B, mk, b, H100)
        # each product is one launch for the B members, laid out by their
        # output tiles together
        if n2:
            assert st.update == (*tns.tn_split(b, n2, mk, B),
                                 *tns.tn_split(b, n2, b, B),
                                 *tpanel._nt_tiles(mk, n2, B))
        if c:
            assert st.merge == (*tns.tn_split(c, b, mk, B),
                                *tpanel._nt_tiles(c, b, B),
                                *tpanel._nt_tiles(c, b, B))
    assert lay.products() == one.products() == 6 * (len(lay.steps) - 1)
    if B == 1:
        assert lay == one


# wide_layout's plans at B = 1, integer for integer: the single-panel wide
# route (householder at block 256, cholqr1 at 256, lstsq(method='tsqr')).
WIDE_PLANS = {
    (2048, 256): [(16, 128, 1, 88320, 8, 256, 2, 64, 16, 128, 0, 0, 0, 0, 0,
                   0),
                  (15, 128, 1, 88320, 0, 0, 0, 0, 0, 0, 8, 256, 16, 128, 16,
                   128)],
    (4096, 512): [(16, 256, 1, 154880, 4, 1024, 2, 64, 64, 128, 0, 0, 0, 0,
                   0, 0),
                  (16, 248, 1, 150720, 4, 1024, 2, 64, 16, 128, 8, 512, 16,
                   128, 16, 128),
                  (16, 240, 1, 146560, 8, 512, 2, 64, 16, 128, 4, 960, 16,
                   128, 16, 128),
                  (16, 232, 1, 142400, 0, 0, 0, 0, 0, 0, 4, 960, 16, 128,
                   16, 128)],
    (4096, 2048): [
        (16, 256, 1, 154880, 1, 4096, 1, 128,
         64, 128, 0, 0, 0, 0, 0, 0),
        (16, 248, 1, 150720, 1, 3968, 1, 128,
         64, 128, 8, 512, 16, 128, 16, 128),
        (16, 240, 1, 146560, 1, 3840, 1, 128,
         64, 128, 4, 960, 16, 128, 16, 128),
        (16, 232, 1, 142400, 1, 3712, 1, 128,
         64, 128, 4, 960, 16, 128, 16, 128),
        (16, 224, 1, 138240, 1, 3584, 1, 128,
         64, 128, 2, 1792, 16, 128, 16, 128),
        (16, 216, 1, 134080, 1, 3456, 1, 128,
         64, 128, 2, 1728, 16, 128, 16, 128),
        (16, 208, 1, 129920, 1, 3328, 1, 128,
         64, 128, 2, 1664, 16, 128, 16, 128),
        (16, 200, 1, 125760, 1, 3200, 1, 128,
         64, 128, 2, 1600, 16, 128, 16, 128),
        (16, 192, 1, 121600, 2, 1536, 2, 64,
         64, 128, 1, 3072, 16, 128, 16, 128),
        (16, 184, 1, 117440, 2, 1472, 2, 64,
         64, 128, 1, 2944, 16, 128, 16, 128),
        (16, 176, 1, 113280, 2, 1408, 2, 64,
         64, 128, 1, 2816, 16, 128, 16, 128),
        (16, 168, 1, 109120, 2, 1344, 2, 64,
         64, 128, 1, 2688, 16, 128, 16, 128),
        (16, 160, 1, 104960, 4, 640, 2, 64,
         16, 128, 1, 2560, 16, 128, 16, 128),
        (16, 152, 1, 100800, 4, 640, 2, 64,
         16, 128, 1, 2432, 16, 128, 16, 128),
        (16, 144, 1, 96640, 8, 320, 2, 64,
         16, 128, 1, 2304, 16, 128, 16, 128),
        (16, 136, 1, 92480, 0, 0, 0, 0,
         0, 0, 1, 2176, 16, 128, 16, 128),
    ],
}


@pytest.mark.parametrize("m, w", sorted(WIDE_PLANS))
def test_wide_layout_at_one_panel_is_unchanged(m, w):
    lay = tpanel.wide_layout(m, w)
    assert [st.args() for st in lay.steps] == WIDE_PLANS[m, w]
    assert tpanel.wide_batched_layout(1, m, w, H100) == lay


@pytest.mark.parametrize("B", [1, 4, 64])
def test_wide_products_count_launches_not_members(B):
    # 3 launches for the trailing update and 3 for T's merge a sub-panel
    # pair, whatever B is: tsqr 65536 x 256's 7 calls make 42
    for m, w in ((1024, 256), (512, 256), (300, 200), (2048, 512)):
        lay = tpanel.wide_batched_layout(B, m, w, H100)
        assert lay.products() == 6 * (len(lay.steps) - 1)


def test_tn_split_counts_the_members_tiles():
    # the split doubles while the members' tiles times the split fall
    # short of TARGET_CTAS: one member of 128 x 128 over 1024 rows splits
    # 8 ways, 64 members' 1024 tiles need no split
    assert tns.tn_split(128, 128, 1024) == (8, 128)
    assert tns.tn_split(128, 128, 1024, 1) == tns.tn_split(128, 128, 1024)
    assert tns.tn_split(128, 128, 1024, 64) == (1, 1024)
    assert tns.tn_split(128, 128, 1024, 4) == (2, 512)
    assert tpanel._nt_tiles(128, 128) == (16, 128)
    assert tpanel._nt_tiles(128, 128, 64) == (64, 128)
    with pytest.raises(ValueError):
        tns.tn_split(128, 128, 1024, 0)


def test_batched_bound_counts_the_products_over_the_batch():
    # the wide call's floor: one member's sub-panel loops on their
    # clusters plus the B members' products at the whole card's peak
    B, m, w = 64, 1024, 256
    row = bounds.panel_factor_batched_bound(B, m, w, H100)
    loops = bounds.wide_loop_ops(m, w, None, B, H100)
    rest = bounds.householder_panel_ops(m, w) - sum(o for o, _ in loops)
    assert row["products_floor_ms"] == pytest.approx(
        B * rest / bounds.PEAK_F32 * 1e3, rel=1e-12)
    t_loops = sum(o * bounds.SMS / cl for o, cl in loops) / bounds.PEAK_F32
    assert row["member_floor_ms"] == pytest.approx(
        max(t_loops * 1e3 + row["products_floor_ms"],
            B * (3 * m * w + w * w) * 4 / bounds.HBM_BYTES_PER_S * 1e3),
        rel=1e-12)
    one = bounds.panel_factor_batched_bound(1, m, w)
    assert row["member_floor_ms"] > one["member_floor_ms"]
    narrow = bounds.panel_factor_batched_bound(8, 2048, 128, H100)
    assert narrow["cluster_sms"] == tpanel.batched_layout(
        8, 2048, 128, H100).cluster
    assert "products_floor_ms" not in narrow


@pytest.mark.parametrize("call", [
    lambda: tpanel.batched_layout(0, 64, 8, H100),
    lambda: tpanel.batched_layout(2, 8, 64, H100),
    lambda: tpanel.batched_layout(2, 64, 129, H100),
    lambda: tpanel.wide_batched_layout(0, 300, 200, H100),
    lambda: tpanel.wide_batched_layout(2, 100, 200, H100),
    lambda: tpanel.wide_batched_layout(2, 300, 200),
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
    lay = tpanel.batched_layout(5, 90, 30, H100)
    V, T, R = tpanel._launch(Fake(), torch.zeros((5, 90, 30)), lay)
    a = seen["mpbqr_panel_factor_batched"]
    assert a[5:12] == (5, 90, 30, lay.cluster, lay.rows, int(lay.in_smem),
                       lay.smem_bytes)
    assert V.shape == R.shape == (5, 90, 30) and T.shape == (5, 30, 30)
    wl = tpanel.wide_batched_layout(4, 300, 200, H100)
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
