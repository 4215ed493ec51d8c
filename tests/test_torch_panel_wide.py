"""K6's wide route (panels wider than 128 columns) of the port against the
JAX package's Pallas kernel, run in interpret mode on the CPU.

The route itself runs only on the card (``csrc/panel_factor.cu::
mpbqr_panel_factor_wide``, compared there with ``panel_factor_fused_plain``
by chip_smoke.py phase 24).  Here its schedule's plain mirror
``panel_factor_wide_plain`` holds the blocked algebra (sub-panels, trailing
update, T's merge) against the JAX kernel at small sub-panel widths, and
the shape rules, the routing, the C entry's arguments and the bound are
checked on shapes alone."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops.pallas import panel as jpanel
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.ops.kernels import panel as tpanel


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _panel(m, w, seed, zero_col):
    P = np.random.default_rng(seed).random((m, w), dtype=np.float32) - 0.5
    P[:, zero_col] = 0.0
    return P


# (m, w, sub, zero column): a ragged last sub-panel at 130 x 72, a square
# panel at 200 x 200.  The CPU measured 2.2e-6 at worst (T at 200 x 200).
CASES = [(160, 96, 32, 40), (130, 72, 32, 65), (200, 200, 64, 100)]


@pytest.mark.parametrize("m, w, sub, zero_col", CASES)
def test_wide_plain_matches_jax(m, w, sub, zero_col):
    # V, T and R's upper triangle within 1e-5 relative Frobenius: the same
    # reflectors, blocked, in fp32 summation order only.
    P = _panel(m, w, 19, zero_col)
    V, T, R = tpanel.panel_factor_wide_plain(torch.from_numpy(P), sub=sub)
    Vj, Tj, Rj = jpanel.panel_factor_fused(jnp.asarray(P), interpret=True)
    assert _rel(V.numpy(), Vj) < 1e-5
    assert _rel(T.numpy(), Tj) < 1e-5
    assert _rel(np.triu(R.numpy()), np.triu(np.asarray(Rj))) < 1e-5
    # the zero column: beta = 0, a zero reflector, zero row and column in T
    assert float(T[zero_col, zero_col]) == 0.0
    assert not V[:, zero_col].any()
    assert not T[zero_col].any() and not T[:, zero_col].any()
    # exact zeros below R's diagonal, as the CUDA route writes them
    assert not torch.tril(R, -1).any()


def test_wide_plain_nan_reaches_r():
    # A NaN in the second sub-panel: the canary's sum(Rp * 0) must see it,
    # in both packages; the sub-panel before it stays as the JAX kernel's.
    P = _panel(160, 96, 20, 40)
    P[100, 50] = np.nan
    V, T, R = tpanel.panel_factor_wide_plain(torch.from_numpy(P), sub=32)
    Vj, Tj, Rj = jpanel.panel_factor_fused(jnp.asarray(P), interpret=True)
    assert np.isnan(np.triu(R.numpy())).any()
    assert np.isnan(np.triu(np.asarray(Rj))).any()
    assert np.isfinite(R[:32, :32].numpy()).all()
    assert _rel(np.triu(R[:32, :32].numpy()),
                np.triu(np.asarray(Rj)[:32, :32])) < 1e-5


def test_wide_plain_at_one_sub_panel_is_the_plain_kernel():
    # sub >= w: one sub-panel, no update, no merge.
    P = torch.from_numpy(_panel(96, 48, 21, 7))
    V, T, R = tpanel.panel_factor_wide_plain(P, sub=64)
    Vp, Tp, Rp = tpanel.panel_factor_fused_plain(P)
    assert torch.equal(V, Vp) and torch.equal(T, Tp)
    assert torch.equal(R, torch.triu(Rp))


WIDE_SHAPES = [(2048, 256), (2000, 200), (4096, 2048), (8192, 256),
               (1024, 256)]


@pytest.mark.parametrize("m, w", WIDE_SHAPES)
def test_wide_layout(m, w):
    lay = tpanel.wide_layout(m, w)
    assert lay.sub == tpanel.WIDE_SUB == 128
    # the sub-panels cover w in order, each WIDE_SUB wide but the last
    cols = [step.cols for step in lay.steps]
    assert cols[0][0] == 0 and cols[-1][1] == w
    assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    assert all(e - c == 128 for c, e in cols[:-1])
    assert cols[-1][1] > cols[-1][0]
    for (c, e), step in zip(cols, lay.steps):
        # each sub-panel's K6 layout is panel_layout's of its shape and fits
        assert step.panel == tpanel.panel_layout(m - c, e - c)
        assert step.panel.smem_bytes <= tpanel.SMEM_LIMIT
        assert step.panel.cluster * step.panel.rows >= m - c
        # products: the trailing update unless e == w, the merge unless
        # c == 0
        assert bool(step.update[0]) == (e < w)
        assert bool(step.merge[0]) == (c > 0)
        if e < w:
            assert step.update[:2] == tns.tn_split(e - c, w - e, m - c)
            assert step.update[2:4] == tns.tn_split(e - c, w - e, e - c)
        if c:
            assert step.merge[:2] == tns.tn_split(c, e - c, m - c)
        for split, chunk in (step.update[:2], step.update[2:4],
                             step.merge[:2]):
            assert split == 0 or 1 <= split <= tns.TN_MAX_SPLIT
        for bm, bn in (step.update[4:], step.merge[2:4], step.merge[4:]):
            assert (bm, bn) == (0, 0) or bn in (32, 64, 128)
        assert len(step.args()) == 16
    n = len(lay.steps)
    assert lay.products() == 6 * (n - 1)
    if m >= 8192:
        # sub-panels taller than 16 CTAs of 405 rows take the in-place route
        assert not lay.steps[0].panel.in_smem


def test_wide_layout_rejects_what_the_route_does_not_take():
    for m, w, sub in ((200, 256, 128), (2048, 256, 0), (2048, 256, 129)):
        with pytest.raises(ValueError, match="wide_layout"):
            tpanel.wide_layout(m, w, tpanel.MAX_CLUSTER, sub)


@pytest.mark.parametrize("device_type, dtype, fused", [
    ("cuda", torch.float32, True),
    ("cuda", torch.float64, False),
    ("cpu", torch.float32, False),
])
def test_householder_routes_every_cuda_fp32_width_to_k6(
        device_type, dtype, fused):
    # _householder_fused takes no width: every fp32 panel on the card runs
    # K6, one launch up to 128 columns and the wide route beyond.
    from mixedprecisionblockqr_tpu_torch.ops import blockqr as tbq
    assert tbq._householder_fused(device_type, dtype) is fused


def test_wide_cpu_never_counts():
    # A CPU tensor wider than 128 runs the plain version of the whole
    # panel and counts nothing.
    tns.reset_launches()
    P = torch.from_numpy(_panel(160, 136, 22, 3))
    V, T, R = tpanel.panel_factor_fused(P)
    assert V.shape == (160, 136) and T.shape == (136, 136)
    assert tns.LAUNCHES["panel_factor_fused"] == 0
    assert tns.WIDE_LAUNCHES == {"calls": 0, "products": 0}


def test_wide_entry_takes_the_plan(monkeypatch):
    # The C entry takes P, V, T, R, the scratch, m, w, sub, the plan (16
    # integers a sub-panel, host memory), the number of sub-panels and the
    # stream; the scratch query takes m, w, sub.
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build._declare(Lib())
    args = lib.mpbqr_panel_factor_wide.argtypes
    assert args.count(ctypes.c_void_p) == 7
    assert args.count(ctypes.c_int) == 4 and len(args) == 11
    assert lib.mpbqr_panel_factor_wide_scratch_floats.argtypes == [
        ctypes.c_int] * 3
    assert lib.mpbqr_panel_factor_wide_scratch_floats.restype is \
        ctypes.c_longlong

    seen = {}

    class Fake:
        def mpbqr_panel_factor_wide_scratch_floats(self, m, w, sub):
            seen["scratch"] = (m, w, sub)
            return 64

        def mpbqr_panel_factor_wide(self, *a):
            seen["args"] = a
            return 0

    monkeypatch.setattr(tpanel, "_stream", lambda t: ctypes.c_void_p(0))
    P = torch.zeros((300, 200))
    lay = tpanel.wide_layout(300, 200)
    V, T, R = tpanel._launch_wide(Fake(), P, lay)
    a = seen["args"]
    assert seen["scratch"] == (300, 200, 128)
    assert a[5:8] == (300, 200, 128) and a[9] == len(lay.steps) == 2
    assert list(a[8]) == [x for step in lay.steps for x in step.args()]
    assert V.shape == R.shape == (300, 200) and T.shape == (200, 200)


@pytest.mark.parametrize("m, w", [(2048, 256), (4096, 2048), (512, 256),
                                  (256, 256)])
def test_panel_factor_bound_takes_the_wide_route(m, w):
    # The whole card's bound counts what the function needs, the column
    # loop's operations on the whole panel, once; the cluster floor charges
    # each sub-panel's loop at its own cluster's share of the card and the
    # rest (the products across sub-panels) at the whole card.
    from mixedprecisionblockqr_tpu_torch.utils import bounds

    lay = tpanel.wide_layout(m, w)
    row = bounds.panel_factor_bound(m, w)
    ops = bounds.householder_panel_ops(m, w)
    nbytes = (3 * m * w + w * w) * 4
    assert row["bound_ms"] == pytest.approx(
        max(ops / bounds.PEAK_F32, nbytes / bounds.HBM_BYTES_PER_S) * 1e3,
        rel=1e-12)
    loops = bounds.wide_loop_ops(m, w)
    assert [cl for _, cl in loops] == [s.panel.cluster for s in lay.steps]
    assert [o for o, _ in loops] == [
        bounds.householder_panel_ops(m - c, e - c)
        for c, e in (s.cols for s in lay.steps)]
    rest = ops - sum(o for o, _ in loops)
    assert rest > 0
    t = (sum(o * bounds.SMS / cl for o, cl in loops) + rest) / bounds.PEAK_F32
    assert row["cluster_bound_ms"] == pytest.approx(
        max(t, nbytes / bounds.HBM_BYTES_PER_S) * 1e3, rel=1e-12)
    assert row["cluster_sms"] == max(s.panel.cluster for s in lay.steps)
    assert row["bound_ms"] < row["cluster_bound_ms"]
    # a card that places 8 CTAs a cluster: the sub-panels' layouts on it
    small = bounds.panel_factor_bound(m, w, 8)
    assert small["cluster_sms"] <= 8
    assert small["cluster_bound_ms"] >= row["cluster_bound_ms"]
