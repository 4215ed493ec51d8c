"""K4's layout rule and the robust R-block combine of the port on the CPU.

``ninv_layout`` is the rule that csrc/ninv_chain.cu checks its launch
against; ``tri_combine`` closes K2's and K3's robust panels.  On CPU tensors
both wrappers run their plain versions, counted as no launch; the CUDA
kernels are held against those plain versions on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.ops.kernels.chol import SMEM_LIMIT
from mixedprecisionblockqr_tpu_torch.utils import bounds


@pytest.mark.parametrize("r", [32, 64, 128])
def test_ninv_layout_is_one_cluster_of_r_over_16_ctas(r):
    lay = tns.ninv_layout(r)
    assert lay.ctas == r // 16 <= 8
    # S and two buffers of X whole and the own columns of X and E, rows
    # padded to r + 4 floats, the product's partial sums and the reductions
    assert lay.smem_bytes == 4 * ((3 * r + 32) * (r + 4) + 16 * r + 64)
    assert lay.smem_bytes <= SMEM_LIMIT == 227 * 1024
    assert (lay.inst, lay.route, lay.scratch_floats) == (r, "smem", 0)


@pytest.mark.parametrize("r,inst,route,ctas", [(16, 32, "smem", 2),
                                               (96, 128, "smem", 8),
                                               (256, 0, "l2", 16)])
def test_ninv_layout_refuses_other_widths(r, inst, route, ctas):
    # Every width runs: 16 and 96 on the smallest instantiation that holds
    # them (zeros beyond r), 256 on the L2 route (S^T, X and X^T twice and
    # E in global scratch, 16 CTAs); only widths outside 1 .. MAX_WIDTH are
    # refused.
    lay = tns.ninv_layout(r)
    assert (lay.inst, lay.route, lay.ctas) == (inst, route, ctas)
    assert lay.smem_bytes <= SMEM_LIMIT
    assert lay.scratch_floats == (6 * r * r if route == "l2" else 0)
    with pytest.raises(ValueError, match="ninv_chain"):
        tns.ninv_layout(tns.MAX_WIDTH + r)


def _ts(r, seed):
    rng = np.random.default_rng(seed)
    return [(np.eye(r) + 0.3 * rng.standard_normal((r, r))).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("r", [32, 128])
def test_tri_combine_plain_matches_float64(r):
    T1, T2, T3 = _ts(r, r)
    out = tns.tri_combine_plain(*map(torch.from_numpy, (T1, T2, T3)))
    ref = np.triu(T3.astype(np.float64)
                  @ (T2.astype(np.float64) @ T1.astype(np.float64)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    assert np.all(np.tril(out.numpy(), -1) == 0.0)


def test_panel_qr_fused_plain_robust_closes_with_tri_combine_plain(
        monkeypatch):
    P = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (256, 32)).astype(np.float32))
    seen = []
    plain = tns.tri_combine_plain

    def spy(T1, T2, T3):
        seen.append((T1, T2, T3))
        return plain(T1, T2, T3)

    monkeypatch.setattr(tns, "tri_combine_plain", spy)
    _, t, _ = tns.panel_qr_fused_plain(P, robust=True)
    assert len(seen) == 1
    assert torch.equal(t, plain(*seen[0]))
    # the same three products that robust_products reports
    for a, b in zip(seen[0], tns.robust_products(P)):
        assert torch.equal(a, b)
    tns.panel_qr_fused_plain(P, iters=6)
    assert len(seen) == 1


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    tns.reset_launches()
    T1, T2, T3 = map(torch.from_numpy, _ts(64, 1))
    assert torch.equal(tns.tri_combine(T1, T2, T3),
                       tns.tri_combine_plain(T1, T2, T3))
    S = torch.eye(32) * 1.5
    X, res = tns.ninv_chain(S, iters=4)
    Xp, resp = tns.ninv_chain_plain(S, iters=4)
    assert torch.equal(X, Xp) and torch.equal(res, resp)
    assert tns.PIECE_LAUNCHES == {"tri_combine": 0}
    assert tns.LAUNCHES["ninv_chain"] == 0


def test_ninv_chain_entry_takes_the_layout_and_no_scratch():
    # The C entry takes S, X, resid, the scratch, r, iters, the layout's
    # five numbers and the stream.  Up to 128 S and X live in shared memory
    # and the layout asks for no global scratch; only the L2 route (above
    # 128) keeps X and E in it.
    import ctypes

    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build._declare(Lib())
    args = lib.mpbqr_ninv_chain.argtypes
    assert args.count(ctypes.c_void_p) == 5  # S, X, resid, scratch, stream
    assert len(args) == 5 + 2 + len(tns.ninv_layout(128))
    assert "mpbqr_ninv_chain_scratch_floats" not in vars(lib)
    assert tns.ninv_layout(128).scratch_floats == 0
    # T1..T3, out, scratch, r, ldo, the layout's five numbers, stream
    assert len(lib.mpbqr_tri_combine.argtypes) == 13


@pytest.mark.parametrize("iters", [5, 12])
def test_ninv_and_combine_bounds_count_general_products(iters):
    r = 128
    k4 = bounds.ninv_chain_bound(r, iters)
    ops = (2 * iters + 1) * 2 * r ** 3
    assert k4["bound_ms"] == pytest.approx(ops / bounds.PEAK_F32 * 1e3,
                                           rel=1e-12)
    assert k4["cluster_sms"] == tns.ninv_layout(r).ctas == r // 16
    assert k4["cluster_bound_ms"] == pytest.approx(
        k4["bound_ms"] * bounds.SMS / (r // 16), rel=1e-12)
    cmb = bounds.tri_combine_bound(r)
    assert cmb["bound_by"] == "operations"
    assert cmb["bound_ms"] == pytest.approx(
        4 * r ** 3 / bounds.PEAK_F32 * 1e3, rel=1e-12)
    assert bounds.combine_ops(r) == 4 * r ** 3
