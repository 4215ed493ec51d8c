"""The layout rule of K2 over a batch (``ops/kernels/ns.py::group_layout``
with ``members``): a single group keeps its layout, a stack of widths 128
and 256 takes the stack route (``csrc/stack_gemm.cu``), laid out by its B
members' tiles, and other widths keep ``csrc/panel.cuh``'s products split
by the members' tiles; the entries' check of a layout; the bounds and the
probe's CPU-side pieces.  The kernels run only on the card
(``chip_smoke.py`` phase 3, ``utils/batched_probe.py``); these rules are
plain Python on shapes."""

import ctypes

import pytest
import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.utils import batched_probe, bounds


def _single_group_layout(m, r, max_cluster=tns.L2_MAX_CLUSTER):
    """The single group's rule as it stood before a stack had a layout of
    its own: the r x r products' split of one member's 32 x 32 tiles,
    gemm_nt's small row tile unless 64-row tiles give 128 row blocks."""
    split, chunk = tns.tn_split(r, r, m)
    bn = tns._inst(r) or 128
    bm = 64 if -(-m // 64) >= tns.TARGET_CTAS else tns.NT_SMALL_BM[bn]
    return (split, chunk, bm, 64, bn, tns.ns_layout(r, max_cluster))


@pytest.mark.parametrize("m,r", [
    (2048, 128), (4096, 128), (16384, 128), (2048, 64), (2048, 32),
    (130, 128), (100, 128), (2048, 48), (2048, 100), (2048, 125),
    (2048, 192), (2048, 256), (4096, 96), (6144, 128), (1, 1),
])
def test_one_member_keeps_the_single_groups_layout(m, r):
    lay = tns.group_layout(m, r, members=1)
    assert tuple(lay[:6]) == _single_group_layout(m, r)
    assert lay.product_route == "panel"
    assert lay == tns.group_layout(m, r) == tns.group_layout(m, r, g=8)
    assert lay.args() == (*lay[:5], *tns._c_layout(lay.chain))
    assert tns.layout_ok(m, r, lay)


def _kind_ctas(lay, B, m, r, g):
    """CTAs a launch of each product kind (the wide kinds' widest)."""
    w = g * r
    shapes = {"gram": (r, r), "qpx": (m, r), "narrow_tn": (r, r),
              "narrow_nt": (m, r), "wide_tn": (r, w - 2 * r),
              "wide_nt": (m, w - 2 * r)}
    return {k: batched_probe.product_ctas(lay, B, k, *mn)
            for k, mn in shapes.items()}


@pytest.mark.parametrize("B,m,r,g,split,chunk,bm_panel,bm_wide,ctas", [
    # 8 members' Grams: 8 tiles x 8 ranks; Q = P X one 128-row tile a CTA
    (8, 2048, 128, 4, 8, 256, 128, 256,
     dict(gram=64, qpx=128, narrow_tn=64, narrow_nt=128, wide_tn=128,
          wide_nt=128)),
    # 16 members: the split stops at 4 so the clusters stay resident
    (16, 2048, 128, 4, 4, 512, 256, 512,
     dict(gram=64, qpx=128, narrow_tn=64, narrow_nt=128, wide_tn=128,
          wide_nt=128)),
    (2, 2048, 256, 4, 8, 256, 128, 128,
     dict(gram=64, qpx=64, narrow_tn=64, narrow_nt=64, wide_tn=128,
          wide_nt=128)),
    # a short stack: one 64-row stage and a ragged one
    (3, 130, 128, 4, 2, 128, 128, 128,
     dict(gram=6, qpx=6, narrow_tn=6, narrow_nt=6, wide_tn=12, wide_nt=12)),
])
def test_a_stack_is_laid_out_by_its_members(B, m, r, g, split, chunk,
                                            bm_panel, bm_wide, ctas):
    lay = tns.group_layout(m, r, members=B, g=g)
    assert lay.product_route == "stack"
    assert (lay.split, lay.chunk, lay.bm_panel, lay.bm_wide, lay.bn) == (
        split, chunk, bm_panel, bm_wide, 128)
    assert lay.chain == tns.ns_layout(r)
    assert _kind_ctas(lay, B, m, r, g) == ctas
    # every launch fits the card once: no product takes two waves
    assert max(ctas.values()) <= tns.STACK_SMS
    assert B * (r // tns.STACK_TILE) ** 2 * lay.split <= tns.STACK_CTAS
    assert (lay.split - 1) * lay.chunk < m <= lay.split * lay.chunk
    assert tns.layout_ok(m, r, lay)
    assert lay.batched_args() == (*lay[:5], 1, *tns._c_layout(lay.chain))
    # at r = 128 the narrow projection is one launch: a cluster a member
    assert tns.stack_fused_narrow(lay, r) == (r == 128)
    if r == 128:
        assert batched_probe.product_ctas(lay, B, "narrow", r, r) == (
            B * lay.split)


@pytest.mark.parametrize("m,B,fused", [
    (2048, 8, True), (130, 3, True),
    (256, 2, False),   # 64-row chunks: a CTA would update rows it did not sum
    (2048, 1, False),  # a single group keeps panel.cuh's products
])
def test_the_narrow_projection_is_fused_on_whole_tiles(m, B, fused):
    lay = tns.group_layout(m, 128, members=B, g=4)
    assert tns.stack_fused_narrow(lay, 128) is fused
    if fused:
        assert lay.chunk % tns.STACK_TILE == 0


@pytest.mark.parametrize("r", [100, 125, 48, 64, 192, 384])
def test_other_widths_keep_the_panel_products(r):
    # r = 100 / 125 start panels off 16 bytes; none of these is a whole
    # number of the stack route's 128-wide tiles up to 256
    lay = tns.group_layout(2048, r, members=8, g=4)
    assert lay.product_route == "panel"
    assert (lay.split, lay.chunk) == tns.tn_split(r, r, 2048, 8)
    # the members' 64-row blocks fill the card: the wide row tile
    assert lay.bm_panel == tns.NT_WIDE_BM
    assert tns.layout_ok(2048, r, lay)
    assert lay.batched_args()[5] == 0


def test_a_stack_too_short_for_a_stage_keeps_the_panel_products():
    assert tns.group_layout(48, 128, members=4, g=2).product_route == "panel"
    assert tns.stack_route(64, 128, 4)
    assert not tns.stack_route(2048, 128, 1)


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    ({"product_route": "bogus"}, False),
    ({"bm_panel": 64}, False),       # not whole 128-row tiles
    ({"bm_wide": 0}, False),
    ({"bn": 64}, False),
    ({"split": 9}, False),
    ({"chunk": 100}, False),         # not whole stages
    ({"split": 4}, False),           # chunks no longer cover m
    ({"product_route": "panel"}, False),  # 128-row tiles gemm_nt lacks
    ({"product_route": "panel", "bm_panel": 16, "bm_wide": 64}, True),
])
def test_the_entries_check_the_layout(change, ok):
    lay = tns.group_layout(2048, 128, members=8, g=4)._replace(**change)
    assert tns.layout_ok(2048, 128, lay) is ok


def test_a_stack_route_layout_is_refused_where_its_tiles_do_not_fit():
    lay = tns.group_layout(2048, 128, members=8, g=4)
    assert not tns.layout_ok(2048, 100, lay._replace(
        chain=tns.ns_layout(100)))
    assert not tns.layout_ok(32, 128, lay._replace(split=1, chunk=64))


def test_a_refused_layout_raises_before_any_launch():
    class Lib:
        def __getattr__(self, name):
            raise AssertionError(f"{name} called")

    lay = tns.group_layout(256, 128, members=2, g=2)._replace(
        product_route="bogus")
    Pg = torch.zeros((2, 256, 256))
    with pytest.raises(ValueError, match="do not take"):
        tns._launch_group(Lib(), Pg, 128, (6, 6), (False, False), True,
                          True, True, lay)


def test_the_batched_entry_takes_the_route_after_the_products():
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build._declare(Lib())
    ci, vp = ctypes.c_int, ctypes.c_void_p
    single = lib.mpbqr_bgs_group.argtypes
    batched = lib.mpbqr_bgs_group_batched.argtypes
    assert len(batched) == len(single) + 2  # B, the product route
    assert batched[-12:] == [ci] * 11 + [vp]
    assert len(lib.mpbqr_stack_product.argtypes) == 23
    assert "stack_gemm.cu" in _build.SOURCES
    assert "stack_gemm.h" in _build.HEADERS


@pytest.mark.parametrize("r,bf16", [(128, True), (128, False), (256, True)])
def test_the_products_floor_grows_with_the_members(r, bf16):
    rob = (False,) * 3 + (True,)
    floors = [bounds.group_batched_bound(B, 2048, r, (12, 6, 6, 10), rob,
                                         bf16)["products_floor_ms"]
              for B in (1, 2, 8, 16)]
    assert floors[0] > 0
    assert all(b > a for a, b in zip(floors, floors[1:]))
    # the products' operations are group_work's tall products
    ops = sum(bounds.product_work(*p)[0]
              for p in bounds.group_products(2048, r, rob))
    assert ops == bounds.group_work(2048, r, (12, 6, 6, 10), rob, bf16)[2]


def test_group_products_follow_the_entrys_order():
    kinds = [k for k, *_ in bounds.group_products(256, 32, (False, True,
                                                            False))]
    assert kinds == ["gram", "qpx", "narrow_tn", "narrow_nt", "wide_tn",
                     "wide_nt", "gram", "qpx", "gram", "qpx", "gram", "qpx",
                     "narrow_tn", "narrow_nt", "gram", "qpx"]


def test_the_probe_sorts_a_calls_spans_by_kind():
    # A two-panel group's spans as torch.profiler gives them: the critical
    # stream (1) holds the chains; the products match the entry's order.
    r, m, B = 128, 256, 2
    lay = tns.group_layout(m, r, members=B, g=2)
    spans = [("void mpbqr::stack_tn_kernel<true>", 1, 0, 5),
             ("void mpbqr::chain_kernel<128>", 1, 5, 105),
             ("void mpbqr::stack_nt_kernel<true>", 1, 105, 110),
             ("void mpbqr::stack_tn_kernel<true>", 1, 110, 114),
             ("void mpbqr::stack_nt_kernel<true>", 1, 114, 118),
             ("void mpbqr::stack_tn_kernel<true>", 1, 118, 123),
             ("void mpbqr::chain_kernel<128>", 1, 123, 223),
             ("void mpbqr::stack_nt_kernel<true>", 1, 223, 228),
             ("Memset (Device)", 1, 228, 229),
             ("void mpbqr::worst_resid", 1, 229, 230)]
    kinds = batched_probe.k2_kinds(spans, lay, B, m, r, (False, False),
                                   True)
    assert kinds["gram"]["launches"] == 2
    assert kinds["gram"]["ms"] == pytest.approx(0.010)
    assert kinds["qpx"]["ms"] == pytest.approx(0.010)
    assert kinds["narrow_tn"]["ms"] == pytest.approx(0.004)
    assert kinds["chain"] == {"ms": pytest.approx(0.2), "launches": 2}
    assert kinds["other"]["launches"] == 2
    assert kinds["unmatched"] == 0
    assert kinds["products_ms"] == pytest.approx(0.028)
    assert kinds["gram"]["ctas"] == [B * lay.split]
    assert kinds["gram"]["floor_ms"] > 0


def test_the_probe_counts_a_fused_narrow_projection_once():
    r, m, B = 128, 130, 3
    lay = tns.group_layout(m, r, members=B, g=2)
    assert tns.stack_fused_narrow(lay, r)
    spans = [("void mpbqr::stack_tn_kernel<true>", 1, 0, 5),
             ("void mpbqr::chain_kernel<128>", 1, 5, 105),
             ("void mpbqr::stack_nt_kernel<true, false>", 1, 105, 110),
             ("void mpbqr::stack_proj_kernel<true>", 1, 110, 118),
             ("void mpbqr::stack_tn_kernel<true>", 1, 118, 123),
             ("void mpbqr::chain_kernel<128>", 1, 123, 223),
             ("void mpbqr::stack_nt_kernel<true, false>", 1, 223, 228)]
    kinds = batched_probe.k2_kinds(spans, lay, B, m, r, (False, False),
                                   True)
    assert kinds["narrow"]["launches"] == 1
    assert kinds["narrow"]["ms"] == pytest.approx(0.008)
    assert kinds["narrow"]["ctas"] == [B * lay.split]
    assert "narrow_tn" not in kinds and "narrow_nt" not in kinds
    floors = bounds.group_product_floors(B, m, r, (False, False), True)
    assert kinds["narrow"]["floor_ms"] == pytest.approx(
        floors["narrow_tn"]["floor_ms"] + floors["narrow_nt"]["floor_ms"])
    assert kinds["qpx"]["launches"] == 2 and kinds["unmatched"] == 0


def test_batched_probe_needs_a_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert batched_probe.main(["--k2"]) == 2
    assert batched_probe.main(["--products"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
