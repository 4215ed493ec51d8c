"""K1's L2 route (128 < r <= 1024): its layout, the column dealing that
evens out the cluster's work, the kernel's constants, its clock probe's
slot table and its serial barriers, all arithmetic that needs no device:
the kernel itself is held against its plain version on the card by
chip_smoke.py phase 3."""

import re
from pathlib import Path

import numpy as np
import pytest

from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.utils import bounds, ns_probe, ns_variants

HEADER = Path(tns.__file__).resolve().parents[2] / "csrc" / "ns_chain.cuh"
WIDTHS = (129, 192, 200, 256, 320, 512, 1024)


def _const(src, name):
    return re.search(rf"constexpr int {name} = ([^;]*);", src).group(1)


def l2_tiles(r, ctas):
    """The kernel's column dealing (csrc/ns_chain.cuh::l2_tile / l2_slots):
    per CTA, the first columns of its tiles of L2_TILE, tile j * ctas + p
    in even rounds j and j * ctas + ctas - 1 - p in odd ones, those at or
    past r dropped."""
    tiles = -(-r // tns.L2_TILE)
    out = []
    for p in range(ctas):
        own = []
        for j in range(-(-tiles // ctas)):
            c = tns.L2_TILE * (j * ctas + (ctas - 1 - p if j & 1 else p))
            if c < r:
                own.append(c)
        out.append(own)
    return out


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("r", WIDTHS)
def test_l2_layout_fits_a_cta_and_names_its_scratch(r, max_cluster):
    lay = tns.ns_layout(r, max_cluster)
    ld = -(-r // 4) * 4
    assert (lay.inst, lay.route) == (0, "l2")
    assert lay.ctas == min(max_cluster, 16, -(-r // 16))
    # G', G'^T; X, X^T, W, W^T twice; C: rows padded to 16 bytes
    assert lay.scratch_floats == 11 * r * ld
    # 512 floats before the ring (its mbarriers, and room to start it on
    # 1024 bytes), the ring of three stages (A 64 x 256 in boxes of 64 x
    # 32, B two tiles of 64 x 8), three vectors of r, 64 floats of
    # reductions and the norm estimates' 3 x 16 partials
    ring = 3 * 64 * (256 + 16)
    assert lay.smem_bytes == (512 + ring + 3 * r + 64 + 3 * 16) * 4
    assert lay.smem_bytes <= tns.SMEM_LIMIT


@pytest.mark.parametrize("ctas", [16, 8])
@pytest.mark.parametrize("r", WIDTHS)
def test_l2_dealing_owns_every_column_once(r, ctas):
    cs = tns.ns_layout(r, ctas).ctas
    tiles = l2_tiles(r, cs)
    cols = [c + j for own in tiles for c in own
            for j in range(tns.L2_TILE) if c + j < r]
    assert sorted(cols) == list(range(r))
    # a CTA's slots differ by at most one
    assert max(map(len, tiles)) - min(map(len, tiles)) <= 1


def _new_work(r, cs):
    """k-steps (of 4) that each CTA's warps multiply in one fused
    iteration (W C, X^T W, X C), mirroring l2_tprod's per-warp ranges: a
    warp takes one tile of 8 columns and 64 rows of a 256-row block."""
    work = []
    for own in l2_tiles(r, cs):
        w = 0
        for c0 in own:
            for i0 in range(0, r, 256):
                for rb in range(4):
                    row = i0 + 64 * rb
                    if row >= r:
                        continue
                    w += -(-min(r, c0 + 8) // 4)            # W C
                    w += -(-min(r, row + 64) // 4)          # X^T W
                    w += max(0, -(-(min(r, c0 + 8) - row) // 4))  # X C
        work.append(w)
    return work


def _old_stages(r, cs):
    """The 32-deep stages of 128-row tiles each CTA's l2_prod streamed in
    one fused iteration on contiguous columns (ceil(r / cs) a CTA)."""
    cw = -(-r // cs)
    out = []
    for p in range(cs):
        c0, c1 = min(r, p * cw), min(r, p * cw + cw)
        n = 0
        for cb in range(c0, c1, 16):
            for i0 in range(0, r, 128):
                for kb, ke in ((0, min(r, cb + 16)),        # W C
                               (0, min(r, i0 + 128)),       # X^T W
                               (i0, min(r, cb + 16))):      # X C
                    n += max(0, -(-(ke - kb) // 32))
        out.append(n)
    return out


def test_old_rule_ran_the_last_cta_half_again_the_mean():
    # the count the redesign started from: 40 stages on CTA 15 at r = 256
    # against a mean of ~27
    old = _old_stages(256, 16)
    assert max(old) == 40 and old[-1] == 40
    assert np.mean(old) == pytest.approx(26.75)


@pytest.mark.parametrize("r", WIDTHS)
def test_dealt_work_is_within_a_tenth_of_the_mean(r):
    cs = tns.ns_layout(r).ctas
    work, old = _new_work(r, cs), _old_stages(r, cs)
    ratio, old_ratio = max(work) / np.mean(work), max(old) / np.mean(old)
    # contiguous columns ran the last CTA 1.43-1.63x the mean; the dealt
    # tiles keep the slowest CTA within 1.10x of it when the tiles fill
    # whole rounds (r = 192, 256, 512, 1024), and within 1.40x when a
    # round is ragged (129, 200: one CTA holds a tile fewer; 320: 40
    # tiles on 16 CTAs, half of them hold three)
    whole = -(-r // tns.L2_TILE) % cs == 0
    assert ratio <= (1.10 if whole else 1.40)
    assert old_ratio >= 1.40 and ratio < old_ratio


def test_l2_constants_match_the_kernel():
    src = HEADER.read_text()
    # the dealing mirrored above
    assert ("return j * cs + ((j & 1) ? cs - 1 - rank : rank);" in src)
    assert ("const int tiles = (n + kL2Tile - 1) / kL2Tile;\n"
            "  return (tiles + cs - 1) / cs;" in src)
    assert int(_const(src, "kL2Tile")) == tns.L2_TILE
    assert _const(src, "kL2URows") == "256"
    assert _const(src, "kL2Box") == "32"
    assert int(_const(src, "kL2Stages")) == tns.L2_STAGES
    assert int(_const(src, "kL2RingSlack")) == tns.L2_RING_SLACK_FLOATS
    assert int(_const(src, "kNormSlots")) == tns.L2_NORM_SLOTS
    assert int(_const(src, "kL2UDepth")) == tns.L2_DEPTH == 64
    assert int(_const(src, "kL2MaxCluster")) == tns.L2_MAX_CLUSTER
    assert f"L2M_C = 10, kL2Mats = {tns.L2_CHAIN_MATRICES}" in src
    assert "return (long long)kL2Mats * n * l2_ld(n);" in src
    assert ("return (kL2RingSlack + kL2RingFloats + 3 * r + 64 +\n"
            "              kNormSlots * kL2MaxCluster) * 4;" in src)
    assert tns.L2_CHAIN_STAGE_FLOATS == tns.L2_STAGES * 64 * (256 + 16)
    # K4 runs the same ring (and 64 floats of reductions beside it), the
    # combine a ring of the same stages' depth over its 32-row blocks
    slack = tns.L2_RING_SLACK_FLOATS
    assert tns.ninv_layout(256).smem_bytes == (
        slack + tns.L2_CHAIN_STAGE_FLOATS + 64) * 4
    assert tns.combine_layout(256).smem_bytes == (
        slack + tns.L2_STAGES * tns.L2_DEPTH * (32 + 16)) * 4


def test_l2_clock_names_every_slot():
    src = HEADER.read_text()
    body = re.search(r"enum \{\s*(NSL_[A-Z_, \n]*)NSL_SLOTS", src).group(1)
    names = [n.strip()[4:].lower() for n in body.split(",") if n.strip()]
    assert tuple(names) == ns_probe.L2_SLOTS
    for n in names:
        assert f"NS_PROF(NSL_{n.upper()})" in src
    assert "g_ns_l2_prof[16][2][NSL_SLOTS]" in src
    assert ns_probe.L2_PROF_CTAS == 16 == tns.L2_MAX_CLUSTER
    assert set(ns_probe.L2_EXCHANGE_SLOTS) <= set(ns_probe.L2_LOOP_SLOTS)
    assert set(ns_probe.L2_LOOP_SLOTS) < set(ns_probe.L2_SLOTS)
    assert ns_probe.PROF_BUILD[2] == 2  # both routes' records


@pytest.mark.parametrize("ctas,iters", [(16, 6), (16, 10), (12, 6), (9, 4)])
def test_l2_phase_table_keeps_every_cta(ctas, iters):
    rng = np.random.default_rng(ctas * 10 + iters)
    S = len(ns_probe.L2_SLOTS)
    raw = np.zeros((ns_probe.L2_PROF_CTAS, 2, S), np.int64)
    loop = [ns_probe.L2_SLOTS.index(s) for s in ns_probe.L2_LOOP_SLOTS]
    raw[:ctas, 1, loop] = rng.integers(100, 5000, (ctas, len(loop)))
    raw[:ctas, 0] = raw[:ctas, 1]
    rest = [k for k in range(S) if k not in loop]
    raw[:ctas, 0, rest] = rng.integers(100, 9000, (ctas, len(rest)))
    raw[ctas:] = 10 ** 9  # a stale record beyond the launch's CTAs
    t = ns_probe.phase_table(raw, ctas, iters, 1980.0, l2=True)
    assert t["route"] == "l2" and set(t["slots"]) == set(ns_probe.L2_SLOTS)
    assert sum(v["share"] for v in t["slots"].values()) == pytest.approx(1.0)
    per_it = sum(v["per_iteration"] for v in t["slots"].values()
                 if "per_iteration" in v)
    assert per_it == pytest.approx(t["iteration_cycles"])
    for name in ("launch", *ns_probe.L2_SLOTS):
        assert len(t["per_cta"][name]) == ctas
    assert t["per_cta"]["launch"] == [int(raw[p, 0].sum())
                                      for p in range(ctas)]
    b = ns_probe.L2_SLOTS.index("barrier")
    assert t["exchange_cycles"] == pytest.approx(
        min(int(raw[p, 1, b]) for p in range(ctas)) / iters)


def test_probe_l2_sets_cover_the_route():
    sets = {n: (r, kw["iters"], kw.get("chain_mid", False),
                kw.get("refine", False), kw.get("shift", 0.0))
            for n, (r, _, kw) in ns_probe.OPTION_SETS.items()}
    assert sets["l2_chain_mid"] == (256, 6, True, False, 0.0)
    assert sets["l2_plain"] == (256, 10, False, False, 0.0)
    assert sets["l2_shift"] == (256, 14, False, False, 1e-3)
    assert sets["l2_refine"] == (256, 4, False, True, 0.0)
    assert sets["l2_chain_mid_r192"][:3] == (192, 6, True)
    assert sets["l2_chain_mid_r512"][:3] == (512, 6, True)
    stacks = {n: v[:2] for n, v in ns_probe.BATCHED.items()}
    assert stacks["4x256_chain_mid"] == (4, 256)
    assert stacks["8x256_chain_mid"] == (8, 256)


@pytest.mark.parametrize("iters,refine,shift,want", [
    (6, False, False, 13),  # start, Jacobi's 4, seed, 6, max
    (10, False, False, 17),
    (14, False, True, 25),  # the shift's estimate too
    (4, True, False, 6),    # no estimate: seed, 4, max
    (4, True, True, 11),
    (12, False, True, 23),
])
def test_l2_serial_barriers(iters, refine, shift, want):
    assert bounds.ns_chain_l2_exchanges(iters, refine, shift) == want
    row = bounds.ns_chain_bound(256, iters, refine=refine, shift=shift,
                                exchange_ms=0.001)
    assert row["serial_exchanges"] == want
    assert row["serial_floor_ms"] == pytest.approx(want * 0.001)
    # the shared-memory route keeps its own count
    assert bounds.ns_chain_bound(128, iters, refine=refine,
                                 exchange_ms=0.001)["serial_exchanges"] == (
        bounds.ns_chain_exchanges(iters, refine))


@pytest.mark.parametrize("name", sorted(ns_variants.VARIANTS))
def test_variant_builds_edit_the_kernel_once_and_fit(name):
    src = HEADER.read_text()
    header = ns_variants.variant_header(src, ns_variants.VARIANTS[name])
    assert header != src
    for r in (192, 256, 1024):
        lay = ns_variants.variant_layout(header, r, 16)
        assert lay.smem_bytes <= tns.SMEM_LIMIT
        assert lay.scratch_floats == tns.ns_layout(r).scratch_floats
    # the tree's own header lays out as ns_layout does; a header of the
    # route before its own products (no kL2UDepth) as that route did
    assert ns_variants.variant_layout(src, 256, 16) == tns.ns_layout(256)
    old = ns_variants.variant_layout("constexpr int kL2Depth = 32;", 256,
                                     16)
    assert old.scratch_floats == 6 * 256 * 256
    assert old.smem_bytes == ((128 + 16) * 36 + 3 * 256 + 64) * 4
    with pytest.raises(ValueError, match="not once"):
        ns_variants.variant_header(src, [("no such text", "")])
