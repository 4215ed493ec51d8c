"""K4's L2 route and the L2 combine (128 < r <= 1024): their layouts
against the kernels' own constants, the scratch each kernel describes to
the copy engine, the columns their products deal, and K4's clock probe's
slot table, all arithmetic that needs no device: the kernels themselves
are held against their plain versions on the card by chip_smoke.py
phase 3."""

import re
from pathlib import Path

import numpy as np
import pytest

from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.utils import ninv_probe

CSRC = Path(tns.__file__).resolve().parents[2] / "csrc"
WIDTHS = (129, 192, 200, 256, 512, 1024)
#: kernel -> (its source, its matrix count's name there, the count ns.py
#: names) of the kernels whose L2 scratch one pair of l2_maps describes
MAPPED = {
    "ninv": ("ninv_chain.cu", "kL2NinvMats", tns.L2_NINV_MATRICES),
    "chain": ("ns_chain.cuh", "kL2Mats", tns.L2_CHAIN_MATRICES),
}


def _src(name):
    return (CSRC / name).read_text()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _enum(src, last):
    """name -> value of the enum that ends with ``last``."""
    body = re.search(rf"enum \{{([^}}]*\b{last} = \d+)\s*\}};", src).group(1)
    return {k.strip(): int(v) for k, v in
            (item.split("=") for item in body.split(","))}


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("r", WIDTHS)
def test_k4_l2_layout_matches_the_kernel(r, max_cluster):
    src, head = _src("ninv_chain.cu"), _src("ns_chain.cuh")
    lay = tns.ninv_layout(r, max_cluster)
    ld = -(-r // 4) * 4
    assert (lay.inst, lay.route) == (0, "l2")
    # one cluster of ceil(r / 16) CTAs, at most 16 and the card's largest
    assert lay.ctas == min(max_cluster, 16, -(-r // 16))
    # S^T, X and X^T twice, E: rows padded to 16 bytes
    assert _enum(src, "kL2NinvMats")["kL2NinvMats"] == tns.L2_NINV_MATRICES
    assert lay.scratch_floats == 6 * r * ld
    # l2_tprod's ring after its slack (mbarriers, 1024-byte start) and 64
    # floats of reductions
    ring = _const(head, "kL2Stages") * _const(head, "kL2UDepth") * (
        _const(head, "kL2URows") + 2 * _const(head, "kL2Tile"))
    assert tns.L2_CHAIN_STAGE_FLOATS == ring
    assert tns.L2_RING_SLACK_FLOATS == _const(head, "kL2RingSlack")
    assert lay.smem_bytes == 4 * (512 + ring + 64) <= tns.SMEM_LIMIT
    assert ("default: return (kL2RingSlack + kL2RingFloats + 64) * 4;"
            in src)


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("r", WIDTHS)
def test_combine_l2_layout_matches_the_kernel(r, max_cluster):
    src, head = _src("panel.cuh"), _src("ns_chain.cuh")
    lay = tns.combine_layout(r, max_cluster)
    ld = -(-r // 4) * 4
    assert (lay.inst, lay.route) == (0, "l2")
    # a cluster the row blocks of 32 of one column block of 16
    assert _const(src, "kCmbRows") == tns.COMBINE_ROWS == 32
    assert _const(src, "kCmbCols") == tns.COMBINE_COLS == 16
    assert lay.ctas == min(max_cluster, 16, -(-r // 32))
    # T1..T3 (padded copies) and A = T2 T1
    assert _const(src, "kL2CombineMats") == tns.L2_COMBINE_MATRICES == 4
    assert lay.scratch_floats == 4 * r * ld
    # three stages of 64 k: the first operand's 32 rows and two 8-column
    # tiles of the second, after the ring's slack
    ring = _const(head, "kL2Stages") * _const(head, "kL2UDepth") * (32 + 16)
    assert tns.COMBINE_RING_FLOATS == ring
    assert lay.smem_bytes == 4 * (512 + ring) <= tns.SMEM_LIMIT
    assert "default: return (kL2RingSlack + kCmbRingFloats) * 4;" in src


@pytest.mark.parametrize("kernel", sorted(MAPPED))
def test_l2_maps_count_each_kernels_own_matrices(kernel):
    source, mats, n_mats = MAPPED[kernel]
    src = _src(source)
    # the tensor maps span the launch's members at the kernel's own count,
    # and a member's first matrix is its index times that count
    maps = re.findall(r"l2_maps\(scratch, r, \w+, (\w+), &mapA, &mapB\)",
                      src)
    assert maps == [mats]
    assert f"{mats} * (int)blockIdx.y" in src
    # every matrix the kernel names lies inside its count
    enum = _enum(src, mats)
    assert enum[mats] == n_mats
    assert max(v for k, v in enum.items() if k != mats) < n_mats
    assert "(cuuint64_t)mats * batch" in _src("ns_chain.cuh")


def test_combine_maps_its_own_operands():
    src = _src("panel.cuh")
    # T1 and A as the second operand's tiles, T2 and T3 as the first's
    # boxes; the members' A after their three T copies
    assert "err = cmb_map(&maps[k], T[k], r, pitch, batch, mstride, k == 0);" \
        in src
    assert "cmb_map(&maps[3], At, r, ld, batch, mat, true)" in src
    assert "float* At = scratch + 3 * batch * mat;" in src
    assert "At, maps[0], maps[1], maps[2], maps[3]);" in src
    assert "l2_maps(" not in src


def l2_dealt(r, ctas):
    """The columns each CTA's products write (csrc/ns_chain.cuh::l2_tile,
    l2_slots): tiles of L2_TILE, tile j * ctas + p in even rounds j and
    j * ctas + ctas - 1 - p in odd ones, columns at or past r dropped."""
    tiles = -(-r // tns.L2_TILE)
    out = []
    for p in range(ctas):
        cols = []
        for j in range(-(-tiles // ctas)):
            c0 = tns.L2_TILE * (j * ctas + (ctas - 1 - p if j & 1 else p))
            cols += [c for c in range(c0, c0 + tns.L2_TILE) if c < r]
        out.append(cols)
    return out


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("r", [129, 200, 256, 1024])
def test_k4_dealt_columns_cover_every_column_once(r, max_cluster):
    ctas = tns.ninv_layout(r, max_cluster).ctas
    dealt = l2_dealt(r, ctas)
    assert sorted(c for cols in dealt for c in cols) == list(range(r))
    # no CTA holds more than one tile above another
    sizes = [len(cols) for cols in dealt]
    assert max(sizes) - min(sizes) <= tns.L2_TILE


@pytest.mark.parametrize("max_cluster", [16, 8])
@pytest.mark.parametrize("r", [129, 200, 256, 1024])
def test_combine_blocks_cover_every_element_once(r, max_cluster):
    # csrc/panel.cuh::combine_l2_kernel: CTA x of the grid takes column
    # block x / cs and, as rank x % cs, the row blocks [rank nb, (rank + 1)
    # nb) that start before r
    cs = tns.combine_layout(r, max_cluster).ctas
    rows64 = -(-r // tns.COMBINE_ROWS)
    nb = -(-rows64 // cs)
    seen = np.zeros((r, r), np.int64)
    for x in range(cs * -(-r // tns.COMBINE_COLS)):
        c0, rank = tns.COMBINE_COLS * (x // cs), x % cs
        for j in range(nb):
            i0 = tns.COMBINE_ROWS * (rank * nb + j)
            if i0 >= r:
                break
            seen[i0:i0 + tns.COMBINE_ROWS, c0:c0 + tns.COMBINE_COLS] += 1
    assert (seen == 1).all()
    assert cs <= max_cluster and nb * cs >= rows64


def test_k4_l2_clock_names_every_slot():
    src = _src("ninv_chain.cu")
    body = re.search(r"enum \{\s*(NL_[A-Z_, \n]*)NL_SLOTS", src).group(1)
    names = [n.strip()[3:].lower() for n in body.split(",") if n.strip()]
    assert tuple(names) == ninv_probe.L2_SLOTS
    for n in names:
        assert f"PROF(NL_{n.upper()})" in src
    assert "g_ninv_l2_prof[16][NL_SLOTS]" in src
    assert ninv_probe.L2_PROF_CTAS == 16 == tns.L2_MAX_CLUSTER
    assert set(ninv_probe.L2_LOOP_SLOTS) < set(ninv_probe.L2_SLOTS)
    # the read-out takes both routes' records, from ninv_chain.cu alone
    assert ninv_probe.PROF_BUILD[2] == 2
    assert ninv_probe.PROF_BUILD[3] in _build.PARTIAL
    assert "int mpbqr_ninv_prof(long long* prof, long long* prof_l2)" in src


@pytest.mark.parametrize("ctas,iters", [(16, 5), (16, 12), (12, 5), (9, 0)])
def test_k4_l2_phase_table_keeps_every_cta(ctas, iters):
    rng = np.random.default_rng(ctas * 10 + iters)
    S = len(ninv_probe.L2_SLOTS)
    raw = np.zeros((ninv_probe.L2_PROF_CTAS, S), np.int64)
    raw[:ctas] = rng.integers(100, 9000, (ctas, S))
    raw[ctas:] = 10 ** 9  # a stale record beyond the launch's CTAs
    t = ninv_probe.l2_phase_table(raw, ctas, iters, 1980.0)
    assert tuple(t["slots"]) == ninv_probe.L2_SLOTS
    assert sum(v["share"] for v in t["slots"].values()) == pytest.approx(1.0)
    assert t["per_cta"]["launch"] == [int(raw[p].sum()) for p in range(ctas)]
    assert t["launch_cycles"] == max(t["per_cta"]["launch"])
    for name in ("launch", *ninv_probe.L2_SLOTS):
        assert len(t["per_cta"][name]) == ctas
    for k, name in enumerate(ninv_probe.L2_SLOTS):
        slot = t["slots"][name]
        assert slot["cycles"] == pytest.approx(raw[:ctas, k].mean())
        assert ("per_iteration" in slot) == (
            name in ninv_probe.L2_LOOP_SLOTS and iters > 0)


def test_partial_build_declares_the_ninv_entries_only():
    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build.PARTIAL[("ninv_chain.cu",)](Lib())
    assert set(vars(lib)) == {"mpbqr_ninv_chain", "mpbqr_ninv_chain_batched",
                              "mpbqr_ninv_chain_resident"}
    full = _build._declare(Lib())
    for name in vars(lib):
        assert getattr(full, name).argtypes == getattr(lib, name).argtypes


def test_probe_l2_sets_cover_the_route():
    assert set(ninv_probe.L2_SETS.values()) == {
        (r, it) for r in (192, 256, 512, 1024) for it in (5, 12)}
    assert {ninv_probe.L2_SETS[n] for n in ninv_probe.L2_PHASE_SETS} == {
        (r, it) for r in (192, 256, 512) for it in (5, 12)}
    assert ninv_probe.L2_STACKS == {"4x256_it5": (4, 256, 5),
                                    "8x256_it5": (8, 256, 5)}
    assert ninv_probe.COMBINE_WIDTHS == (128, 192, 256, 512, 1024)
