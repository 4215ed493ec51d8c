"""K1's shared-memory layout, its serial floor and its clock probe's slot
table (``utils/ns_probe.py``), all arithmetic that needs no device: the
kernel itself is held against its plain version on the card by
chip_smoke.py phase 3."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.utils import bounds, ns_probe

HEADER = Path(tns.__file__).resolve().parents[2] / "csrc" / "ns_chain.cuh"


@pytest.mark.parametrize("r,R", [(32, 32), (20, 32), (64, 64), (48, 64),
                                 (128, 128), (100, 128)])
def test_ns_layout_fits_a_cta_with_its_exchange_barriers(r, R):
    lay = tns.ns_layout(r)
    # X^T and C^T replicated (bf16 hi / lo rows of R + 8), four 16-row
    # stripes of R + 4 floats and 3 R + 64 floats of vectors: the clock
    # and the redesigned setup and products take no shared memory of
    # their own
    want = (2 * 4 * R * (R + 8) + 4 * 16 * (R + 4) * 4 + (3 * R + 64) * 4)
    assert lay == tns.NsLayout(R, "smem", R // 16, 0, want)
    assert lay.smem_bytes <= tns.SMEM_LIMIT
    assert lay.smem_bytes % 16 == 0


def test_layout_terms_match_the_kernel():
    src = HEADER.read_text()
    # the vectors follow the four fp32 stripes: the terms ns_layout adds
    assert ("static constexpr int OFF_VEC = OFF_QC + STRIPE_BYTES;" in src)
    assert ("static constexpr int BYTES = OFF_VEC + (3 * R + 32 + 32) * 4;"
            in src)


@pytest.mark.parametrize("iters,refine,want", [
    (10, False, 23),  # plain: 8 fused x 2 + 2 x 3 + the closing X
    (6, False, 15),   # chain_mid's 6 iterations
    (14, False, 31),  # shift
    (4, True, 13),    # refine: + the closing W and the max
    (12, False, 27),  # the second robust pass
    (2, False, 7),    # only the final two, each recomputing W
    (1, False, 4),
])
def test_serial_floor_counts_the_dependent_exchanges(iters, refine, want):
    assert bounds.ns_chain_exchanges(iters, refine) == want
    assert want - 1 - 2 * refine == ns_probe.loop_exchanges(iters)
    row = bounds.ns_chain_bound(128, iters, refine=refine, exchange_ms=0.0025)
    assert row["serial_exchanges"] == want
    assert row["serial_floor_ms"] == pytest.approx(want * 0.0025)
    # without a measured exchange the bound keeps its operations form
    plain = bounds.ns_chain_bound(128, iters, refine=refine)
    assert "serial_floor_ms" not in plain
    assert plain["bound_ms"] == row["bound_ms"]


def test_probe_slots_name_every_phase_of_the_clock():
    src = HEADER.read_text()
    body = re.search(r"enum \{\s*(NSP_[A-Z_, \n]*)NSP_SLOTS", src).group(1)
    names = [n.strip()[4:].lower() for n in body.split(",") if n.strip()]
    assert tuple(names) == tuple(s.lower() for s in ns_probe.SLOTS)
    assert set(ns_probe.LOOP_SLOTS) < set(ns_probe.SLOTS)
    assert set(ns_probe.EXCHANGE_SLOTS) <= set(ns_probe.LOOP_SLOTS)
    # every slot is recorded somewhere in the kernel
    for n in names:
        assert f"NS_PROF(NSP_{n.upper()})" in src
    assert ns_probe.PROF_BUILD[3] in _build.PARTIAL


@pytest.mark.parametrize("ctas,iters", [(8, 6), (8, 10), (4, 6), (2, 4)])
def test_phase_table_iteration_slots_add_up_to_the_iteration(ctas, iters):
    rng = np.random.default_rng(ctas * 100 + iters)
    S = len(ns_probe.SLOTS)
    raw = np.zeros((ns_probe.PROF_CTAS, 2, S), np.int64)
    loop = [ns_probe.SLOTS.index(s) for s in ns_probe.LOOP_SLOTS]
    raw[:ctas, 1, loop] = rng.integers(100, 5000, (ctas, len(loop)))
    raw[:ctas, 0] = raw[:ctas, 1]
    raw[:ctas, 0, [0, 8, 9]] = rng.integers(100, 9000, (ctas, 3))
    # a stale record beyond the launch's CTAs is never read
    raw[ctas:] = 10 ** 9
    t = ns_probe.phase_table(raw, ctas, iters, 1980.0)
    per_it = sum(v["per_iteration"] for v in t["slots"].values()
                 if "per_iteration" in v)
    assert per_it == pytest.approx(t["iteration_cycles"])
    assert sum(v["share"] for v in t["slots"].values()) == pytest.approx(1.0)
    assert set(t["slots"]) == set(ns_probe.SLOTS)
    assert t["launch_cycles"] == max(int(raw[p, 0].sum())
                                     for p in range(ctas))
    ex = [ns_probe.SLOTS.index(s) for s in ns_probe.EXCHANGE_SLOTS]
    want = min(int(raw[p, 1, ex].sum()) for p in range(ctas))
    assert t["exchange_cycles"] == pytest.approx(
        want / ns_probe.loop_exchanges(iters))
    assert t["exchange_us"] == pytest.approx(t["exchange_cycles"] / 1980.0)


def test_probe_option_sets_cover_the_main_paths_chains():
    sets = {n: (r, kw["iters"], kw.get("chain_mid", False),
                kw.get("refine", False), kw.get("shift", 0.0))
            for n, (r, _, kw) in ns_probe.OPTION_SETS.items()}
    assert sets["plain"] == (128, 10, False, False, 0.0)
    assert sets["chain_mid"] == (128, 6, True, False, 0.0)
    assert sets["shift"] == (128, 14, False, False, 1e-3)
    assert sets["refine"] == (128, 4, False, True, 0.0)
    assert sets["chain_mid_r64"][:3] == (64, 6, True)
    assert sets["chain_mid_r32"][:3] == (32, 6, True)


@pytest.mark.parametrize("B", [(), (3,)])
def test_library_yardstick_forms_the_inverse_factor(B):
    # cholesky then the triangular inverse: R^-1 with G = R^T R, as K1's X
    rng = np.random.default_rng(5)
    P = torch.from_numpy(rng.standard_normal((*B, 96, 32)).astype(np.float32))
    G = P.mT @ P
    X = ns_probe.cholesky_inverse(G)
    eye = torch.eye(32).expand_as(G)
    assert torch.allclose(X.mT @ G @ X, eye, atol=1e-4)
    assert torch.equal(X, torch.triu(X))


def test_partial_build_declares_the_chain_entries_only():
    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build.PARTIAL[("ns_chain.cu",)](Lib())
    assert set(vars(lib)) == {"mpbqr_ns_chain", "mpbqr_ns_chain_batched",
                              "mpbqr_ns_chain_resident"}
    full = _build._declare(Lib())
    for name in vars(lib):
        assert getattr(full, name).argtypes == getattr(lib, name).argtypes
