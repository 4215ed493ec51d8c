"""``sketch_qrcp_ranks`` (kernel K7) of the port against the JAX package:
its Pallas kernel in interpret mode and the XLA loop ``_sketch_qrcp`` that
the JAX package runs off the TPU.  The ranks of unselected columns differ
between those two (the padded width vs w), so every comparison is of the
stable argsort order: the pivots in selection order, then the rest in
column order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops.pallas.sketch import (
    sketch_qrcp_ranks as jax_ranks,
)
from mixedprecisionblockqr_tpu.ops.pivoted import _sketch_qrcp
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.ops.kernels import sketch as tsk


def _order(rank):
    return np.argsort(np.asarray(rank), kind="stable")


def _xla_order(a, r):
    w = a.shape[1]
    sel, _ = _sketch_qrcp(jnp.asarray(a), r)
    rank = np.full(w, w, np.int32)
    rank[np.asarray(sel)] = np.arange(r)
    return _order(rank)


def _sketch(d, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, w)).astype(np.float32)
    return a * np.exp(rng.standard_normal(w)).astype(np.float32)


# (d, w, r): widths that are and are not powers of two; the last is the
# RQRCP panels' d = 128 + 8 at a narrow trailing width.
CASES = [(24, 256, 16), (40, 300, 32), (136, 500, 128), (136, 200, 128)]


@pytest.mark.parametrize("case", CASES)
def test_sketch_ranks_match_jax(case):
    d, w, r = case
    a = _sketch(d, w, seed=w)
    rank = tsk.sketch_qrcp_ranks(torch.from_numpy(a), r)
    assert rank.dtype == torch.int32 and rank.shape == (w,)
    order = _order(rank.numpy())
    np.testing.assert_array_equal(
        order, _order(jax_ranks(jnp.asarray(a), r, interpret=True)))
    np.testing.assert_array_equal(order, _xla_order(a, r))
    assert sorted(np.where(rank.numpy() < r)[0].tolist()) == sorted(
        order[:r].tolist())
    assert (rank.numpy()[order[r:]] == w).all()


def test_sketch_ranks_zero_and_duplicate_columns():
    # The zero column is never an early pivot, and after one of a
    # duplicated pair is picked the other's residual norm drops to ~0.
    a = _sketch(24, 256, seed=1)
    a[:, 10] = 0.0
    a[:, 20] = a[:, 30]
    order = _order(tsk.sketch_qrcp_ranks(torch.from_numpy(a), 16).numpy())
    np.testing.assert_array_equal(
        order, _order(jax_ranks(jnp.asarray(a), 16, interpret=True)))
    np.testing.assert_array_equal(order, _xla_order(a, 16))
    assert 10 not in order[:16]
    assert not {20, 30} <= set(order[:16].tolist())


def test_sketch_ranks_nan_column_as_the_jax_kernel():
    # A NaN norm makes every step's max NaN: no column matches and the
    # kernel selects nothing, so all columns keep the unselected rank.
    # (The XLA loop's argmax would pick the NaN column instead; the port
    # follows the kernel.)
    a = _sketch(40, 300, seed=2)
    a[:, 7] = np.nan
    rank = tsk.sketch_qrcp_ranks(torch.from_numpy(a), 32).numpy()
    rank_j = np.asarray(jax_ranks(jnp.asarray(a), 32, interpret=True))
    assert (rank == 300).all() and (rank_j >= 300).all()
    np.testing.assert_array_equal(_order(rank), _order(rank_j))


def test_sketch_ranks_inf_entry_as_the_jax_kernel():
    # An inf entry makes its column's norm inf: it is selected first, its
    # qn is NaN in that row (inf * 0), every coefficient then NaN, and no
    # later step selects anything.
    a = _sketch(40, 300, seed=4)
    a[11, 123] = np.inf
    rank = tsk.sketch_qrcp_ranks(torch.from_numpy(a), 32).numpy()
    rank_j = np.asarray(jax_ranks(jnp.asarray(a), 32, interpret=True))
    assert rank[123] == 0 and (np.delete(rank, 123) == 300).all()
    np.testing.assert_array_equal(_order(rank), _order(rank_j))


# (d, w): the RQRCP panels' sketches (d = 128 + 8 at every panel width of
# n = 2048, d = 64 + 8), the widest shared-memory stripe at d = 136 and
# the first in-place one, RQRCP's first panel at n = 8192, widths below
# the cluster's 8 CTAs, rows that are not a multiple of 4, tall sketches,
# and the largest d and w the in-place route takes.
LAYOUT_CASES = ([(136, w) for w in range(128, 2049, 128)]
                + [(72, 1024), (72, 64), (136, 200), (136, 3352),
                   (136, 3353), (136, 8192), (1, 1), (24, 3), (40, 6),
                   (40, 7), (24, 9), (2000, 300), (138, 2048), (73, 300),
                   (700, 256), (700, 1024), (57592, 8), (136, 459680)])


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_sketch_layout_covers_the_width(case):
    # The rule the wrapper passes to the kernel: one cluster of at most 8
    # CTAs whose contiguous stripes cover the w columns exactly, each CTA's
    # shared memory within an H100 block's 232,448 bytes on the shared-
    # memory route (the stripe's columns of 4 ceil(d / 4) floats, its norms
    # and the pivot column), only the norms and the pivot column in place.
    d, w = case
    lay = tsk.sketch_layout(d, w)
    assert 1 <= lay.cluster <= tsk.MAX_CLUSTER and lay.cluster <= w
    assert (lay.cluster - 1) * lay.stripe < w <= lay.cluster * lay.stripe
    ldc = 4 * -(-d // 4)
    fixed = tsk._BASE_FLOATS + ldc + 4 * -(-lay.stripe // 4)
    assert lay.smem_bytes <= tsk.SMEM_LIMIT
    if lay.in_smem:
        assert lay.smem_bytes == 4 * (fixed + lay.stripe * ldc)
    else:
        assert lay.smem_bytes == 4 * fixed
        assert 4 * (fixed + lay.stripe * ldc) > tsk.SMEM_LIMIT


@pytest.mark.parametrize("case", [(57593, 1), (57593, 8), (60000, 64),
                                  (136, 459688), (8, 10 ** 6)])
def test_sketch_layout_refuses_what_no_block_holds(case):
    # Past the in-place route's own carve-out (the pivot column and the
    # stripe's norms) no layout fits: the rule raises, naming the limit,
    # before anything is launched.
    with pytest.raises(ValueError, match=str(tsk.SMEM_LIMIT)):
        tsk.sketch_layout(*case)


def test_sketch_layout_routes():
    # RQRCP at n = 2048: every panel's sketch in shared memory on 8 CTAs;
    # the first panel at n = 8192 in place; fewer columns than 8 CTAs one
    # column per CTA.
    lay = tsk.sketch_layout(136, 2048)
    assert lay == (8, 256, True, lay.smem_bytes) and lay.smem_bytes <= 145000
    assert all(tsk.sketch_layout(136, w).in_smem
               for w in range(128, 3353, 8))
    assert not tsk.sketch_layout(136, 3353).in_smem
    assert not tsk.sketch_layout(136, 8192).in_smem
    assert [tuple(tsk.sketch_layout(40, w)[:2]) for w in (1, 6, 8, 9)] == [
        (1, 1), (6, 1), (8, 1), (5, 2)]


def test_sketch_kernel_entry_takes_the_layout():
    # The C entry takes B, the scratch, the ranks, d, w, r, the four layout
    # fields and the stream; nothing else sizes the launch.
    import ctypes

    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    args = _build._declare(Lib()).mpbqr_sketch_qrcp.argtypes
    assert args == [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]


def test_sketch_bound_uses_the_kernels_cluster():
    from mixedprecisionblockqr_tpu_torch.utils import bounds

    row = bounds.sketch_bound(136, 2048, 128)
    ops = 128 * 4 * 136 * 2048
    assert row["cluster_sms"] == tsk.sketch_layout(136, 2048).cluster == 8
    assert row["bound_ms"] == pytest.approx(ops / bounds.PEAK_F32 * 1e3)
    assert row["cluster_bound_ms"] == pytest.approx(
        ops / (bounds.PEAK_F32 * 8 / bounds.SMS) * 1e3)
    assert bounds.sketch_bound(40, 6, 6)["cluster_sms"] == 6
    assert {"cluster_sms", "cluster_bound_ms"} <= set(
        bounds.kernel_bounds()["K7 sketch_qrcp_ranks"])


def test_sketch_ranks_cpu_plain_and_device_guard():
    tns.reset_launches()
    tsk.sketch_qrcp_ranks(torch.from_numpy(_sketch(24, 256, 3)), 16)
    assert all(v == 0 for v in tns.LAUNCHES.values())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tsk.sketch_qrcp_ranks(torch.empty((24, 256), device="meta"), 16)
