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


def test_sketch_ranks_cpu_plain_and_device_guard():
    tns.reset_launches()
    tsk.sketch_qrcp_ranks(torch.from_numpy(_sketch(24, 256, 3)), 16)
    assert all(v == 0 for v in tns.LAUNCHES.values())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tsk.sketch_qrcp_ranks(torch.empty((24, 256), device="meta"), 16)
