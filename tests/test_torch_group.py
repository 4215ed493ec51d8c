"""``bgs_group_fused`` (kernel K2) of the port against the JAX package's
Pallas kernel, run in interpret mode on the CPU, at m = 512, r = 32, g = 8.
On CPU tensors the port's wrapper runs its plain PyTorch version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops.pallas import ns as jns
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns

M, RW, G = 512, 32, 8
ITERS = (12, 6, 6, 6, 6, 6, 6, 10)  # head boost, aspect-16 base, tail bump


@pytest.fixture(scope="module")
def panel_group():
    return (np.random.default_rng(21).random((M, RW * G), dtype=np.float32)
            - 0.5)


def _both(Pg, robust_tail, bf16):
    robust = (False,) * (G - 1) + (robust_tail,)
    kw = dict(bf16_dots=bf16, bf16_gram=bf16, chain_mid=bf16)
    Qj, Rj, wj = jns.bgs_group_fused(jnp.asarray(Pg), RW, ITERS, robust,
                                     fuse_xw=True, interpret=True, **kw)
    Pt = torch.from_numpy(Pg)
    Qt, Rt, wt = tns.bgs_group_fused(Pt, RW, ITERS, robust, **kw)
    assert np.array_equal(Pt.numpy(), Pg), "the wrapper mutated its input"
    return (np.asarray(Qj), np.asarray(Rj), float(wj),
            Qt.numpy(), Rt.numpy(), float(wt))


@pytest.mark.parametrize("robust_tail", [False, True])
def test_group_fp32_matches_jax(panel_group, robust_tail):
    # fp32 products on both sides: atol 1e-4, as the JAX package's own
    # group-vs-XLA parity (tests/test_ns_kernel.py::
    # test_bgs_driver_ns_impl_parity).
    Qj, Rj, wj, Qt, Rt, wt = _both(panel_group, robust_tail, bf16=False)
    np.testing.assert_allclose(Qt, Qj, atol=1e-4)
    np.testing.assert_allclose(Rt, Rj, atol=1e-4)
    assert (wt < 1e-4) == (wj < 1e-4) and wt < 1e-4
    assert np.allclose(np.tril(Rt, -1), 0.0)


@pytest.mark.parametrize("robust_tail", [False, True])
def test_group_bf16_matches_jax(panel_group, robust_tail):
    # bf16-rounded Gram / Q / projection operands: an fp32 partial that
    # differs in its last bit may round to the other bf16 neighbour, so
    # the two packages agree to a relative Frobenius difference of 5e-3
    # (measured on the CPU: 9.5e-4 / 1.1e-3 for Q and 2.3e-4 / 5.4e-4 for
    # R, without / with the robust tail).
    Qj, Rj, wj, Qt, Rt, wt = _both(panel_group, robust_tail, bf16=True)
    rel_q = np.linalg.norm(Qt - Qj) / np.linalg.norm(Qj)
    rel_r = np.linalg.norm(Rt - Rj) / np.linalg.norm(Rj)
    assert rel_q <= 5e-3 and rel_r <= 5e-3, (rel_q, rel_r)
    assert (wt < 1e-4) == (wj < 1e-4) and wt < 1e-4

