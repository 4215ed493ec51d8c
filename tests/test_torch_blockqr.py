"""The port's Block Gram-Schmidt slice end to end against the JAX package,
under POLICY_FP32, plus the dispatch table.

512^2 with r = 32 and g = 8 has the headline's structure (panel aspect 16,
two groups, one robust tail panel).  JAX runs on the CPU with its Pallas
kernels in interpret mode; the port runs its plain kernel versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.ops import blockqr as jbq
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu_torch.ops import blockqr as tbq
from mixedprecisionblockqr_tpu_torch.ops import policy as tpolicy

TIERS = ("bgs1", "bgs2", "bgs")


@pytest.fixture(scope="module")
def a512():
    return np.random.default_rng(0).random((512, 512), dtype=np.float32) - 0.5


@pytest.fixture(scope="module")
def jax_fp32(a512):
    out = {}
    for pm in TIERS:
        Q, R = jbq.block_qr(jnp.asarray(a512), 32, jpolicy.POLICY_FP32,
                            mode="complete", panel_method=pm,
                            group_panels=8)
        out[pm] = (np.asarray(Q), np.asarray(R))
    return out


@pytest.mark.parametrize("pm", TIERS)
def test_slice_fp32_matches_jax(a512, jax_fp32, pm):
    # fp32 everywhere (the bgs2 scrub's emulated HIGH acts on a ~1e-7
    # leftover): Q and R agree at atol 1e-4.
    A = torch.from_numpy(a512)
    Q, R = pt.block_qr(A, 32, pt.POLICY_FP32, mode="complete",
                       panel_method=pm, group_panels=8)
    Qj, Rj = jax_fp32[pm]
    assert Q.dtype == torch.float32 and R.shape == (512, 512)
    np.testing.assert_allclose(Q.numpy(), Qj, atol=1e-4)
    np.testing.assert_allclose(R.numpy(), Rj, atol=1e-4)
    assert np.array_equal(A.numpy(), a512), "block_qr mutated its input"
    rep = pt.metrics.evaluate(A, Q, R, 23)
    assert rep.all_ok, str(rep)


def test_per_panel_route_matches_jax():
    # The per-panel route (ns_chain between plain products; JAX's
    # ns_impl='pallas') at 256^2, r = 32: fp32 parity at atol 1e-4.
    a = np.random.default_rng(1).random((256, 256), dtype=np.float32) - 0.5
    Rj, Qj, _ = jbq._block_qr_bgs(jnp.asarray(a), 32, jpolicy.POLICY_FP32,
                                  True, None, 4, False, reorth=False,
                                  ns_impl="pallas")
    Rt, Qt, _ = tbq._block_qr_bgs(torch.from_numpy(a), 32, tpolicy.POLICY_FP32,
                                  True, group_panels=4, reorth=False,
                                  ns_impl="panel")
    np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)


def test_group_size_gate_picks_per_panel_route():
    # 4096 x 128 x 8 x 4 bytes = 16 MiB > 10 MiB: per-panel chains, as in
    # the JAX package; 2048 x 128 x 8 x 4 = 8 MiB takes the group kernel.
    assert tbq._group_kernel_fits(2048, 128, 8)
    assert not tbq._group_kernel_fits(4096, 128, 8)
    assert not tbq._group_kernel_fits(6144, 64, 2)
    for args in ((2048, 128, 8), (4096, 128, 8), (5120, 128, 4),
                 (5121, 32, 2), (3072, 128, 8)):
        assert tbq._group_kernel_fits(*args) == jbq._group_kernel_fits(*args)


_POL = ("fp32", "mixed", "mixed_fast", "bf16_fast", "fp64")
_DISPATCH = [
    (2048, 2048, 128, "auto", "unroll", 4, "complete", None),
    (4096, 4096, 128, "auto", "unroll", 4, "complete", None),
    (8192, 8192, 128, "auto", "unroll", 4, "complete", None),
    (16384, 16384, 128, "auto", "unroll", 4, "complete", None),
    (2048, 1000, 128, "auto", "unroll", 4, "complete", None),
    (4096, 2048, 128, "auto", "unroll", 4, "complete", None),
    (4096, 2048, 128, "auto", "unroll", 4, "reduced", None),
    (2048, 2048, 128, "auto", "unroll", 4, "complete", "fast"),
    (2048, 2048, 128, "auto", "unroll", 4, "complete", "balanced"),
    (2048, 2048, 128, "auto", "unroll", 4, "complete", "high"),
    (2048, 2048, 128, "auto", "unroll", 4, "complete", "robust"),
    (8192, 8192, 128, "auto", "unroll", 4, "complete", "balanced"),
    (16384, 16384, 128, "auto", "unroll", 4, "complete", "high"),
    (512, 512, 64, "bgs1", "unroll", 4, "reduced", None),
    (512, 512, 64, "bgs2", "scan", 4, "reduced", None),
    (512, 100, 64, "bgs", "unroll", 4, "reduced", None),
    (512, 96, 64, "bgs", "unroll", 4, "reduced", None),
    (256, 256, 128, "householder", "scan", 4, "reduced", None),
]


@pytest.mark.parametrize("case", _DISPATCH)
def test_resolve_panel_config_matches_jax(case):
    # The cases of tests/test_blockqr.py:483-556, every policy, both
    # backends: the port returns the JAX package's tuple, or raises the
    # same error class.
    m, n, b, pm, lm, gp, mode, q = case

    def run(mod, policy_mod, pol, flag, acc):
        try:
            return mod.resolve_panel_config(
                m, n, b, policy_mod.policy_by_name(pol), pm, lm, gp,
                mode=mode, quality=q, **{flag: acc})
        except ValueError as e:
            return ("ValueError", type(e).__name__)

    for pol in _POL:
        for acc in (True, False):
            assert (run(tbq, tpolicy, pol, "on_gpu", acc)
                    == run(jbq, jpolicy, pol, "on_tpu", acc)), (pol, acc)


@pytest.mark.parametrize("quality", ["ultra", "fast"])
def test_resolve_quality_errors(quality):
    pm = "auto" if quality == "ultra" else "bgs1"
    with pytest.raises(ValueError, match="quality"):
        tbq.resolve_panel_config(2048, 2048, 128, tpolicy.POLICY_MIXED, pm,
                                 "unroll", 4, on_gpu=True, quality=quality)
