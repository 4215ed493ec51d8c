"""``bgs_group_fused_proj`` (kernel K5) of the port against the JAX
package's Pallas kernel, run in interpret mode on the CPU, at m = 512,
r = 32, g = 4 with p = 128 previous columns; and the ``proj_entry`` route of
``_block_qr_bgs`` against the JAX driver's.  On CPU tensors the port's
wrapper runs its plain PyTorch version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops import blockqr as jbq
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.ops import policy as jpolicy
from mixedprecisionblockqr_tpu.ops.pallas import ns as jns
from mixedprecisionblockqr_tpu_torch.ops import blockqr as tbq
from mixedprecisionblockqr_tpu_torch.ops import metrics as tmetrics
from mixedprecisionblockqr_tpu_torch.ops import policy as tpolicy
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns

M, RW, G, P = 512, 32, 4, 128
ITERS = (6, 6, 6, 10)


@pytest.fixture(scope="module")
def group_and_prefix():
    rng = np.random.default_rng(33)
    Pg = rng.random((M, RW * G), dtype=np.float32) - 0.5
    # An orthonormal prefix inside a wider buffer, as the driver passes it.
    Qbuf, _ = np.linalg.qr(rng.standard_normal((M, 2 * P)))
    return Pg, Qbuf.astype(np.float32)


def _both(Pg, Qbuf, robust_tail, bf16):
    robust = (False,) * (G - 1) + (robust_tail,)
    kw = dict(bf16_dots=bf16, bf16_gram=bf16, chain_mid=bf16)
    qj = jnp.asarray(Qbuf).astype(jnp.bfloat16 if bf16 else jnp.float32)
    out_j = jns.bgs_group_fused_proj(jnp.asarray(Pg), qj[:, :P], RW, ITERS,
                                     robust, fuse_xw=True, interpret=True,
                                     **kw)
    Pt = torch.from_numpy(Pg)
    qt = torch.from_numpy(Qbuf).to(torch.bfloat16 if bf16 else torch.float32)
    out_t = tns.bgs_group_fused_proj(Pt, qt[:, :P], RW, ITERS, robust, **kw)
    assert np.array_equal(Pt.numpy(), Pg), "the wrapper mutated its input"
    return ([np.asarray(x, np.float32) for x in out_j],
            [x.float().numpy() for x in out_t])


@pytest.mark.parametrize("robust_tail", [False, True])
def test_group_proj_fp32_matches_jax(group_and_prefix, robust_tail):
    # fp32 products on both sides: atol 1e-4, as tests/test_torch_group.py.
    (Qj, Rpj, Rgj, wj), (Qt, Rpt, Rgt, wt) = _both(*group_and_prefix,
                                                   robust_tail, bf16=False)
    assert Rpt.shape == (P, RW * G)
    np.testing.assert_allclose(Qt, Qj, atol=1e-4)
    np.testing.assert_allclose(Rpt, Rpj, atol=1e-4)
    np.testing.assert_allclose(Rgt, Rgj, atol=1e-4)
    assert (wt < 1e-4) == (wj < 1e-4) and wt < 1e-4
    assert np.allclose(np.tril(Rgt, -1), 0.0)


@pytest.mark.parametrize("robust_tail", [False, True])
def test_group_proj_bf16_matches_jax(group_and_prefix, robust_tail):
    # A bf16 Qprev and bf16-rounded operands: a rounding may flip between
    # the packages, so relative Frobenius 5e-3 as tests/test_torch_group.py.
    (Qj, Rpj, Rgj, wj), (Qt, Rpt, Rgt, wt) = _both(*group_and_prefix,
                                                   robust_tail, bf16=True)
    for t, j in ((Qt, Qj), (Rpt, Rpj), (Rgt, Rgj)):
        rel = np.linalg.norm(t - j) / np.linalg.norm(j)
        assert rel <= 5e-3, rel
    assert (wt < 1e-4) == (wj < 1e-4) and wt < 1e-4


def test_group_proj_rprev_is_unrounded(group_and_prefix):
    # In bf16 mode the second product rounds C2, but Rprev is the fp32 C2.
    Pg, Qbuf = group_and_prefix
    qt = torch.from_numpy(Qbuf).to(torch.bfloat16)[:, :P]
    _, Rprev, _, _ = tns.bgs_group_fused_proj(
        torch.from_numpy(Pg), qt, RW, ITERS, (False,) * G, bf16_dots=True)
    C2 = tpolicy.mm_bf16(qt.T, torch.from_numpy(Pg))
    assert torch.equal(Rprev, C2)
    assert not torch.equal(Rprev, Rprev.to(torch.bfloat16).float())


def test_group_proj_equals_scrub_then_group(group_and_prefix):
    Pg, Qbuf = group_and_prefix
    Pt, qt = torch.from_numpy(Pg), torch.from_numpy(Qbuf)[:, :P]
    Qg, Rprev, Rg, w = tns.bgs_group_fused_proj(Pt, qt, RW, ITERS,
                                                (False,) * G, bf16_dots=False)
    C2 = tpolicy.mm_f32(qt.T, Pt)
    Q2, Rg2, w2 = tns.bgs_group_fused(Pt - tpolicy.mm_f32(qt, C2), RW, ITERS,
                                      (False,) * G, bf16_dots=False)
    assert torch.equal(Qg, Q2) and torch.equal(Rg, Rg2)
    assert torch.equal(Rprev, C2) and torch.equal(w, w2)
    # the scrubbed group is orthogonal to the prefix
    assert float((qt.T @ Qg).abs().max()) < 1e-5


@pytest.fixture(scope="module")
def a512():
    return np.random.default_rng(7).standard_normal((512, 512)).astype(
        np.float32)


def _close(t, j, atol=1e-4):
    # 1e-4 of the entries' scale: R of a 512 x 512 standard normal matrix
    # has entries up to ~30, and the packages differ in summation order.
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(np.asarray(t, np.float64), j,
                               atol=atol * max(1.0, float(np.abs(j).max())))


@pytest.mark.parametrize("proj_entry", [False, True])
def test_driver_proj_entry_matches_jax(a512, proj_entry):
    # tests/test_ns_kernel.py::test_bgs_proj_entry_parity on both packages.
    Rj, Qj, _ = jbq._block_qr_bgs(jnp.asarray(a512), 128,
                                  jpolicy.POLICY_FP32, True, None, 4, False,
                                  reorth=False, ns_impl="group",
                                  proj_entry=proj_entry)
    Rt, Qt, _ = tbq._block_qr_bgs(torch.from_numpy(a512), 128,
                                  tpolicy.POLICY_FP32, True, group_panels=4,
                                  reorth=False, proj_entry=proj_entry)
    _close(Rt.numpy(), Rj)
    # The square matrix's last panel is its ill-conditioned corner: the
    # shifted three-pass chain amplifies the packages' summation-order
    # differences there (measured 1.6e-4 on 18 entries), so that panel is
    # held to 1e-3 and every earlier one to 1e-4.
    _close(Qt.numpy()[:, :-128], np.asarray(Qj)[:, :-128])
    _close(Qt.numpy()[:, -128:], np.asarray(Qj)[:, -128:], atol=1e-3)


def test_driver_proj_entry_parity_and_r_only(a512):
    A = torch.from_numpy(a512)
    out = {pe: tbq._block_qr_bgs(A, 128, tpolicy.POLICY_FP32, True,
                                 group_panels=4, reorth=False, proj_entry=pe)
           for pe in (False, True)}
    np.testing.assert_allclose(out[False][0].numpy(), out[True][0].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(out[False][1].numpy(), out[True][1].numpy(),
                               atol=1e-4)
    # An R-only call still builds the Q buffer (K5's Qprev source) and
    # does not return it.
    R, Qn, _ = tbq._block_qr_bgs(A, 128, tpolicy.POLICY_FP32, False,
                                 group_panels=4, reorth=False,
                                 proj_entry=True)
    assert Qn is None
    np.testing.assert_allclose(R.numpy(), out[True][0].numpy(), atol=1e-6)


def test_driver_proj_entry_launches_k5_plain_per_later_group(a512,
                                                             monkeypatch):
    # 1024 x 1024, r = 128, g = 2: four groups, K2 on the first and K5 on
    # the other three, each with the written prefix of the Q buffer.
    a = np.random.default_rng(9).standard_normal((1024, 1024)).astype(
        np.float32)
    calls = []
    k5 = tbq.bgs_group_fused_proj

    def recording(Pg, Qprev, *args, **kw):
        calls.append((tuple(Pg.shape), tuple(Qprev.shape), Qprev.dtype,
                      Qprev.stride(0)))
        return k5(Pg, Qprev, *args, **kw)

    monkeypatch.setattr(tbq, "bgs_group_fused_proj", recording)
    R, Q, _ = tbq._block_qr_bgs(torch.from_numpy(a), 128,
                                tpolicy.POLICY_MIXED_FAST, True,
                                group_panels=2, reorth=False,
                                chain_mid=True, proj_entry=True)
    assert calls == [((1024, 256), (1024, p), torch.bfloat16, 1024)
                     for p in (256, 512, 768)]
    rep = tmetrics.evaluate(torch.from_numpy(a), Q, R, 8)
    assert rep.all_ok, str(rep)
    # reorth tiers ignore the flag
    calls.clear()
    tbq._block_qr_bgs(torch.from_numpy(a512), 128, tpolicy.POLICY_FP32, True,
                      group_panels=2, reorth=True, proj_entry=True)
    assert calls == []


def test_driver_proj_entry_mixed_quality(a512):
    # tests/test_ns_kernel.py::test_bgs_proj_entry_mixed_quality: the bf16
    # scrub keeps bgs1's quality band in both packages.
    a = np.random.default_rng(8).standard_normal((512, 512)).astype(
        np.float32)
    Rj, Qj, _ = jbq._block_qr_bgs(jnp.asarray(a), 128,
                                  jpolicy.POLICY_MIXED_FAST, True, None, 4,
                                  False, reorth=False, ns_impl="group",
                                  proj_entry=True)
    rj = jmetrics.evaluate(a, np.asarray(Qj, np.float32),
                           np.asarray(Rj, np.float32), precision_bits=8)
    Rt, Qt, _ = tbq._block_qr_bgs(torch.from_numpy(a), 128,
                                  tpolicy.POLICY_MIXED_FAST, True,
                                  group_panels=4, reorth=False,
                                  proj_entry=True)
    assert Qt.dtype == torch.bfloat16
    rt = tmetrics.evaluate(torch.from_numpy(a), Qt, Rt, 8)
    assert rt.all_ok and rj.all_ok, (str(rt), str(rj))
    for f in ("backward", "orthogonality"):
        vt, vj = getattr(rt, f), getattr(rj, f)
        assert vt <= 2 * vj and vj <= 2 * vt, (f, vt, vj)
