"""``ns_chain`` (kernel K1) of the port against the JAX package's Pallas
kernel, run in interpret mode on the CPU.  On CPU tensors the port's wrapper
runs its plain PyTorch version; the CUDA kernel is compared with that plain
version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops.pallas import ns as jns
from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns

R = 64


def _gram(kind):
    rng = np.random.default_rng(11)
    if kind == "random":
        P = rng.standard_normal((8 * R, R))
    elif kind == "ill":  # cond(P) = 1e4: the shift caps the Gram's condition
        U, _ = np.linalg.qr(rng.standard_normal((4 * R, R)))
        V, _ = np.linalg.qr(rng.standard_normal((R, R)))
        P = (U * np.logspace(0, -4, R)) @ V.T
    else:  # near identity: the refine chains' input
        E = rng.standard_normal((R, R))
        return (np.eye(R) + 1e-3 * (E + E.T)).astype(np.float32)
    P = P.astype(np.float32)
    return P.T @ P


MODES = {
    "plain6": ("random", dict(iters=6)),
    "plain10": ("random", dict(iters=10)),
    "shift": ("random", dict(iters=14, shift=1e-3)),
    "refine": ("near_eye", dict(iters=4, refine=True)),
    "chain_mid": ("random", dict(iters=8, chain_mid=True)),
    "classic": ("random", dict(iters=10, fuse_xw=False)),
    "no_omega": ("random", dict(iters=12, omega=False, chain_mid=True)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ns_chain_matches_jax(mode):
    # Same update, seed and guard; only the fp32 summation order differs
    # (rtol 1e-4 / atol 1e-5).  The canary class (resid < 1e-4) must agree.
    kind, kw = MODES[mode]
    G = _gram(kind)
    Xj, tj, rj = jns.ns_chain(jnp.asarray(G), interpret=True,
                              **{"fuse_xw": True, **kw})
    Xt, tt, rt = tns.ns_chain(torch.from_numpy(G), **kw)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-4,
                               atol=1e-5)
    assert (float(rt) < 1e-4) == (float(rj) < 1e-4), (float(rt), float(rj))
    assert np.allclose(np.tril(Xt.numpy(), -1), 0.0)
    assert np.allclose(np.tril(tt.numpy(), -1), 0.0)


@pytest.mark.parametrize("chain_mid", [False, True])
def test_ns_chain_shifted_ill_conditioned_matches_jax(chain_mid):
    # cond(G) = 1e8, capped near 1e3 by the shift: the chain amplifies the
    # packages' fp32 summation-order difference by about that factor, so
    # the check is normwise -- max|dX| <= 1e-4 max|X|, same for t -- and
    # both chains must converge (the robust tail's first pass).
    G = _gram("ill")
    kw = dict(iters=14, shift=1e-3, omega=False, chain_mid=chain_mid)
    Xj, tj, rj = jns.ns_chain(jnp.asarray(G), interpret=True, fuse_xw=True,
                              **kw)
    Xt, tt, rt = tns.ns_chain(torch.from_numpy(G), **kw)
    Xj, tj = np.asarray(Xj), np.asarray(tj)
    assert np.abs(Xt.numpy() - Xj).max() <= 1e-4 * np.abs(Xj).max()
    assert np.abs(tt.numpy() - tj).max() <= 1e-4 * np.abs(tj).max()
    assert float(rt) < 1e-4 and float(rj) < 1e-4


def test_ns_chain_canary_class_on_stalled_chain():
    # Two iterations cannot converge an ill-conditioned Gram: both
    # packages must report a residual above the canary threshold.
    G = _gram("ill")
    _, _, rj = jns.ns_chain(jnp.asarray(G), iters=2, interpret=True)
    _, _, rt = tns.ns_chain(torch.from_numpy(G), iters=2)
    assert float(rj) >= 1e-4 and float(rt) >= 1e-4


@pytest.mark.parametrize("scale", [1e-20, 1e-8, 1e8, 1e14, 1e20])
def test_norm2_est_scale_invariant(scale):
    # The power-iteration guard is computed scale-normalized: no overflow
    # for ||G|| >~ 3e8 and no 0/0 for tiny Grams.
    G = torch.from_numpy(_gram("random"))
    base = float(tns._norm2_est(G))
    true = float(torch.linalg.matrix_norm(G.double(), 2))
    assert 0.5 * true < base < 1.5 * true
    est = float(tns._norm2_est(G * scale))
    assert np.isfinite(est)
    assert abs(est / (base * scale) - 1.0) < 1e-3


def test_robust_composition_matches_jax():
    # tri_cholqr_robust_fused: three ns_chain passes between fp32 products.
    # At cond 1e4 the two packages' roundoff diverges through the chains,
    # so they are held to the same quality: reconstruction < 1e-4 and
    # orthogonality within 2x of the JAX composition (floor 5e-5).
    rng = np.random.default_rng(4)
    U, _ = np.linalg.qr(rng.standard_normal((256, 128)))
    V, _ = np.linalg.qr(rng.standard_normal((128, 128)))
    P = ((U * np.logspace(0, -4, 128)) @ V.T).astype(np.float32)
    Qj, tj, _, rj = jns.tri_cholqr_robust_fused(jnp.asarray(P),
                                                interpret=True)
    Qt, tt, Xt, rt = tns.tri_cholqr_robust_fused(torch.from_numpy(P))
    Qj = np.asarray(Qj, np.float64)
    Qt64, tt64 = Qt.double().numpy(), tt.double().numpy()
    orth_j = np.abs(Qj.T @ Qj - np.eye(128)).max()
    orth_t = np.abs(Qt64.T @ Qt64 - np.eye(128)).max()
    assert orth_t < max(5e-5, 2 * orth_j), (orth_t, orth_j)
    assert np.abs(Qt64 @ tt64 - P).max() < 1e-4
    assert float(rt) < 1e-2 and float(rj) < 1e-2


def test_cpu_tensors_never_count_launches():
    tns.reset_launches()
    G = torch.from_numpy(_gram("random"))
    tns.ns_chain(G, iters=6)
    P = torch.from_numpy(
        np.random.default_rng(5).random((256, 128), dtype=np.float32))
    tns.bgs_group_fused(P, 32, (12, 6, 6, 10), (False,) * 3 + (True,))
    tns.tri_cholqr_robust_fused(P[:, :32])
    tns.ninv_chain(torch.eye(32) * 1.5, iters=3)
    tns.tri_cholqr_fused(P[:, :32], iters=6)
    tns.bgs_group_fused_proj(P[:, 64:], P[:, :64], 32, (6, 6), (False, True))
    assert tns.LAUNCHES == {"ns_chain": 0, "bgs_group_fused": 0,
                            "panel_qr_fused": 0, "ninv_chain": 0,
                            "bgs_group_fused_proj": 0,
                            "panel_factor_fused": 0, "sketch_qrcp_ranks": 0,
                            "tiled_matmul": 0, "chol_rinv": 0}


def test_wrappers_reject_other_devices():
    # A tensor that is neither on the CPU nor on CUDA never reaches the
    # plain version: the wrapper raises.
    G = torch.from_numpy(_gram("random")).to("meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tns.ns_chain(G)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tns.bgs_group_fused(torch.empty((256, 128), device="meta"), 32,
                            (6,) * 4, (False,) * 4)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tns.bgs_group_fused_proj(torch.empty((256, 128), device="meta"),
                                 torch.empty((256, 64), device="meta"), 32,
                                 (6,) * 4, (False,) * 4)


def _yamamoto_S(m, r, seed):
    # tests/test_ns_kernel.py:130-146: I - Q1^T with Q1 the sign-fixed top
    # block of an m x r orthonormal basis (sigma(S) in [1, 2]).
    rng = np.random.default_rng(seed)
    Qb, _ = np.linalg.qr(rng.standard_normal((m, r)))
    Qb = Qb * np.where(np.diag(Qb[:r]) > 0, -1.0, 1.0)[None, :]
    return (np.eye(r) - Qb[:r].T).astype(np.float32)


@pytest.mark.parametrize("m,r,iters", [(512, 64, 6), (512, 64, 5),
                                       (128, 64, 12), (256, 32, 8)])
def test_ninv_chain_matches_jax(m, r, iters):
    # K4's plain version against the Pallas kernel in interpret mode: the
    # same products, summation order only (rtol/atol 1e-5); the fallback
    # class (resid < 1e-3) must agree.
    S = _yamamoto_S(m, r, 7)
    Xj, rj = jns.ninv_chain(jnp.asarray(S), iters=iters, interpret=True)
    Xt, rt = tns.ninv_chain(torch.from_numpy(S), iters=iters)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-5,
                               atol=1e-5)
    assert (float(rt) < 1e-3) == (float(rj) < 1e-3), (float(rt), float(rj))
    assert float(rt) < 1e-3


def test_ninv_chain_residual_propagates_nan_and_stalls():
    # A NaN in S must reach the residual (the drivers' LU fallback keys on
    # resid < 1e-3, which NaN fails); a near-singular S stalls above 1e-3.
    S = _yamamoto_S(256, 32, 3)
    S[4, 9] = np.nan
    _, rj = jns.ninv_chain(jnp.asarray(S), iters=5, interpret=True)
    _, rt = tns.ninv_chain(torch.from_numpy(S), iters=5)
    assert np.isnan(float(rj)) and np.isnan(float(rt))
    c = np.ones(3) / np.sqrt(3.0)
    S = np.zeros((32, 32), np.float32)
    S[:3, :3] = np.eye(3) - 0.999 * (2.0 * np.outer(c, c) - np.eye(3))
    S[3:, 3:] = np.eye(29)
    _, rj = jns.ninv_chain(jnp.asarray(S), iters=6, interpret=True)
    _, rt = tns.ninv_chain(torch.from_numpy(S), iters=6)
    assert float(rt) >= 1e-3 and float(rj) >= 1e-3
