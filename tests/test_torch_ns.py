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
                            "tiled_matmul": 0, "chol_rinv": 0,
                            "givens_fold_rows": 0, "givens_chain": 0,
                            "givens_hessenberg": 0}


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
                                       (128, 64, 12), (256, 32, 8),
                                       (4096, 128, 5), (256, 128, 12)])
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


# -- the bounds of K1 and the wrapper's scratch contract --------------------


@pytest.mark.parametrize("r,iters,chain_mid,refine", [
    (128, 6, True, False), (128, 10, True, False), (128, 14, True, False),
    (128, 10, False, False), (128, 4, False, True), (128, 4, True, True),
    (64, 6, True, False), (32, 6, True, False),
])
def test_ns_chain_bound_counts_split_iterations_at_the_bf16_rate(
        r, iters, chain_mid, refine):
    from mixedprecisionblockqr_tpu_torch.utils import bounds

    row = bounds.ns_chain_bound(r, iters, chain_mid=chain_mid, refine=refine)
    mid = max(0, iters - 2) if chain_mid and not refine else 0
    products = 3 * iters + (2 if refine else 0) + 1
    # every product has a triangular operand: r^2 (r + 1) operations each
    one = r * r * (r + 1)
    assert bounds.tri_product_ops(r) == one < 2 * r ** 3
    f32 = (products - 3 * mid) * one / bounds.PEAK_F32
    bf16 = 9 * mid * one / bounds.PEAK_BF16
    t_bytes = 3 * r * r * 4 / bounds.HBM_BYTES_PER_S
    want = max(f32 + bf16, t_bytes) * 1e3
    assert row["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert row["bound_by"] == ("operations" if f32 + bf16 >= t_bytes
                               else "bytes")
    # one cluster of r / 16 SMs: that share of the card's peak rates
    assert row["cluster_sms"] == r // 16
    share = bounds.SMS / (r // 16)
    assert row["cluster_bound_ms"] == pytest.approx(
        max((f32 + bf16) * share, t_bytes) * 1e3, rel=1e-12)
    assert row["cluster_bound_ms"] >= row["bound_ms"]
    # the split iterations on the tensor cores lower the least time
    if mid:
        all_f32 = bounds.ns_chain_bound(r, iters)
        assert row["bound_ms"] < all_f32["bound_ms"]


@pytest.mark.parametrize("bf16", [False, True])
def test_group_and_panel_bounds_count_the_chains_as_ns_chain_bound_does(bf16):
    from mixedprecisionblockqr_tpu_torch.utils import bounds

    m, r, one = 2048, 128, 128 * 128 * 129
    # the robust schedule: 14 and 12 iterations (split but for the final
    # two when chain_mid), a 4-iteration refine chain in fp32, and the two
    # full products of the t3 t2 t1 combine
    f32, b16 = bounds.robust_ops(r, chain_mid=bf16)
    mid = (12 + 10) if bf16 else 0
    assert b16 == 9 * mid * one
    assert f32 == (43 + 37 + 15 - 3 * mid) * one + 2 * 2 * r ** 3
    # one plain panel and one robust panel: chains, Grams, Q = P X, and
    # the projection of the second panel's columns
    row = bounds.group_bound(m, r, (6, 10), (False, True), bf16)
    cf, cb = bounds.chain_ops(r, 6, chain_mid=bf16)
    tall = (2 + 6) * 2 * m * r * r + 2 * 2 * m * r * r
    if bf16:
        t_ops = ((cf + f32) / bounds.PEAK_F32
                 + (cb + b16 + tall) / bounds.PEAK_BF16)
    else:
        t_ops = (cf + f32 + tall) / bounds.PEAK_F32
    assert row["bound_by"] == "operations"
    assert row["bound_ms"] == pytest.approx(t_ops * 1e3, rel=1e-12)
    if not bf16:
        k3 = bounds.panel_qr_bound(m, r)
        assert k3["bound_ms"] == pytest.approx(
            (f32 + 6 * 2 * m * r * r) / bounds.PEAK_F32 * 1e3, rel=1e-12)


def test_kernel_bounds_lists_the_chain_rows():
    from mixedprecisionblockqr_tpu_torch.utils import bounds

    rows = bounds.kernel_bounds()
    for name in ("K1 ns_chain", "K1 ns_chain shift", "K1 ns_chain refine"):
        assert {"bound_ms", "bound_by", "cluster_bound_ms",
                "cluster_sms"} <= set(rows[name])
    # K8's rows have no cluster bound and keep their whole-card form
    assert set(rows["K8 tiled_matmul"]) == {"shape", "bound_ms", "bound_by"}


def test_ns_chain_kernel_takes_no_global_scratch():
    # The chain's C entry takes G, three outputs, a scratch, seven scalars,
    # the layout's five numbers and the stream.  Up to 128 every operand
    # of the chain lives in shared memory and the layout asks for no
    # scratch, so the wrapper allocates the outputs and nothing else; only
    # the L2 route (above 128) keeps its operands in global scratch.
    import ctypes

    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build._declare(Lib())
    args = lib.mpbqr_ns_chain.argtypes
    # G, X, t, resid, the scratch, stream; the layout's five numbers
    assert args.count(ctypes.c_void_p) == 6
    assert args.count(ctypes.c_float) == 1      # shift
    assert len(args) == 18
    assert "mpbqr_ns_chain_scratch_floats" not in vars(lib)
    assert tns.ns_layout(128).scratch_floats == 0
    assert len(lib.mpbqr_tiled_matmul.argtypes) == 12   # ..., tma, stream
