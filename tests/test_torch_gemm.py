"""``tiled_matmul`` (kernel K8) of the port against the JAX package's
Pallas kernel, run in interpret mode on the CPU with 32-wide tiles, for
every type combination on an aligned and a ragged shape.  On CPU tensors
the port's wrapper runs its plain PyTorch version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops.pallas import gemm as jgemm
from mixedprecisionblockqr_tpu_torch.ops.kernels import gemm as tgemm

SHAPES = [(64, 96, 32), (70, 45, 33)]  # (m, k, n): tile multiples, ragged
TILES = dict(bm=32, bn=32, bk=32, interpret=True)


def _operands(shape, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    return (rng.random((m, k), dtype=np.float32) - 0.5,
            rng.random((k, n), dtype=np.float32) - 0.5)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_matches_jax(shape):
    # True fp32 on both sides: summation order only.
    a, b = _operands(shape, 0)
    cj = jgemm.tiled_matmul(jnp.asarray(a), jnp.asarray(b), jnp.float32,
                            **TILES)
    ct = tgemm.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert ct.dtype == torch.float32 and tuple(ct.shape) == cj.shape
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), a.astype(np.float64) @ b,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_accum_f32_matches_jax(shape):
    # bf16 x bf16 products are exact in fp32: summation order only.
    a, b = _operands(shape, 1)
    cj = jgemm.matmul_bf16_accum_f32(jnp.asarray(a), jnp.asarray(b), **TILES)
    ct = tgemm.matmul_bf16_accum_f32(torch.from_numpy(a),
                                     torch.from_numpy(b))
    assert ct.dtype == torch.float32
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-6)
    # the operands were rounded to bf16 first
    exact = _bf16(a).double().numpy() @ _bf16(b).double().numpy()
    np.testing.assert_allclose(ct.numpy(), exact, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_to_bf16_matches_jax(shape):
    # fp32 accumulator, one rounding at the end: equal, or one bf16 ulp
    # apart where the fp32 sums straddle a rounding boundary.
    a, b = _operands(shape, 2)
    cj = jgemm.tiled_matmul(jnp.asarray(a).astype(jnp.bfloat16),
                            jnp.asarray(b).astype(jnp.bfloat16),
                            jnp.bfloat16, **TILES)
    ct = tgemm.tiled_matmul(_bf16(a), _bf16(b), torch.bfloat16)
    assert ct.dtype == torch.bfloat16
    cj32 = np.asarray(cj.astype(jnp.float32))
    # (sums that cancel to near zero differ by the fp32 sums' own 1e-6)
    ulp = np.abs(cj32) * 2.0 ** -7 + 1e-6
    assert (np.abs(ct.float().numpy() - cj32) <= ulp).all()
    acc = tgemm.tiled_matmul(_bf16(a), _bf16(b), torch.float32)
    assert torch.equal(ct, acc.to(torch.bfloat16))


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_exact_and_matches_jax(shape):
    m, k, n = shape
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (m, k), dtype=np.int8)
    b = rng.integers(-128, 128, (k, n), dtype=np.int8)
    cj = jgemm.matmul_int8_accum_i32(jnp.asarray(a), jnp.asarray(b), **TILES)
    ct = tgemm.matmul_int8_accum_i32(torch.from_numpy(a),
                                     torch.from_numpy(b))
    assert ct.dtype == torch.int32
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert np.array_equal(ct.numpy(), exact)
    assert np.array_equal(np.asarray(cj), exact)


@pytest.mark.parametrize("shape", SHAPES)
def test_uint8_lift_exact_and_matches_jax(shape):
    m, k, n = shape
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (m, k), dtype=np.uint8)
    b = rng.integers(0, 256, (k, n), dtype=np.uint8)
    a[0, :] = 255  # the lift's extreme: (255 - 128) stays inside int8
    b[:, 0] = 255
    cj = jgemm.matmul_uint8_accum_i32(jnp.asarray(a), jnp.asarray(b),
                                      **TILES)
    ct = tgemm.matmul_uint8_accum_i32(torch.from_numpy(a),
                                      torch.from_numpy(b))
    assert ct.dtype == torch.int32
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert np.array_equal(ct.numpy(), exact)
    assert np.array_equal(np.asarray(cj), exact)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="tiled_matmul takes"):
        tgemm.tiled_matmul(torch.zeros((4, 5)), torch.zeros((4, 5)))


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    # For a tensor that is not on the CPU the wrapper launches the kernel
    # or raises; it never runs the plain version.  A 'meta' tensor stands
    # in for a device the kernel cannot take.
    def no_plain(*args, **kw):
        raise AssertionError("plain version used off the CPU")

    monkeypatch.setattr(tgemm, "tiled_matmul_plain", no_plain)
    a = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="tiled_matmul kernel takes"):
        tgemm.tiled_matmul(a, a)
