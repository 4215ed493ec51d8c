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


def _route_of(t_a, t_b):
    m, k = t_a.shape
    return tgemm.tma_route(t_a.dtype, m, k, t_b.shape[1], t_a.data_ptr(),
                           t_a.stride(0), t_b.data_ptr(), t_b.stride(0))


# (dtype, m, k, n, a_ptr, a_stride0, b_ptr, b_stride0) -> TMA route?
ROUTE_CASES = {
    "bf16_aligned": ((torch.bfloat16, 2048, 2048, 2048, 4096, 2048, 8192,
                      2048), True),
    "bf16_ragged_aligned_strides": ((torch.bfloat16, 1000, 520, 776, 256,
                                     520, 512, 776), True),
    "bf16_one_row": ((torch.bfloat16, 1, 64, 128, 256, 64, 512, 128), True),
    "bf16_odd_row_stride_b": ((torch.bfloat16, 1000, 777, 513, 256, 784, 512,
                               513), False),
    "bf16_odd_row_stride_a": ((torch.bfloat16, 1000, 777, 512, 256, 777, 512,
                               512), False),
    "bf16_stride_multiple_of_4_not_8": ((torch.bfloat16, 64, 64, 64, 256,
                                         68, 512, 64), False),
    "bf16_odd_offset_a": ((torch.bfloat16, 64, 64, 64, 256 + 6, 1024, 512,
                           1024), False),
    "bf16_odd_offset_b": ((torch.bfloat16, 64, 64, 64, 256, 1024, 512 + 2,
                           1024), False),
    "bf16_k_zero": ((torch.bfloat16, 300, 0, 200, 256, 8, 512, 200), False),
    "f32_aligned": ((torch.float32, 2048, 2048, 2048, 4096, 2048, 8192,
                     2048), True),
    "f32_ragged_aligned_strides": ((torch.float32, 1000, 520, 776, 256, 520,
                                    512, 776), True),
    "f32_odd_row_stride": ((torch.float32, 1000, 777, 513, 256, 777, 512,
                            513), False),
    "f32_stride_multiple_of_2_not_4": ((torch.float32, 64, 64, 64, 256, 66,
                                        512, 64), False),
    "f32_odd_offset": ((torch.float32, 64, 64, 64, 256 + 4, 1024, 512,
                        1024), False),
    "f32_k_zero": ((torch.float32, 300, 0, 200, 256, 8, 512, 200), False),
    "int8_aligned": ((torch.int8, 2048, 2048, 2048, 4096, 2048, 8192, 2048),
                     False),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_tma_route_rule(case):
    # The rule is a pure function of dtype, shape, data_ptr() and strides:
    # bf16 or f32, k > 0, bases and row strides (in bytes) multiples of 16.
    args, want = ROUTE_CASES[case]
    assert tgemm.tma_route(*args) is want


@pytest.mark.parametrize("offset,want", [(0, True), (8, True), (16, True),
                                         (3, False), (4, False), (1, False)])
def test_tma_route_of_column_slices(offset, want):
    # A column slice of a wider row-major bf16 buffer keeps the buffer's row
    # stride; its base moves by two bytes a column.
    base = torch.zeros((64, 256), dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    a = base[:, offset:offset + 64]
    b = base[:64, offset:offset + 32]
    assert _route_of(a, b) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.bfloat16])
def test_tma_route_of_real_tensors_by_dtype(dtype):
    a = torch.zeros((32, 64), dtype=dtype)
    b = torch.zeros((64, 48), dtype=dtype)
    assert _route_of(a, b) is (dtype != torch.int8)
    # 63 columns: a row stride of 126 (bf16) or 252 (f32) bytes
    assert _route_of(torch.zeros((32, 63), dtype=dtype),
                     torch.zeros((63, 48), dtype=dtype)) is False


def test_route_counters_reset_with_launches():
    from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns

    tns.ROUTE_LAUNCHES["tma"] = 3
    tns.LAUNCHES["tiled_matmul"] = 3
    tns.reset_launches()
    assert tns.ROUTE_LAUNCHES == {"tma": 0, "predicated": 0}
    assert tns.LAUNCHES["tiled_matmul"] == 0
    # CPU calls run the plain version and count nothing
    tgemm.tiled_matmul(torch.zeros((4, 4)), torch.zeros((4, 4)))
    assert tns.LAUNCHES["tiled_matmul"] == 0
    assert sum(tns.ROUTE_LAUNCHES.values()) == 0
