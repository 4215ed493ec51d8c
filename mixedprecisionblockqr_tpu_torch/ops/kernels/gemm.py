"""Tiled mixed-type GEMM: ``tiled_matmul`` (K8) beside its plain PyTorch
version, and the typed entry points over it.

Port of ``mixedprecisionblockqr_tpu/ops/pallas/gemm.py``.  ``C = A @ B``
for any (m, k) x (k, n) in the reference's combinations: f32 x f32 -> f32
(true fp32, never TF32), bf16 x bf16 -> f32, bf16 x bf16 -> bf16 (fp32
accumulator, one rounding at the end) and int8 x int8 -> int32 (exact);
uint8 operands go through the signed lift with rank-1 corrections.  The
TPU wrapper's ``bm``/``bn``/``bk``/``interpret`` arguments and its padding
to tile multiples have no counterpart: the CUDA kernels predicate their
ragged edges.

Two routes on the card, chosen by :func:`tma_route`, a rule on what the
hardware takes and not a retry after a failure (a failed build or launch
raises on either route).  ``"tma"``: bf16 and float32 operands that the
Tensor Memory Accelerator can describe (base address a multiple of 16
bytes, row stride a multiple of 16 bytes, k > 0) go to the kernels fed by a
TMA ring: ``wgmma`` for bf16, true fp32 FMA for float32.  ``"predicated"``:
everything else -- operands that TMA cannot describe (an odd row stride, a
column slice at an odd offset, k == 0) and int8 (tensor cores through
``mma.sync``, whose B tile is transposed in registers on its way into
shared memory, which a TMA copy cannot do) -- goes through the predicated
loaders: ``mma.sync`` for bf16 and int8, fp32 FMA for float32.
``LAUNCHES["tiled_matmul"]`` counts both routes, ``ROUTE_LAUNCHES`` each,
and ``last_route`` names the one the last call took.
"""

from __future__ import annotations

import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
    LAUNCHES, ROUTE_LAUNCHES, _stream,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import mm_bf16, mm_f32

#: (input dtype, output dtype) -> the C entry's combo code.
_COMBOS = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.float32): 1,
    (torch.bfloat16, torch.bfloat16): 2,
    (torch.int8, torch.int32): 3,
}
#: Bytes that TMA wants a base address and a row stride to be a multiple of.
TMA_ALIGN = 16
#: The route of the last ``tiled_matmul`` launch: "tma" or "predicated".
last_route = None


def tma_route(dtype: torch.dtype, m: int, k: int, n: int, a_ptr: int,
              a_stride0: int, b_ptr: int, b_stride0: int) -> bool:
    """Whether ``tiled_matmul`` takes a kernel fed by TMA for operands of
    ``dtype`` with these shapes, ``data_ptr()``s and row strides (in
    elements): bf16 or float32, k > 0, both base addresses and both row
    strides in bytes multiples of ``TMA_ALIGN``.  A one-row operand's
    stride is still held to the rule: the tensor map encodes it."""
    if dtype not in (torch.bfloat16, torch.float32) or min(m, k, n) < 1:
        return False
    esize = 2 if dtype == torch.bfloat16 else 4
    return all(v % TMA_ALIGN == 0 for v in
               (a_ptr, b_ptr, a_stride0 * esize, b_stride0 * esize))


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32):
    """Plain version of :func:`tiled_matmul`: integer outputs through an
    exact float64 product (every partial sum of int8 products is an
    integer below 2^53), bf16 inputs as exact products with fp32
    accumulation, anything else in true fp32; one cast to ``out_dtype``."""
    if not out_dtype.is_floating_point:
        return torch.matmul(a.double(), b.double()).to(out_dtype)
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return mm_bf16(a, b).to(out_dtype)
    return mm_f32(a, b).to(out_dtype)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``C = A @ B`` with fp32 / int32 accumulation per output tile.

    Shapes need not be tile multiples.  On CUDA the operands share one of
    the dtypes float32, bfloat16 or int8, have unit column stride (a column
    slice of a wider row-major buffer is read in place), and
    ``(dtype, out_dtype)`` is one of the four combinations of the module
    docstring; anything else raises.  The route (module docstring) follows
    from :func:`tma_route` alone.
    """
    global last_route
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul takes (m, k) x (k, n); got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.device.type == "cpu":
        return tiled_matmul_plain(a, b, out_dtype)
    combo = _COMBOS.get((a.dtype, out_dtype))
    m, k = a.shape
    n = b.shape[1]
    if (not a.is_cuda or b.device != a.device or b.dtype != a.dtype
            or combo is None or m < 1 or n < 1):
        raise ValueError(
            "tiled_matmul kernel takes two non-empty CUDA operands of one "
            "dtype with (dtype, out_dtype) in "
            f"{sorted(str(c) for c in _COMBOS)}; got {a.dtype} on "
            f"{a.device} x {b.dtype} on {b.device} -> {out_dtype}, shapes "
            f"{tuple(a.shape)} x {tuple(b.shape)}")
    for name, x in (("a", a), ("b", b)):
        if ((x.shape[1] > 1 and x.stride(1) != 1)
                or x.stride(0) < x.shape[1]):
            raise ValueError(f"{name} must have unit column stride and rows "
                             f"that do not overlap; strides {x.stride()}")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    tma = tma_route(a.dtype, m, k, n, a.data_ptr(), a.stride(0),
                    b.data_ptr(), b.stride(0))
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    code = library().mpbqr_tiled_matmul(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.stride(0),
        b.stride(0), n, combo, int(tma), _stream(a))
    check(code, "tiled_matmul")
    last_route = "tma" if tma else "predicated"
    LAUNCHES["tiled_matmul"] += 1
    ROUTE_LAUNCHES[last_route] += 1
    return c


def matmul_bf16_accum_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> fp32: operands rounded to bf16, fp32 accumulation."""
    return tiled_matmul(a.to(torch.bfloat16), b.to(torch.bfloat16),
                        torch.float32)


def matmul_int8_accum_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32, exact."""
    return tiled_matmul(a.to(torch.int8), b.to(torch.int8), torch.int32)


def matmul_uint8_accum_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint8 x uint8 -> int32, exact.  The kernel multiplies signed bytes,
    so the operands are lifted losslessly: with a' = a - 128 (int8),
    ``a b = a'b' + 128 (a'1 + 1b') + 128^2 k``: one int8 product plus
    rank-1 row- and column-sum corrections in plain torch."""
    a = a.to(torch.uint8)
    b = b.to(torch.uint8)
    k = a.shape[1]
    a_s = (a.to(torch.int32) - 128).to(torch.int8)
    b_s = (b.to(torch.int32) - 128).to(torch.int8)
    core = tiled_matmul(a_s, b_s, torch.int32)
    row = a_s.sum(dim=1, keepdim=True, dtype=torch.int32)
    col = b_s.sum(dim=0, keepdim=True, dtype=torch.int32)
    return core + 128 * (row + col) + 128 * 128 * k
