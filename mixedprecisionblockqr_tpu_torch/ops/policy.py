"""Mixed-precision dtype policies and the policy-aware matmul.

Port of ``mixedprecisionblockqr_tpu/ops/policy.py``: the same six named
policies with torch dtypes, and ``matmul`` as the single precision
boundary.  bf16 GEMM inputs with fp32 accumulation stand in for the
reference's FP16 TensorCore path; the mixed-precision acceptance bound is
``2^-8 * m`` (bf16 has an 8-bit mantissa).

Precision contract of every product (``Precision`` below):
  * ``HIGHEST`` -- true fp32.  TF32 is switched off for every call and
    the caller's setting restored after it.  Two stacks of one batch size
    with a long summed index K (above ``STACK_CHUNK_K``) sum it in chunks
    of at most ``STACK_CHUNK_K``, one batched product a chunk accumulated
    in order (``torch.baddbmm``): cuBLAS's batched fp32 GEMM sums a long K
    in one pass, with 7x the error of its single GEMM's split K at K =
    2048 (measured on the H100), and the stacked drivers' Gram-Schmidt
    products (K = m) would lose that much orthogonality against the
    member-by-member calls.
  * ``DEFAULT`` with bf16 inputs -- operands rounded to bf16, exact
    products, fp32 accumulation.  On CUDA that is ``torch.mm(...,
    out_dtype=torch.float32)`` (``torch.bmm`` for two stacks of one batch
    size, as the batched drivers give); on the CPU (which refuses that
    form for bf16), and for operands that broadcast, the rounded operands
    are multiplied in fp32, the same contract.
  * ``HIGH`` -- emulated as the 3-pass bf16 Dekker split
    ``hi*hi + hi*lo + lo*hi`` with fp32 accumulation (cuBLAS has no such
    mode; the split is the one of ``ops/pallas/ns.py::_split_bf16``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class Precision(enum.Enum):
    DEFAULT = "default"
    HIGH = "high"
    HIGHEST = "highest"


_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.float64: "float64", torch.float16: "float16"}


def dtype_name(d: torch.dtype) -> str:
    """numpy-style dtype name ('float32', 'bfloat16', ...)."""
    return _NAMES[d]


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Where each stage of blocked QR computes, and at what precision.

    Fields as in the JAX package: ``panel`` (panel factorization dtype),
    ``trailing`` (GEMM input dtype of the trailing/projection updates),
    ``q_update`` (GEMM input dtype of Q accumulation), ``accum``
    (accumulation/output dtype), ``precision_bits`` (the ``2^-bits * m``
    criterion) and ``q_store`` (storage dtype of Q; None = accum).
    """

    panel: torch.dtype = torch.float32
    trailing: torch.dtype = torch.float32
    q_update: torch.dtype = torch.float32
    accum: torch.dtype = torch.float32
    precision_bits: int = 23
    q_store: Optional[torch.dtype] = None

    @property
    def name(self) -> str:
        def _n(d):
            return dtype_name(d).replace("float", "f").replace("bfloat16", "bf16")

        return f"panel-{_n(self.panel)}_trail-{_n(self.trailing)}_q-{_n(self.q_update)}"


POLICY_FP32 = DTypePolicy()
POLICY_MIXED = DTypePolicy(
    trailing=torch.bfloat16, q_update=torch.bfloat16, precision_bits=8
)
POLICY_BF16 = DTypePolicy(
    panel=torch.bfloat16, trailing=torch.bfloat16, q_update=torch.bfloat16,
    precision_bits=8,
)
POLICY_MIXED_FAST = DTypePolicy(
    trailing=torch.bfloat16, q_update=torch.bfloat16, q_store=torch.bfloat16,
    precision_bits=8,
)
POLICY_BF16_FAST = DTypePolicy(
    panel=torch.bfloat16, trailing=torch.bfloat16, q_update=torch.bfloat16,
    q_store=torch.bfloat16, precision_bits=8,
)
POLICY_FP64 = DTypePolicy(
    panel=torch.float64, trailing=torch.float64, q_update=torch.float64,
    accum=torch.float64, precision_bits=52,
)

_POLICIES = {
    "fp32": POLICY_FP32,
    "mixed": POLICY_MIXED,
    "mixed_fast": POLICY_MIXED_FAST,
    "bf16": POLICY_BF16,
    "bf16_fast": POLICY_BF16_FAST,
    "fp64": POLICY_FP64,
}


def policy_by_name(name: str) -> DTypePolicy:
    if name not in _POLICIES:
        raise ValueError(
            f"unknown dtype policy {name!r}; options: {sorted(_POLICIES)}"
        )
    return _POLICIES[name]


#: Longest summed index a stacked fp32 product sums in one pass (see the
#: precision contract above).
STACK_CHUNK_K = 256
#: Most chunks a stacked fp32 product splits its summed index into.
STACK_MAX_CHUNKS = 8


def _bmm_chunked(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for two 3-D stacks of one batch size, the summed index in
    ceil(K / STACK_CHUNK_K) chunks (at most STACK_MAX_CHUNKS), each a
    batched product added to the running sum in order."""
    K = a.shape[-1]
    bounds = torch.linspace(0, K, min(STACK_MAX_CHUNKS,
                                      -(-K // STACK_CHUNK_K)) + 1).long()
    out = None
    for k0, k1 in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        ak, bk = a[..., k0:k1], b[..., k0:k1, :]
        out = (torch.bmm(ak, bk) if out is None
               else torch.baddbmm(out, ak, bk))
    return out


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """True fp32 product (Precision.HIGHEST): TF32 is off for this call and
    the caller's setting is restored afterwards.  Two 3-D stacks of one
    batch size whose summed index exceeds ``STACK_CHUNK_K`` are summed in
    chunks (the module's precision contract)."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        a, b = a.float(), b.float()
        if (a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0]
                and a.shape[-1] > STACK_CHUNK_K):
            return _bmm_chunked(a, b)
        return torch.matmul(a, b)
    finally:
        flags.allow_tf32 = prev


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Single-pass bf16 product with fp32 accumulation."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a16.is_cuda and a16.dim() == 2 and b16.dim() == 2:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    if (a16.is_cuda and a16.dim() == 3 and b16.dim() == 3
            and a16.shape[0] == b16.shape[0]):
        return torch.bmm(a16, b16, out_dtype=torch.float32)
    return mm_f32(a16.float(), b16.float())


def split_bf16(a: torch.Tensor):
    """Two-term bf16 Dekker split a ~= hi + lo, both bf16."""
    hi = a.to(torch.bfloat16)
    lo = (a.float() - hi.float()).to(torch.bfloat16)
    return hi, lo


def mm_high(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Emulated Precision.HIGH: hi*hi + hi*lo + lo*hi, fp32 accumulation."""
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return mm_bf16(ah, bh) + mm_bf16(ah, bl) + mm_bf16(al, bh)


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    in_dtype: torch.dtype = torch.float32,
    accum_dtype: torch.dtype = torch.float32,
    precision: Optional[Precision] = None,
) -> torch.Tensor:
    """Policy-aware matmul: inputs cast to ``in_dtype``, accumulation and
    output in ``accum_dtype``.  ``precision`` defaults to HIGHEST for fp32
    inputs and DEFAULT otherwise, as in the JAX package."""
    if precision is None:
        precision = (Precision.HIGHEST if in_dtype == torch.float32
                     else Precision.DEFAULT)
    if in_dtype == torch.float64 or accum_dtype == torch.float64:
        return torch.matmul(a.to(in_dtype).double(),
                            b.to(in_dtype).double()).to(accum_dtype)
    a = a.to(in_dtype)
    b = b.to(in_dtype)
    if precision is Precision.HIGH:
        out = mm_high(a, b)
    elif in_dtype == torch.float32:
        out = mm_f32(a, b)
    else:
        out = mm_bf16(a, b)
    return out.to(accum_dtype)


def trailing_matmul(policy: DTypePolicy):
    """The trailing-matrix / projection products of a policy."""
    return lambda a, b: matmul(a, b, in_dtype=policy.trailing,
                               accum_dtype=policy.accum)


def q_matmul(policy: DTypePolicy):
    """The Q-accumulation products of a policy."""
    return lambda a, b: matmul(a, b, in_dtype=policy.q_update,
                               accum_dtype=policy.accum)


def accum_matmul(policy: DTypePolicy):
    """The small (r x r) reflector products: full precision in the
    accumulation dtype."""
    return lambda a, b: matmul(a, b, in_dtype=policy.accum,
                               accum_dtype=policy.accum)
