"""Numerical health guards: make non-finite results loud."""

from __future__ import annotations

from typing import Iterable, Optional

import torch


class NonFiniteError(FloatingPointError):
    pass


def assert_all_finite(*arrays, names: Optional[Iterable[str]] = None) -> None:
    """Raise :class:`NonFiniteError` naming the first non-finite array."""
    names = list(names or [f"array{i}" for i in range(len(arrays))])
    for name, a in zip(names, arrays):
        a = torch.as_tensor(a)
        if not bool(torch.isfinite(a.float()).all()):
            raise NonFiniteError(
                f"{name} contains NaN/Inf (shape {tuple(a.shape)}, dtype "
                f"{a.dtype}) — for ill-conditioned inputs use POLICY_FP32"
            )


def checked_qr(A, **kwargs):
    """``block_qr`` with input/output finiteness guards."""
    from mixedprecisionblockqr_tpu_torch.ops.blockqr import block_qr

    assert_all_finite(A, names=["A"])
    out = block_qr(A, **kwargs)
    if isinstance(out, tuple):
        assert_all_finite(*out, names=["Q", "R"])
    else:
        assert_all_finite(out, names=["R"])
    return out
