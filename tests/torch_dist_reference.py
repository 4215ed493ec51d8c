"""The JAX side of ``tests/test_torch_dist*.py``: the reference's
distributed entry points on ``d`` of the 8 virtual CPU devices
(``tests/conftest.py``), on the inputs of ``torch_dist_cases``, and the
checks that hold the ranks' assembled outputs against them.

Tolerances:
  * fp32 cases: every output within 1e-4 relative Frobenius of the
    reference's (no sign canonicalization: both packages make the same
    sign choices);
  * POLICY_MIXED cases: every criterion of ``metrics.evaluate`` (8 bits)
    true, and the backward and orthogonality errors within 2x of the
    reference's on the same call;
  * ``mode='r'`` with ``b``: x from ``back_substitution`` within 5e-3 of
    the x that made b (the reference tests' bound).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torch_dist_cases as C
from mixedprecisionblockqr_tpu.ops import metrics as jmetrics
from mixedprecisionblockqr_tpu.ops.policy import policy_by_name
from mixedprecisionblockqr_tpu.parallel.batched import (
    block_qr_batched_sharded,
    tsqr_batched_sharded_2d,
)
from mixedprecisionblockqr_tpu.parallel.dist_qr import dist_block_qr
from mixedprecisionblockqr_tpu.parallel.mesh import make_mesh
from mixedprecisionblockqr_tpu.parallel.tsqr import tsqr_sharded
from mixedprecisionblockqr_tpu.utils.checks import NonFiniteError
from mixedprecisionblockqr_tpu_torch import back_substitution
from mixedprecisionblockqr_tpu_torch.ops import metrics as tmetrics

REL_F32 = 1e-4
MIXED_FACTOR = 2.0
SOLVE_ATOL = 5e-3


def cases(d):
    out = dict(C.DIST_CASES, **C.OTHER_CASES)
    if d == 4:
        out["tsqr_2d"] = C.TSQR_2D_CASE
    return out


def _mesh(case, d):
    shape, names = C.mesh_spec(case, d)
    return make_mesh(shape, names, devices=jax.devices()[:d])


def reference(case, d):
    """The reference's outputs of one case, as numpy arrays."""
    a, b = C.inputs_of(case)
    kw = dict(case["kw"])
    if "policy" in kw:
        kw["policy"] = policy_by_name(kw["policy"])
    mesh = _mesh(case, d)
    kind = case["kind"]
    if kind == "dist":
        out = dist_block_qr(a, mesh, b=b, **kw)
    elif kind == "tsqr":
        out = tsqr_sharded(a, mesh, **kw)
    elif kind == "batched":
        out = block_qr_batched_sharded(a, mesh, **kw)
    else:
        out = tsqr_batched_sharded_2d(a, mesh, **kw)
    out = out if isinstance(out, tuple) else (out,)
    return tuple(np.asarray(x, np.float32) for x in out)


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def check_parity(per_rank, name, d):
    """Hold case ``name``'s assembled outputs against the reference."""
    case = cases(d)[name]
    keys, splits = C.outputs_of(case)
    refs = reference(case, d)
    assert len(refs) == len(keys), (name, len(refs), keys)
    got = {k: C.assemble(per_rank, name, k, s) for k, s in zip(keys, splits)}
    for k, ref in zip(keys, refs):
        assert got[k].shape == ref.shape, (name, k, got[k].shape, ref.shape)
    policy = case["kw"].get("policy")
    a, b = C.inputs_of(case)
    if policy == "mixed":
        bits = policy_by_name(policy).precision_bits
        rep = tmetrics.evaluate(torch.from_numpy(a),
                                torch.from_numpy(got["Q"]),
                                torch.from_numpy(got["R"]), bits)
        ref_rep = jmetrics.evaluate(a, refs[0], refs[1], precision_bits=bits)
        assert rep.all_ok, (name, str(rep))
        assert rep.backward <= MIXED_FACTOR * ref_rep.backward, (
            name, rep.backward, ref_rep.backward)
        assert rep.orthogonality <= MIXED_FACTOR * ref_rep.orthogonality, (
            name, rep.orthogonality, ref_rep.orthogonality)
    else:
        for k, ref in zip(keys, refs):
            assert _rel(got[k], ref) <= REL_F32, (name, k, _rel(got[k], ref))
    if b is not None:
        n = a.shape[1]
        xtrue = np.random.default_rng(case["b_seed"]).random(n).astype(
            np.float32)
        x = back_substitution(torch.from_numpy(got["R"][:n]),
                              torch.from_numpy(got["QtB"][:n, 0]))
        np.testing.assert_allclose(x.numpy(), xtrue, atol=SOLVE_ATOL)


def _reference_guard(name, d):
    """The reference's call of guard ``name`` (``C.guard_calls``)."""
    mesh = make_mesh(devices=jax.devices()[:d])
    u = C.uniform
    calls = {
        "block_size": lambda: dist_block_qr(u(4, (128, 64)), mesh,
                                            block_size=24, mode="r"),
        "bgs_width": lambda: dist_block_qr(u(14, (128, 100)), mesh,
                                           block_size=32,
                                           panel_method="bgs"),
        "bgs_complete": lambda: dist_block_qr(
            u(15, (256, 128)), mesh, block_size=32, mode="complete",
            panel_method="bgs"),
        "square_leaf": lambda: dist_block_qr(
            u(8, (256, 256)), mesh, block_size=256 // d, mode="r",
            panel_method="cholqr2"),
        "rows_divide": lambda: dist_block_qr(u(4, (129, 64)), mesh,
                                             block_size=16),
        "tsqr_rows_divide": lambda: tsqr_sharded(u(9, (129, 16)), mesh),
        "tsqr_short_leaf": lambda: tsqr_sharded(u(9, (32 * d, 64)), mesh,
                                                local_leaves=2),
        "tsqr_local_leaves": lambda: tsqr_sharded(u(9, (256, 16)), mesh,
                                                  local_leaves=3),
    }
    return calls[name]


def check_guard(per_rank, name, d):
    """Every rank raised the same ValueError, naming what the guard
    checks, and so does the reference."""
    _, exc, fragment = {g[0]: g for g in C.GUARD_SPECS}[name]
    seen = {tuple(rk["guards"][name] or ("none", "")) for rk in per_rank}
    assert len(seen) == 1, (name, seen)
    got_exc, msg = seen.pop()
    assert got_exc == exc and fragment in msg, (name, got_exc, msg)
    with pytest.raises(ValueError):
        _reference_guard(name, d)()


def check_nan(per_rank, d):
    """A NaN input raises NonFiniteError on every rank and in the
    reference."""
    for rk in per_rank:
        assert rk["guards"]["nan"] is not None, "no NonFiniteError"
        assert rk["guards"]["nan"][0] == "NonFiniteError"
    mesh = make_mesh(devices=jax.devices()[:d])
    with pytest.raises(NonFiniteError):
        dist_block_qr(C.nan_input(), mesh, **C.NAN_KW)
