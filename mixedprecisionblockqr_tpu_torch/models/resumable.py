"""Checkpoint/resume for long-running factorizations (port of
``mixedprecisionblockqr_tpu/models/resumable.py``).

A segmented scan-BGS driver: ``ops/blockqr.py::_bgs_scan_machinery``
exposes the scan tier's step, the one-shot driver runs it over every
group, and this driver runs it ``segment_groups`` steps at a time and
saves the carry ``(qbuf, r, qtb, worst_resid)`` with ``torch.save`` after
each segment (where the JAX package uses orbax).  The step sequence is the
same, and a checkpoint holds the carry's exact bits, so a resumed
factorization is bit-identical to an uninterrupted one.

Each checkpoint is one file ``checkpoint_dir/step_<k>``, written under a
temporary name and renamed into place, so a file of that name is always
complete.  Checkpoints are read with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from mixedprecisionblockqr_tpu_torch.ops.blockqr import (
    DEFAULT_BLOCK_SIZE,
    _bgs_scan_finalize,
    _bgs_scan_machinery,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import POLICY_FP32, DTypePolicy
from mixedprecisionblockqr_tpu_torch.utils.device import as_device_tensor

_CARRY_KEYS = ("qbuf", "r", "qtb", "worst_resid")


def _latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(name[5:]) for name in os.listdir(directory)
             if name.startswith("step_") and name[5:].isdigit()
             and os.path.isfile(os.path.join(directory, name))]
    return max(steps) if steps else None


def _save(directory: str, k: int, carry) -> None:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{k}")
    tmp = path + ".tmp"
    torch.save(dict(zip(_CARRY_KEYS, carry)), tmp)
    os.replace(tmp, path)


def _restore(directory: str, k: int, device):
    tree = torch.load(os.path.join(directory, f"step_{k}"),
                      map_location=device, weights_only=True)
    return tuple(tree[key] for key in _CARRY_KEYS)


def block_qr_resumable(
    A,
    checkpoint_dir: str,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    mode: str = "reduced",
    B=None,
    group_panels: int = 1,
    reorth: bool = True,
    chain_mid: bool = False,
    segment_groups: int = 4,
    max_segments: Optional[int] = None,
    device=None,
):
    """Scan-BGS QR with checkpoint/resume between segments.

    Runs ``segment_groups`` scan steps (each factoring ``group_panels``
    panels) per segment and saves the carry under
    ``checkpoint_dir/step_<k>`` after each.  Calling again with the same
    ``checkpoint_dir`` resumes from the newest complete checkpoint; the
    result is bit-identical to the uninterrupted driver's.  Each save
    prunes the one before it, so on completion the directory holds only
    ``step_<nsteps>``, from which a further call returns the result
    without recomputing.

    ``max_segments`` bounds how many segments this call executes; when the
    bound stops the run early the return is ``None``: call again to
    continue.

    Returns ``(Q, R)`` like ``block_qr``: reduced ``(m, n)`` / ``(n, n)``
    factors (complete mode only for m == n), plus ``Q^T B`` as a third
    element when ``B`` is given.  ``device`` as in ``block_qr``.
    """
    A = as_device_tensor(A, device)
    m, n = A.shape
    if mode == "complete" and m != n:
        raise ValueError(
            "resumable driver: complete mode only for m == n "
            "(same contract as the BGS drivers)"
        )
    r = min(block_size, n)
    if n % r != 0 or m < n:
        raise ValueError(
            f"block_qr_resumable needs block_size | n and m >= n, got "
            f"shape {(m, n)} with block_size {r}; pad n to a multiple or "
            "use block_qr (whose hostile-shape fallback is not "
            "checkpointable)"
        )
    if B is not None:
        B = torch.as_tensor(B, device=A.device)
    step, carry, nsteps = _bgs_scan_machinery(
        A, B, block_size, policy, reorth=reorth, group_panels=group_panels,
        chain_mid=chain_mid)

    k = _latest_step(checkpoint_dir)
    if k is None:
        k = 0
    else:
        k = min(k, nsteps)
        carry = _restore(checkpoint_dir, k, A.device)

    done_segments = 0
    while k < nsteps:
        if max_segments is not None and done_segments >= max_segments:
            return None
        k1 = min(k + segment_groups, nsteps)
        for kk in range(k, k1):
            carry = step(kk, carry)
        _save(checkpoint_dir, k1, carry)
        prev = os.path.join(checkpoint_dir, f"step_{k}")
        if k > 0 and os.path.isfile(prev):
            os.remove(prev)
        k = k1
        done_segments += 1

    R_full, Q, QtB = _bgs_scan_finalize(m, n, policy, True, B is not None,
                                        *carry, reorth=reorth)
    R = R_full if mode == "complete" else R_full[:n, :]
    if B is not None:
        return Q, R, QtB
    return Q, R


def clear_checkpoints(checkpoint_dir: str) -> None:
    """Remove a factorization's checkpoint directory (safe on a missing
    path)."""
    shutil.rmtree(checkpoint_dir, ignore_errors=True)
