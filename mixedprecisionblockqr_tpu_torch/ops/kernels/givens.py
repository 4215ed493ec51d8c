"""Givens-rotation chains: ``givens_fold_rows`` (G1), ``givens_chain`` (G2)
and ``givens_hessenberg`` (G3), each beside its plain PyTorch version.

No ``pallas_call`` is behind them: the JAX package runs these loops as
``lax.scan`` / ``lax.fori_loop`` programs in ``ops/givens.py``
(``_fold_rows_run``; the ``sweep_up`` / ``sweep_down`` chains of
``qr_rank1_update`` and the chains of ``qr_insert_col``, ``qr_delete_col``
and ``qr_delete_row``).  Eager PyTorch makes some ten launches a rotation,
so on the card each chain is one launch of a hand-written CUDA kernel
(``csrc/givens.cu``).  The wrappers launch it for CUDA tensors and raise on
anything it does not take; they run the plain version only for tensors on
the CPU.  Every call works in place on fp32 tensors and counts its launches
in ``ns.LAUNCHES``.  G1 and G3 hand coefficients between CTAs; a wait there
that runs past its poll limit (a fault) sets an abort flag and fills the
results with NaN.  :func:`raise_on_abort` reads the flag (which waits for
the kernel) and raises: the wrapper does so after its launch, unless the
caller passes a flag of its own (:func:`abort_flag`) and reads it later,
as the public functions of ``ops/givens.py`` do at their end.

The rotation convention is the reference's: ``givens_rotation(a, b)`` is
``c = a / r``, ``s = -b / r`` with ``r = hypot(a, b)``, and ``(1, 0)`` when
``r = 0``; rows ``(lo, hi)`` become ``(c lo - s hi, s lo + c hi)``.  The
plain versions repeat the reference's loops in its order; the kernels do the
same operations, each rounded on its own, so they give the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
    LAUNCHES,
    _require_cuda_f32,
    _stream,
)

#: Shared memory one CTA may use on an H100 (bytes).
SMEM_LIMIT = 232448
#: Rows G1 folds in one pass of its wavefront (csrc/givens.cu kSlots).
FOLD_SLOTS = 16
#: Columns of [X1 | X2] one G2 CTA walks (csrc/givens.cu kChainCols); G1
#: and G3 run one warp per 32 columns, several warps a CTA.
CHAIN_COLS = 96
#: G1's row-slot layouts (csrc/givens.cu fold_rows_kernel<NS>), each with
#: its warps a CTA, four slots a warp (FoldShape<NS>::NW).
FOLD_WARPS = {1: 1, 2: 1, 4: 1, 8: 2, 16: 4}
#: G3's warps a CTA, and at most (csrc/givens.cu kHessMaxWarps).
HESS_WARPS = 4
HESS_MAX_WARPS = 8
#: The word that marks a coefficient G1 or G3 has not written yet.
SENTINEL = -1
#: cudaErrorCooperativeLaunchTooLarge: G1's / G3's C entry returns it,
#: before launching, when the layout's CTAs cannot all be resident.
CUDA_COOPERATIVE_TOO_LARGE = 720


def givens_rotation(a: torch.Tensor, b: torch.Tensor):
    """``(c, s)`` with ``[[c, -s], [s, c]] [a; b] = [r; 0]``: ``c = a / r``,
    ``s = -b / r``, ``r = hypot(a, b)``; ``(1, 0)`` when ``r`` is 0 (or
    NaN)."""
    r = torch.hypot(a, b)
    safe = r > 0
    one = torch.ones_like(r)
    rs = torch.where(safe, r, one)
    return (torch.where(safe, a / rs, one),
            torch.where(safe, -b / rs, torch.zeros_like(r)))


def rot_rows(X: torch.Tensor, i: int, c, s) -> None:
    """Rows ``(i, i + 1)`` of X <- ``(c lo - s hi, s lo + c hi)``, in
    place."""
    lo, hi = X[i].clone(), X[i + 1].clone()
    X[i] = c * lo - s * hi
    X[i + 1] = s * lo + c * hi


def fold_words(n: int, k: int) -> int:
    """G1's coefficient words: (n + 16) diagonals of 16 rows for each block
    of 16 rows."""
    return -(-k // FOLD_SLOTS) * (n + FOLD_SLOTS) * FOLD_SLOTS


class GivensLayout(NamedTuple):
    """A G1 or G3 launch: ``ctas`` CTAs of ``warps`` warps, a lane per
    column; G3's warps on 32 consecutive columns each, G1's CTA on 32
    columns with its rows in blocks of ``slots`` spread over its warps."""

    ctas: int
    warps: int
    slots: int = 1

    @property
    def total_warps(self) -> int:
        return self.ctas * self.warps


def fold_layout(n: int, W: int, k: int) -> GivensLayout:
    """G1's launch for k rows of width W: the fewest slots (1, 2, 4, 8, 16)
    that hold min(k, 16) rows, a CTA per 32 columns, ``FOLD_WARPS[slots]``
    warps each (all on the same 32 columns, four slots a warp)."""
    slots = next(s for s in FOLD_WARPS if s >= min(k, FOLD_SLOTS))
    return GivensLayout(-(-W // 32), FOLD_WARPS[slots], slots)


def hessenberg_layout(m: int, nH: int, nQ: int,
                      warps: int | None = None) -> GivensLayout:
    """G3's launch on [H | Q^T]: ``HESS_WARPS`` warps a CTA (fewer when
    there are fewer groups of 32 columns), or ``warps`` (a developer's
    comparison, at most ``HESS_MAX_WARPS``)."""
    want = HESS_WARPS if warps is None else warps
    if not 1 <= want <= HESS_MAX_WARPS:
        raise ValueError(f"G3 takes 1 to {HESS_MAX_WARPS} warps a CTA, "
                         f"got {want}")
    groups = -(-(nH + nQ) // 32)
    want = min(want, groups)
    return GivensLayout(-(-groups // want), want)


def chain_smem(m: int, start: int) -> int:
    """G2's shared memory: the vector from ``start`` and the c, s of its
    ``m - 1 - start`` rotations."""
    return (m - start + 2 * max(m - 1 - start, 1)) * 4


# -- plain PyTorch versions ------------------------------------------------

def givens_fold_rows_plain(Raug: torch.Tensor, rows: torch.Tensor) -> None:
    """Plain version of :func:`givens_fold_rows` (``_fold_rows_run``'s
    loops): each row in turn meets pivots 0..n-1, every rotation over the
    full width."""
    n = Raug.shape[0]
    for arow in rows.clone():
        for i in range(n):
            c, s = givens_rotation(Raug[i, i], arow[i])
            Ri = Raug[i].clone()
            Raug[i] = c * Ri - s * arow
            arow = s * Ri + c * arow


def givens_chain_plain(v: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor,
                       start: int = 0) -> torch.Tensor:
    """Plain version of :func:`givens_chain` (``sweep_up``'s loop)."""
    w = v.clone()
    for i in range(w.shape[0] - 2, start - 1, -1):
        c, s = givens_rotation(w[i], w[i + 1])
        w[i] = c * w[i] - s * w[i + 1]
        w[i + 1] = 0.0
        rot_rows(X1, i, c, s)
        rot_rows(X2, i, c, s)
    return w[start].clone()


def givens_hessenberg_plain(H: torch.Tensor, Qt: torch.Tensor) -> None:
    """Plain version of :func:`givens_hessenberg` (``sweep_down``'s
    loop)."""
    m, n = H.shape
    for i in range(min(m - 1, n)):
        c, s = givens_rotation(H[i, i], H[i + 1, i])
        rot_rows(H, i, c, s)
        rot_rows(Qt, i, c, s)


# -- wrappers --------------------------------------------------------------

def _rows_match(name: str, X: torch.Tensor, m: int) -> None:
    if X.dim() != 2 or X.shape[0] != m:
        raise ValueError(f"{name} must have {m} rows, got {tuple(X.shape)}")


def _scratch(words: int, device) -> torch.Tensor:
    """G1's / G3's coefficient words, all ``SENTINEL``: the kernels' waits
    read them (csrc/givens.cu)."""
    return torch.full((words,), SENTINEL, dtype=torch.int64, device=device)


def abort_flag(device) -> torch.Tensor:
    """A cleared abort flag for G1 / G3 (one int32; a kernel only sets
    it)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def raise_on_abort(abort: torch.Tensor, name: str) -> None:
    """Raise if ``abort`` (read back: this waits for the kernels that hold
    it) says a coefficient wait timed out; their outputs then hold NaN."""
    if int(abort.item()):
        raise RuntimeError(f"{name}: a wait for a coefficient from another "
                           "CTA timed out; the outputs hold NaN")


def launch_fold_rows(lib, Raug: torch.Tensor, rows: torch.Tensor,
                     flag: torch.Tensor) -> int:
    """One G1 launch from the kernel library ``lib`` on checked CUDA
    tensors (k >= 1 rows), with :func:`fold_layout`'s slots; returns the C
    entry's CUDA error."""
    n, W = Raug.shape
    k = rows.shape[0]
    coef = _scratch(fold_words(n, k), Raug.device)
    return lib.mpbqr_givens_fold_rows(
        Raug.data_ptr(), rows.data_ptr(), n, W, k, coef.data_ptr(),
        flag.data_ptr(), fold_layout(n, W, k).slots, _stream(Raug))


def launch_hessenberg(lib, H: torch.Tensor, Qt: torch.Tensor,
                      flag: torch.Tensor,
                      layout: GivensLayout | None = None) -> int:
    """One G3 launch from the kernel library ``lib`` on checked CUDA
    tensors, with :func:`hessenberg_layout`'s layout unless one is given;
    returns the C entry's CUDA error."""
    m, nH = H.shape
    nQ = Qt.shape[1]
    lay = hessenberg_layout(m, nH, nQ) if layout is None else layout
    coef = _scratch(max(min(m - 1, nH), 1), H.device)
    return lib.mpbqr_givens_hessenberg(
        H.data_ptr(), nH, Qt.data_ptr(), nQ, m, coef.data_ptr(),
        flag.data_ptr(), lay.warps, _stream(H))


def check_launch(code: int, name: str) -> None:
    """Raise if a G1 / G3 C entry returned a CUDA error; a layout whose
    CTAs the card cannot keep resident together is named as such."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check

    if code == CUDA_COOPERATIVE_TOO_LARGE:
        raise RuntimeError(f"{name}: the layout's CTAs cannot all be "
                           "resident on this card (a cooperative launch)")
    check(code, name)


def givens_fold_rows(Raug: torch.Tensor, rows: torch.Tensor,
                     abort: torch.Tensor | None = None) -> torch.Tensor:
    """Fold the k rows of ``rows`` (k x W) into the n x W augmented upper
    triangular ``Raug`` (n <= W), in place: pivot i zeroes each row's entry i
    against ``Raug[i, i]``, row after row.  Returns ``Raug``.  On CUDA only
    the upper trapezoid (columns >= i of row i) is rotated: what lies left
    of the diagonal is the callers' to drop (``triu``); with ``abort`` None
    the call waits for the kernel and raises ``RuntimeError`` if one of its
    coefficient waits timed out, else the kernel sets ``abort`` and the
    caller reads it (:func:`raise_on_abort`)."""
    n, W = Raug.shape
    if rows.dim() != 2 or rows.shape[1] != W or n > W or n < 1:
        raise ValueError(f"givens_fold_rows: Raug {tuple(Raug.shape)} (n <= "
                         f"W) and rows {tuple(rows.shape)} (k x W)")
    if Raug.device.type == "cpu":
        givens_fold_rows_plain(Raug, rows)
        return Raug
    _require_cuda_f32(Raug, "Raug")
    _require_cuda_f32(rows, "rows")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    if rows.shape[0] == 0:
        return Raug
    flag = abort_flag(Raug.device) if abort is None else abort
    check_launch(launch_fold_rows(library(), Raug, rows, flag),
                 "givens_fold_rows")
    LAUNCHES["givens_fold_rows"] += 1
    if abort is None:
        raise_on_abort(flag, "givens_fold_rows")
    return Raug


def givens_chain(v: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor,
                 start: int = 0) -> torch.Tensor:
    """The bottom-up chain: for i = m-2 down to ``start``, ``(c, s) =
    givens_rotation(v[i], v[i+1])`` of the running vector (``v[i] <- c v[i]
    - s v[i+1]``), applied to rows (i, i+1) of X1 and X2 (m rows each), in
    place.  ``v`` (m,) is not changed; returns the rotated ``v[start]`` (a
    0-d tensor)."""
    m = v.shape[0] if v.dim() == 1 else 0
    if v.dim() != 1 or m < 1 or not 0 <= start < m:
        raise ValueError(f"givens_chain: v {tuple(v.shape)} must be a "
                         f"nonempty vector and 0 <= start < m, got {start}")
    _rows_match("X1", X1, m)
    _rows_match("X2", X2, m)
    if v.device.type == "cpu":
        return givens_chain_plain(v, X1, X2, start)
    for name, x in (("X1", X1), ("X2", X2)):
        _require_cuda_f32(x, name)
    if v.dtype != torch.float32 or not v.is_cuda or not v.is_contiguous():
        raise ValueError("v must be a contiguous float32 CUDA vector")
    if X1.shape[1] + X2.shape[1] < 1:
        raise ValueError("givens_chain needs at least one column")
    smem = chain_smem(m, start)
    if smem > SMEM_LIMIT:
        raise ValueError(f"givens_chain takes m - start <= "
                         f"{SMEM_LIMIT // 12} rows, got {m - start}")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check,
        library,
    )

    out = torch.empty((), dtype=torch.float32, device=v.device)
    check(library().mpbqr_givens_chain(
        v.data_ptr(), X1.data_ptr(), X1.shape[1], X2.data_ptr(), X2.shape[1],
        m, start, out.data_ptr(), smem, _stream(v)), "givens_chain")
    LAUNCHES["givens_chain"] += 1
    return out


def givens_hessenberg(H: torch.Tensor, Qt: torch.Tensor,
                      abort: torch.Tensor | None = None) -> None:
    """Re-triangularize the upper Hessenberg ``H`` (m x n), in place: for i
    = 0 .. min(m-1, n)-1, ``(c, s) = givens_rotation(H[i, i], H[i+1, i])``
    of the current H, applied to rows (i, i+1) of H and of ``Qt`` (m rows).
    On CUDA the entries of H below its diagonal are left as they are (the
    callers' ``triu`` drops them); ``abort`` as in
    :func:`givens_fold_rows`."""
    m = H.shape[0] if H.dim() == 2 else 0
    if H.dim() != 2 or m < 1:
        raise ValueError(f"givens_hessenberg: H must be 2-D, got "
                         f"{tuple(H.shape)}")
    _rows_match("Qt", Qt, m)
    if H.device.type == "cpu":
        givens_hessenberg_plain(H, Qt)
        return
    _require_cuda_f32(H, "H")
    _require_cuda_f32(Qt, "Qt")
    if H.shape[1] + Qt.shape[1] < 1:
        raise ValueError("givens_hessenberg needs at least one column")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    flag = abort_flag(H.device) if abort is None else abort
    check_launch(launch_hessenberg(library(), H, Qt, flag),
                 "givens_hessenberg")
    LAUNCHES["givens_hessenberg"] += 1
    if abort is None:
        raise_on_abort(flag, "givens_hessenberg")
