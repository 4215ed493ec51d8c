"""Fused Householder panel factorization: ``panel_factor_fused`` (K6)
beside its plain PyTorch version.

Port of ``mixedprecisionblockqr_tpu/ops/pallas/panel.py``.  Both return
``(V (m x w), T (w x w), R (m x w))`` with ``Q_panel = I - V T V^T`` and
``R = Q_panel^T panel``, the semantics of ``ops/householder.py::
panel_factor``: unit-norm reflectors with beta = 2, sign +1 when
``alpha >= 0``, beta = 0 for a column whose live norm is at most 1e-30.
Below its diagonal R holds rounding residue (plain version) or exact zeros
(the CUDA kernel); callers keep the upper triangle.  A NaN in the panel
survives into R, which the blocked QR tiers' NaN canary reads.

On the card any fp32 panel with ``1 <= w <= m`` is taken.  Up to
``MAX_WIDTH`` (128) columns the kernel runs as one launch of one
thread-block cluster laid out by :func:`panel_layout`.  Wider panels take
the wide route (``csrc/panel_factor.cu::mpbqr_panel_factor_wide``): one C
entry that factors sub-panels of ``WIDE_SUB`` columns by that same launch
and joins them with the true-fp32 products of ``csrc/panel.cuh`` (the
trailing update ``C -= Vk (Tk^T (Vk^T C))`` and T's merge ``T[:c, c:e] =
-T[:c, :c] (V[:, :c]^T Vk) Tk``), laid out by :func:`wide_layout`;
:func:`panel_factor_wide_plain` is the schedule's plain mirror.

A batch of B panels of one shape (the TSQR / CAQR leaves and tree levels,
which the JAX package factors under ``jax.vmap``) is
:func:`panel_factor_fused_batched`: ONE launch of the same kernel over a
grid of B clusters laid out by :func:`batched_layout` (above 128 columns
the wide route over the batch, one K6 launch a sub-panel,
:func:`wide_batched_layout`); :func:`panel_factor_fused_batched_plain` is
its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
    BATCH_LAUNCHES,
    BATCH_MEMBERS,
    LAUNCHES,
    NT_SMALL_BM,
    NT_WIDE_BM,
    TARGET_CTAS,
    WIDE_LAUNCHES,
    _require_cuda_f32,
    _stream,
    tn_split,
)
from mixedprecisionblockqr_tpu_torch.ops.policy import mm_f32

_TINY = 1e-30
#: Widest panel one launch of the CUDA kernel takes; wider panels take the
#: wide route.
MAX_WIDTH = 128
#: Columns of a sub-panel of the wide route.  The main path always uses
#: it; only utils/panel_probe.py passes another width (64, to time beside
#: it).
WIDE_SUB = 128
#: Most CTAs of the kernel's thread-block cluster (a non-portable size).
MAX_CLUSTER = 16
#: Rows per CTA the layout aims at (utils/panel_probe.py compares others).
ROWS_TARGET = 128
#: Shared memory one CTA may use on an H100 (bytes).
SMEM_LIMIT = 232448
#: Floats of shared memory before the per-row vectors and the rows, as
#: csrc/panel_factor.cu carves them (kPfFixedFloats): the pushed partial
#: dots [2][16][128], pivot rows [2][128] and the next two columns' partial
#: sums [2][16][2] (two copies each, by column parity), the row groups'
#: dots [4][128], the CTA's pivot row, the update's scaled dots, beta and
#: V's diagonal [128] each.
_FIXED_FLOATS = 2 * 16 * 128 + 2 * 128 + 4 * 16 + 4 * 128 + 4 * 128


class PanelLayout(NamedTuple):
    """How the kernel splits an m x w panel over its cluster."""
    cluster: int      # CTAs, one row block each
    rows: int         # rows per CTA (the last may hold fewer)
    in_smem: bool     # rows in shared memory, else in place in R
    smem_bytes: int   # dynamic shared memory per CTA


#: The clusters of a layout the card keeps resident at once (the card's
#: count: :func:`card_resident`; the CPU tests pass a table).
Resident = Callable[[PanelLayout], int]


def _smem_bytes(w: int, rows: int, in_smem: bool) -> int:
    """The kernel's carve-out: the fixed floats, two vectors of ``rows``
    entries (the reflector and the next column, each padded to 4) and a
    region that holds the rows (when ``in_smem``) and, after the column
    loop, the w x w G."""
    held = rows * w if in_smem else 0
    return 4 * (_FIXED_FLOATS + 2 * ((rows + 3) // 4 * 4) + max(held, w * w))


@functools.lru_cache(maxsize=None)
def panel_layout(m: int, w: int, max_cluster: int = MAX_CLUSTER,
                 rows_target: int = ROWS_TARGET) -> PanelLayout:
    """The kernel's layout for an m x w panel on a card that places
    clusters of up to ``max_cluster`` CTAs: ``ceil(m / rows_target)`` CTAs
    (1 to ``max_cluster``), more while a CTA's ``ceil(m / cluster)`` rows
    do not fit its shared memory; the rows in shared memory when they fit
    ``SMEM_LIMIT`` (405 rows at w = 128, so 16 CTAs hold 6480), else the
    in-place route on ``max_cluster`` CTAs.  A rule on shapes alone: it
    needs no device."""
    if not (1 <= w <= MAX_WIDTH and m >= w and 1 <= max_cluster
            <= MAX_CLUSTER):
        raise ValueError(
            f"panel_layout takes m x w with 1 <= w <= {MAX_WIDTH}, m >= w "
            f"and 1 <= max_cluster <= {MAX_CLUSTER}; got {m} x {w}, "
            f"max_cluster={max_cluster}")
    cluster = min(max_cluster, max(1, -(-m // rows_target)))
    while (cluster < max_cluster
           and _smem_bytes(w, -(-m // cluster), True) > SMEM_LIMIT):
        cluster += 1
    rows = -(-m // cluster)
    in_smem = _smem_bytes(w, rows, True) <= SMEM_LIMIT
    return PanelLayout(cluster, rows, in_smem, _smem_bytes(w, rows, in_smem))


def fewest_layout(m: int, w: int, max_cluster: int = MAX_CLUSTER
                  ) -> PanelLayout:
    """The fewest CTAs (up to ``max_cluster``) whose ``ceil(m / cluster)``
    rows each fit ``SMEM_LIMIT``, in shared memory; :func:`panel_layout`'s
    in-place layout when not even ``max_cluster`` CTAs hold the rows.  The
    other candidate of :func:`batched_layout`."""
    lay = panel_layout(m, w, max_cluster)
    for cluster in range(1, lay.cluster + 1):
        rows = -(-m // cluster)
        if _smem_bytes(w, rows, True) <= SMEM_LIMIT:
            return PanelLayout(cluster, rows, True,
                               _smem_bytes(w, rows, True))
    return lay


def waves(B: int, lay: PanelLayout, resident: Resident) -> int:
    """The waves a batch of B clusters of ``lay`` runs in: B over the
    clusters the card keeps resident at once, rounded up."""
    return -(-B // resident(lay))


@functools.lru_cache(maxsize=None)
def batched_layout(B: int, m: int, w: int,
                   resident: Optional[Resident] = None,
                   max_cluster: int = MAX_CLUSTER) -> PanelLayout:
    """One layout for every member of a batch of B m x w panels (one
    cluster a member).  The candidates hold the rows in shared memory on
    ``panel_layout``'s cluster (128 rows a CTA) down to
    :func:`fewest_layout`'s; of them the one whose B clusters run in the
    fewest :func:`waves` by ``resident`` (the card places a cluster inside
    one GPC, so it keeps 7 of 16, 13 or 11 CTAs resident on an H100, not
    132 / 16), then the most CTAs a member within that wave count.
    Reasons: a wave runs after the one before it, and within a wave a
    member's serial column loop is shorter the more CTAs share its rows.
    At B = 1, and for a shape whose rows fit shared memory nowhere, it is
    ``panel_layout``, and ``resident`` is not asked.  Raises
    ``ValueError`` for B < 1, for B > 1 without ``resident``, or for a
    shape ``panel_layout`` refuses."""
    if B < 1:
        raise ValueError(f"batched_layout takes B >= 1 panels, got {B}")
    lay = panel_layout(m, w, max_cluster)
    if B == 1 or not lay.in_smem:
        return lay
    if resident is None:
        raise ValueError("batched_layout of B > 1 panels needs the card's "
                         "resident cluster counts (card_resident)")
    best, best_waves = lay, waves(B, lay, resident)
    for cluster in range(lay.cluster - 1,
                         fewest_layout(m, w, max_cluster).cluster - 1, -1):
        rows = -(-m // cluster)
        cand = PanelLayout(cluster, rows, True, _smem_bytes(w, rows, True))
        n = waves(B, cand, resident)
        if n < best_waves:
            best, best_waves = cand, n
    return best


class WideStep(NamedTuple):
    """One sub-panel ``[c, e)`` of the wide route and its launches' layouts
    (zeros where a product does not run: no trailing columns when
    ``e == w``, no T merge when ``c == 0``)."""
    cols: Tuple[int, int]    # the sub-panel's columns [c, e)
    panel: PanelLayout       # K6 on the (m - c) x (e - c) sub-panel
    update: Tuple[int, ...]  # Y = Vk^T C, Z = Tk^T Y: (split, chunk) each;
    #                          C -= Vk Z: (bm, bn)
    merge: Tuple[int, ...]   # X = V^T Vk: (split, chunk); Y2 = T X and
    #                          T[:c, c:e] -= Y2 Tk: (bm, bn) each

    def args(self) -> tuple:
        """The 16 integers of the step in the C entry's plan."""
        p = self.panel
        return (p.cluster, p.rows, int(p.in_smem), p.smem_bytes,
                *self.update, *self.merge)

    def products(self) -> int:
        """Product launches of the step, whatever the batch."""
        return 3 * bool(self.update[0]) + 3 * bool(self.merge[0])


class WideLayout(NamedTuple):
    """How the wide route runs an m x w panel."""
    sub: int                      # columns of a sub-panel (the last fewer)
    steps: Tuple[WideStep, ...]

    def products(self) -> int:
        """Product launches of the whole route, whatever the batch."""
        return sum(step.products() for step in self.steps)


def _nt_tiles(M: int, N: int, members: int = 1) -> Tuple[int, int]:
    """gemm_nt's ``(bm, bn)`` for an M x N output in the wide route, in one
    launch for ``members`` such products: the column tile of the smallest
    of 32, 64, 128 that holds N (128 above), and NT_WIDE_BM rows per CTA
    when the members' tiles at that still number TARGET_CTAS, else the
    small row tile of that bn."""
    bn = 32 if N <= 32 else 64 if N <= 64 else 128
    tiles = members * -(-M // NT_WIDE_BM) * -(-N // bn)
    return (NT_WIDE_BM if tiles >= TARGET_CTAS else NT_SMALL_BM[bn]), bn


def wide_layout(m: int, w: int, max_cluster: int = MAX_CLUSTER,
                sub: int = WIDE_SUB) -> WideLayout:
    """The wide route's layout for one m x w panel:
    :func:`wide_batched_layout` at B = 1."""
    return wide_batched_layout(1, m, w, None, max_cluster, sub)


@functools.lru_cache(maxsize=None)
def wide_batched_layout(B: int, m: int, w: int,
                        resident: Optional[Resident] = None,
                        max_cluster: int = MAX_CLUSTER,
                        sub: int = WIDE_SUB) -> WideLayout:
    """The wide route's layout for B m x w panels: sub-panels ``[c, e)`` of
    ``sub`` columns covering w (the last narrower when ``sub`` does not
    divide w), each factored by one K6 launch over the batch with
    :func:`batched_layout` of B, ``resident`` and its ``(m - c) x (e - c)``
    shape (:func:`panel_layout`'s at B = 1).  Each product is one launch
    for the B members, laid out by the B members' output tiles together:
    the trailing update's two gemm_tn with :func:`~ns.tn_split` of their
    shapes (``b x (w - e)`` over ``m - c`` rows, then over ``b``) and its
    gemm_nt with :func:`_nt_tiles` of ``(m - c) x (w - e)``; T's merge with
    the split of ``c x b`` over ``m - c`` rows and the tiles of its two
    ``c x b`` products.  At B = 1 a rule on shapes alone.  ``sub`` is a
    probe's argument: the wrappers always lay out at ``WIDE_SUB``.  Raises
    ``ValueError`` unless ``B >= 1``, ``1 <= w <= m`` and ``1 <= sub <=
    MAX_WIDTH``, or as :func:`batched_layout` does."""
    if not (B >= 1 and 1 <= w <= m and 1 <= sub <= MAX_WIDTH):
        raise ValueError(
            f"wide_layout / wide_batched_layout takes B >= 1 panels of m x "
            f"w with 1 <= w <= m and 1 <= sub <= {MAX_WIDTH}; got B={B}, "
            f"{m} x {w}, sub={sub}")
    steps = []
    for c in range(0, w, sub):
        e = min(w, c + sub)
        b, mk, n2 = e - c, m - c, w - e
        update = ((*tn_split(b, n2, mk, B), *tn_split(b, n2, b, B),
                   *_nt_tiles(mk, n2, B)) if n2 else (0,) * 6)
        merge = ((*tn_split(c, b, mk, B), *_nt_tiles(c, b, B),
                  *_nt_tiles(c, b, B)) if c else (0,) * 6)
        steps.append(WideStep((c, e), batched_layout(B, mk, b, resident,
                                                     max_cluster),
                              update, merge))
    return WideLayout(sub, tuple(steps))


def panel_factor_fused_plain(panel: torch.Tensor):
    """Plain version of :func:`panel_factor_fused` (``_panel_kernel``
    transcription: masked full-height column steps, the rank-1 update on
    every column, T built column by column)."""
    P = panel.float().clone()
    m, r = P.shape
    dev = P.device
    rows = torch.arange(m, device=dev)[:, None]
    cols_r = torch.arange(r, device=dev)[:, None]
    V = torch.zeros_like(P)
    T = torch.zeros((r, r), dtype=torch.float32, device=dev)
    for j in range(r):
        x = P[:, j:j + 1]
        xm = torch.where(rows >= j, x, 0.0)
        sigma = torch.sqrt((xm * xm).sum())
        alpha = torch.where(rows == j, x, 0.0).sum()
        sign = torch.where(alpha >= 0, 1.0, -1.0)
        u = xm + sign * sigma * (rows == j).float()
        unorm = torch.sqrt((u * u).sum())
        live = sigma > _TINY
        w = torch.where(live, u / torch.where(live, unorm, 1.0), 0.0)
        beta = torch.where(live, 2.0, 0.0)
        P = P - beta * (w * mm_f32(w.T, P))
        tcol = -beta * mm_f32(T, mm_f32(V.T, w))
        tcol = torch.where(cols_r < j, tcol, 0.0)
        T[:, j:j + 1] = torch.where(cols_r == j, beta, tcol)
        V[:, j:j + 1] = w
    return V, T, P


def panel_factor_fused_batched_plain(panels: torch.Tensor):
    """Plain version of :func:`panel_factor_fused_batched`:
    :func:`panel_factor_fused_plain` of each member of the (B, m, w)
    stack, stacked: ``(V (B, m, w), T (B, w, w), R (B, m, w))``."""
    outs = [panel_factor_fused_plain(p) for p in panels]
    return tuple(torch.stack(x) for x in zip(*outs))


def panel_factor_wide_plain(panel: torch.Tensor, sub: int = WIDE_SUB):
    """Plain mirror of the wide route's schedule: sub-panels of ``sub``
    columns by :func:`panel_factor_fused_plain`, each followed by the
    trailing update ``C -= Vk (Tk^T (Vk^T C))`` and T's merge ``T[:c, c:e]
    = -T[:c, :c] (V[c:, :c]^T Vk) Tk``, in fp32.  R is exact zeros below
    its diagonal, as the CUDA route writes it.  The tests hold the blocked
    algebra against the JAX kernel with it; no path of the package calls
    it."""
    R = panel.float().clone()
    m, w = R.shape
    V = torch.zeros_like(R)
    T = torch.zeros((w, w), dtype=torch.float32, device=R.device)
    for c in range(0, w, sub):
        e = min(w, c + sub)
        Vk, Tk, Rk = panel_factor_fused_plain(R[c:, c:e])
        R[c:, c:e] = torch.triu(Rk)
        V[c:, c:e] = Vk
        T[c:e, c:e] = Tk
        if e < w:
            C = R[c:, e:]
            R[c:, e:] = C - mm_f32(Vk, mm_f32(Tk.T, mm_f32(Vk.T, C)))
        if c:
            T[:c, c:e] = -mm_f32(mm_f32(T[:c, :c], mm_f32(V[c:, :c].T, Vk)),
                                 Tk)
    return V, T, R


def panel_factor_fused(panel: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Householder column loop of one m x w panel.

    Returns ``(V, T, R)`` as in the module docstring.  On CUDA the panel
    must be a contiguous fp32 tensor with ``1 <= w <= m``; any height the
    device's memory holds is taken (rows beyond what the cluster's shared
    memory holds are worked on in place in R).  Up to ``MAX_WIDTH`` columns
    it is one launch with :func:`panel_layout`'s layout, wider panels the
    wide route with :func:`wide_layout`'s, both for the largest cluster the
    card places (:func:`max_cluster`) and chosen before the launch.  Each
    K6 launch counts in ``LAUNCHES["panel_factor_fused"]``; a wide call
    counts in ``WIDE_LAUNCHES`` too (the call and its product launches).
    """
    if panel.device.type == "cpu":
        return panel_factor_fused_plain(panel)
    _require_cuda_f32(panel, "panel")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    m, w = panel.shape
    if w > MAX_WIDTH:
        # wide_layout raises ValueError for a shape the route does not take.
        lay = wide_layout(m, w, max_cluster(panel.device))
        out = _launch_wide(library(), panel, lay)
        LAUNCHES["panel_factor_fused"] += len(lay.steps)
        WIDE_LAUNCHES["calls"] += 1
        WIDE_LAUNCHES["products"] += lay.products()
        return out
    # panel_layout raises ValueError for a shape the kernel does not take.
    lay = panel_layout(m, w, max_cluster(panel.device))
    out = _launch(library(), panel, lay)
    LAUNCHES["panel_factor_fused"] += 1
    return out


def panel_factor_fused_batched(panels: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The Householder column loop of each of B m x w panels.

    ``panels`` is (B, m, w); returns ``V (B, m, w)``, ``T (B, w, w)`` and
    ``R (B, m, w)``, member by member as :func:`panel_factor_fused` gives
    them.  On the CPU it runs :func:`panel_factor_fused_batched_plain`.  On
    CUDA the stack must be a contiguous fp32 tensor with ``1 <= w <= m``
    and B >= 1: up to ``MAX_WIDTH`` columns it is ONE launch over the batch
    with :func:`batched_layout`'s layout, wider panels the wide route over
    the batch (one K6 launch a sub-panel) with :func:`wide_batched_layout`'s;
    a shape the entries refuse raises, with no loop of single launches in
    its place.  Each K6 launch counts in ``LAUNCHES["panel_factor_fused"]``
    and ``BATCH_LAUNCHES``, the B panels in ``BATCH_MEMBERS``; a wide call
    counts once in ``WIDE_LAUNCHES["calls"]`` and its product launches
    (each over the B members) in ``WIDE_LAUNCHES["products"]``.  The
    layouts read the card's resident cluster counts (:func:`card_resident`);
    a failed query raises.
    """
    if panels.device.type == "cpu":
        return panel_factor_fused_batched_plain(panels)
    if not panels.is_cuda:
        raise ValueError(
            f"panels must be a CPU or CUDA tensor, got {panels.device}")
    if (panels.dtype != torch.float32 or panels.dim() != 3
            or not panels.is_contiguous()):
        raise ValueError(
            "panels must be a contiguous 3-D (B, m, w) float32 tensor, got "
            f"{panels.dtype} {tuple(panels.shape)} "
            f"contiguous={panels.is_contiguous()}")
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import library

    B, m, w = panels.shape
    dev = panels.device
    if w > MAX_WIDTH:
        # wide_batched_layout raises ValueError for a shape it does not take.
        lay = wide_batched_layout(B, m, w, card_resident(dev),
                                  max_cluster(dev))
        out = _launch_wide(library(), panels, lay)
        launches = len(lay.steps)
        WIDE_LAUNCHES["calls"] += 1
        WIDE_LAUNCHES["products"] += lay.products()
    else:
        # batched_layout raises ValueError for a shape it does not take.
        lay = batched_layout(B, m, w, card_resident(dev), max_cluster(dev))
        out = _launch(library(), panels, lay)
        launches = 1
    LAUNCHES["panel_factor_fused"] += launches
    BATCH_LAUNCHES["panel_factor_fused"] += launches
    BATCH_MEMBERS["panel_factor_fused"] += B
    return out


@functools.lru_cache(maxsize=None)
def max_cluster(device: torch.device) -> int:
    """The largest cluster (at most ``MAX_CLUSTER`` CTAs) of which the card
    can place one at ``SMEM_LIMIT`` bytes of shared memory per CTA, the
    most any layout uses (``cudaOccupancyMaxActiveClusters``, asked once
    per device).  Raises when not even one CTA fits."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        check(library().mpbqr_panel_factor_max_cluster(
            SMEM_LIMIT, ctypes.byref(out)), "panel_factor_fused max_cluster")
    if out.value < 1:
        raise RuntimeError("panel_factor_fused: the card places no CTA with "
                           f"{SMEM_LIMIT} bytes of shared memory")
    return out.value


def resident_clusters(device: torch.device, lay: PanelLayout) -> int:
    """How many clusters of the layout ``lay`` the card of ``device`` keeps
    resident at once (``cudaOccupancyMaxActiveClusters``): a batch of B
    runs in ``ceil(B / resident_clusters)`` waves.  Raises when the query
    fails or the card places not even one."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import (
        check, library,
    )

    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        check(library().mpbqr_panel_factor_resident(
            lay.cluster, int(lay.in_smem), lay.smem_bytes,
            ctypes.byref(out)), "panel_factor_fused resident clusters")
    if out.value < 1:
        raise RuntimeError(f"panel_factor_fused: the card keeps no cluster "
                           f"of {lay} resident")
    return out.value


@functools.lru_cache(maxsize=None)
def card_resident(device: torch.device) -> Resident:
    """:func:`resident_clusters` of the card of ``device`` as the layouts
    take it, one object per device (so the layouts' caches hold) that asks
    the card once per layout."""
    return functools.lru_cache(maxsize=None)(
        functools.partial(resident_clusters, device))


def _launch(lib, panel: torch.Tensor, lay: PanelLayout):
    """One launch from the kernel library ``lib`` with the layout ``lay``:
    ``mpbqr_panel_factor`` for one (m, w) panel, ``mpbqr_panel_factor_
    batched`` for a (B, m, w) stack; counts nothing.  Returns ``(V, T,
    R)``, with the stack's leading B for a stack."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check

    *batch, m, w = panel.shape
    V = torch.empty_like(panel)
    T = torch.empty((*batch, w, w), dtype=torch.float32, device=panel.device)
    G = torch.empty((*batch, w, w), dtype=torch.float32, device=panel.device)
    R = torch.empty_like(panel)
    ptrs = (panel.data_ptr(), V.data_ptr(), T.data_ptr(), G.data_ptr(),
            R.data_ptr())
    args = (m, w, lay.cluster, lay.rows, int(lay.in_smem), lay.smem_bytes,
            _stream(panel))
    if batch:
        code = lib.mpbqr_panel_factor_batched(*ptrs, batch[0], *args)
    else:
        code = lib.mpbqr_panel_factor(*ptrs, *args)
    check(code, "panel_factor_fused")
    return V, T, R


def _launch_wide(lib, panel: torch.Tensor, lay: WideLayout):
    """One call of the wide route from the kernel library ``lib`` with the
    layout ``lay``: ``mpbqr_panel_factor_wide`` for one (m, w) panel,
    ``mpbqr_panel_factor_wide_batched`` for a (B, m, w) stack; counts
    nothing.  Returns ``(V, T, R)``, with the stack's leading B for a
    stack."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels._build import check

    *batch, m, w = panel.shape
    V = torch.empty_like(panel)
    T = torch.empty((*batch, w, w), dtype=torch.float32, device=panel.device)
    R = torch.empty_like(panel)
    floats = (lib.mpbqr_panel_factor_wide_batched_scratch_floats(
        batch[0], m, w, lay.sub) if batch
        else lib.mpbqr_panel_factor_wide_scratch_floats(m, w, lay.sub))
    scratch = torch.empty(floats, dtype=torch.float32, device=panel.device)
    ints = [x for step in lay.steps for x in step.args()]
    plan = (ctypes.c_int * len(ints))(*ints)
    ptrs = (panel.data_ptr(), V.data_ptr(), T.data_ptr(), R.data_ptr(),
            scratch.data_ptr())
    tail = (m, w, lay.sub, plan, len(lay.steps), _stream(panel))
    if batch:
        code = lib.mpbqr_panel_factor_wide_batched(*ptrs, batch[0], *tail)
    else:
        code = lib.mpbqr_panel_factor_wide(*ptrs, *tail)
    check(code, "panel_factor_fused (wide route)")
    return V, T, R
