"""The algebra of K6's column loop (``csrc/panel_factor.cu``: one cluster
exchange a column), mirrored in PyTorch on the CPU and held against the
JAX package's Pallas kernel in interpret mode and the port's plain
version.

The kernel splits the panel's rows over the CTAs of a cluster.  For column
j with live part x (alpha = x_j) and working rows A, the reflector is
w = x / |u|, u = alpha + sign(alpha) sigma, and

    w^T A_c = (sum over rows i > j of x_i A_ic + u A_jc) / |u|:

each CTA sums its rows below the pivot row, row j travels apart, and after
ONE combine every CTA forms sigma, u, |u| and every dot.  The partial dots
of column j + 1 are taken in the pass that applies column j's update.
:func:`onepass_factor` is that recurrence, row block by row block, in fp32;
the CUDA kernel itself runs only on the card (``chip_smoke.py`` phase 3).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu.ops.pallas import panel as jpanel
from mixedprecisionblockqr_tpu_torch.ops.kernels import panel as tpanel
from mixedprecisionblockqr_tpu_torch.utils import panel_probe

CSRC = (Path(tpanel.__file__).resolve().parents[2] / "csrc"
        / "panel_factor.cu")


def onepass_factor(P: torch.Tensor, rows: int):
    """K6's column loop on the m x w fp32 panel ``P`` with its rows split
    in blocks of ``rows`` (one block a CTA): ``(V, T, R)``.  Per column j
    the blocks' partial dots of rows i > j and row j are combined once;
    row by row, the reflector becomes column j's V (row j: R[j, j]) and
    column j + 1 takes the update (x'); one pass then updates the columns
    right of j + 1 and takes the blocks' partial dots of column j + 1
    (rows i > j + 1) against the updated columns (V's for k <= j)."""
    work = P.float().clone()
    m, w = work.shape
    blocks = [(r0, min(m, r0 + rows)) for r0 in range(0, m, rows)]
    betas = torch.zeros(w)
    vdiag = torch.zeros(w)
    G = torch.zeros((w, w))
    wv = torch.zeros(m)
    xv = work[:, 0].clone()

    def partials(j):
        # each block's dots of rows i > j with x' (xv), and row j apart
        c = torch.zeros((len(blocks), w))
        for b, (r0, r1) in enumerate(blocks):
            lo = max(r0, j + 1)
            if lo < r1:
                c[b] = (xv[lo:r1, None] * work[lo:r1]).sum(0)
        return c, work[j].clone()

    c, row = partials(0)
    for j in range(w):
        # the exchange: the blocks' sums in block order
        S = c[0].clone()
        for b in range(1, len(blocks)):
            S = S + c[b]
        tail2, alpha = S[j], row[j]
        sigma = torch.sqrt(alpha * alpha + tail2)
        u = alpha + (1.0 if alpha >= 0 else -1.0) * sigma
        unorm = torch.sqrt(u * u + tail2)
        live = bool(sigma > 1e-30)
        beta = 2.0 if live else 0.0
        s = S + u * row
        if live:
            d = s / unorm
        else:
            # w = 0: 0 * s keeps another column's NaN or inf, unless
            # column j itself is NaN, which reaches its own R[j, j] only
            d = 0.0 * s
            if math.isnan(float(sigma)):
                d = torch.where(torch.arange(w) == j, d, 0.0)
        betas[j] = beta
        vdiag[j] = u / unorm if live else 0.0
        G[:j, j] = d[:j]
        # the x' sub-pass over rows i >= j: column j's V and R[j, j],
        # column j + 1 after the update
        wl = (torch.cat([u.reshape(1), xv[j + 1:]]) / unorm if live
              else torch.zeros(m - j))
        wv[j:] = wl
        work[j, j] = alpha - beta * (wv[j] * d[j])
        work[j + 1:, j] = wv[j + 1:]
        if j + 1 < w:
            x = work[j:, j + 1] - beta * (wl * d[j + 1])
            work[j:, j + 1] = x
            xv[j:] = x
        # the fused pass: the update right of j + 1
        work[j:, j + 2:] -= beta * (wv[j:, None] * d[None, j + 2:])
        if j + 1 < w:
            c, row = partials(j + 1)
    rows_i = torch.arange(m)[:, None]
    cols = torch.arange(w)[None, :]
    R = torch.where(cols >= rows_i, work, 0.0)
    V = torch.where(cols < rows_i, work,
                    torch.where(cols == rows_i, vdiag[None, :], 0.0))
    T = torch.zeros((w, w))
    for j in range(w):
        T[:j, j] = -betas[j] * (T[:j, :j] @ G[:j, j])
        T[j, j] = betas[j]
    return V, T, R


def _close(t, j, atol):
    # atol of the entries' scale, max(1, max|x|), over the finite entries
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    keep = np.isfinite(j)
    scale = max(1.0, float(np.abs(j[keep]).max(initial=0.0)))
    np.testing.assert_allclose(t[keep], j[keep], atol=atol * scale)


def _panel(m, w, seed):
    return np.random.default_rng(seed).random((m, w), dtype=np.float32) - 0.5


def _check(P, rows):
    # V and T within 1e-5, R within 1e-4 of the entries' scale (the pair
    # tests/test_torch_panel_factor.py uses: fp32 summation order only),
    # against the JAX kernel and the port's plain version; NaNs in the
    # same places.
    Vo, To, Ro = onepass_factor(torch.from_numpy(P), rows)
    Vj, Tj, Rj = jpanel.panel_factor_fused(jnp.asarray(P), interpret=True)
    Vp, Tp, Rp = tpanel.panel_factor_fused_plain(torch.from_numpy(P))
    for ref in ((np.asarray(Vj), np.asarray(Tj), np.triu(np.asarray(Rj))),
                (Vp.numpy(), Tp.numpy(), np.triu(Rp.numpy()))):
        for got, want, tol in zip((Vo, To, Ro), ref, (1e-5, 1e-5, 1e-4)):
            np.testing.assert_array_equal(np.isnan(got.numpy()),
                                          np.isnan(want))
            _close(got.numpy(), want, tol)
    return Vo, To, Ro


@pytest.mark.parametrize("shape, rows", [
    ((64, 64), 64), ((64, 64), 5),      # one block; 13 blocks, pivot rows
    ((130, 17), 65), ((130, 17), 9),    # cross every block edge
    ((208, 48), 104), ((208, 48), 13),
])
def test_onepass_matches_jax_and_plain(shape, rows):
    _check(_panel(*shape, seed=30), rows)


def test_onepass_zero_column_is_finite_with_beta_zero():
    P = _panel(64, 16, seed=31)
    P[:, 5] = 0.0
    V, T, R = _check(P, 7)
    assert all(bool(torch.isfinite(x).all()) for x in (V, T, R))
    assert T[5, 5] == 0.0 and not V[:, 5].any()


@pytest.mark.parametrize("where", [(40, 3), (0, 0), (70, 0)])
def test_onepass_nan_reaches_r(where):
    # the blocked drivers' canary reads NaN in R: it survives the one
    # exchange a column in the places the JAX kernel leaves it
    P = _panel(96, 12, seed=32)
    P[where] = np.nan
    _, _, R = _check(P, 11)
    assert bool(torch.isnan(R).any())


def _kernel_body() -> str:
    src = CSRC.read_text()
    start = src.index("panel_factor_kernel(const float*")
    return src[start:src.index("\n}\n", start)]


def test_kernel_has_one_cluster_barrier_a_column():
    # one before the loop (every CTA running before any push), one a
    # column, one after the loop (G complete for the T build)
    body = _kernel_body()
    loop = body[body.index("for (int j = -1; j < w; ++j)"):
                body.index("R[o] = c >= i")]
    assert body.count("cluster.sync()") == 3
    assert loop.count("cluster.sync()") == 1
    assert loop.count("__syncthreads()") == 2


def test_fixed_floats_mirror_the_kernel():
    src = CSRC.read_text()
    expr = re.search(r"constexpr int kPfFixedFloats =([^;]*);", src)[1]
    consts = {"kPfMaxCluster": tpanel.MAX_CLUSTER, "kPfCols": 128,
              "kPfGroups": 4}
    for name, value in consts.items():
        expr = expr.replace(name, str(value))
    assert eval(" ".join(expr.split())) == tpanel._FIXED_FLOATS  # noqa: S307
    # 405 rows of 128 columns fit a CTA, 406 do not: 16 CTAs hold 6480
    assert tpanel._smem_bytes(128, 405, True) <= tpanel.SMEM_LIMIT
    assert tpanel._smem_bytes(128, 406, True) > tpanel.SMEM_LIMIT
    assert tpanel.panel_layout(6480, 128).in_smem
    assert not tpanel.panel_layout(6481, 128).in_smem


def test_probe_names_every_clock_slot():
    # utils/panel_probe.py's table names the slots the kernel's PROF(n)
    # marks, once each
    used = sorted({int(n) for n in re.findall(r"PROF\((\d)\)",
                                              _kernel_body())})
    assert sorted(panel_probe.PHASES.values()) == used == list(range(7))
