"""The layout rule of the panel products that K2, K3 and K5 issue
(``ops/kernels/ns.py::group_layout`` and ``tn_split``), the C entries that
take it, and the group probe's CPU-side pieces.  The kernels themselves
run only on the card (``chip_smoke.py`` phase 3, ``utils/group_probe.py``);
these rules are plain Python on shapes."""

import ctypes

import numpy as np
import pytest
import torch

from mixedprecisionblockqr_tpu_torch.ops.kernels import ns as tns
from mixedprecisionblockqr_tpu_torch.utils import group_probe


def _tn_ctas(M, N, split):
    return -(-M // tns.TN_TILE) * -(-N // tns.TN_TILE) * split


@pytest.mark.parametrize("m,r,split,chunk,bm_panel,gram_ctas,q_ctas", [
    (2048, 128, 8, 256, 16, 128, 128),   # the headline's group
    (4096, 128, 8, 512, 16, 128, 256),   # K3's RQRCP panels
    (16384, 128, 8, 2048, 64, 128, 256),  # 64-row tiles still give 256
    (2048, 64, 8, 256, 16, 32, 128),     # four tiles: the cluster caps it
    (2048, 32, 8, 256, 32, 8, 64),
    (130, 128, 2, 128, 16, 32, 9),       # short panels: one stage a chunk
    (100, 128, 1, 128, 16, 16, 7),
])
def test_group_layout_fills_the_card(m, r, split, chunk, bm_panel,
                                     gram_ctas, q_ctas):
    lay = tns.group_layout(m, r)
    assert (lay.split, lay.chunk, lay.bm_panel) == (split, chunk, bm_panel)
    assert lay.bm_wide == tns.NT_WIDE_BM and lay.bn == r
    assert _tn_ctas(r, r, lay.split) == gram_ctas
    assert -(-m // lay.bm_panel) == q_ctas
    # the C entry's check (csrc/panel.cuh::product_layout_ok)
    assert lay.chunk % tns.TN_STAGE == 0
    assert (lay.split - 1) * lay.chunk < m <= lay.split * lay.chunk
    assert lay.bm_panel in (tns.NT_SMALL_BM[r], tns.NT_WIDE_BM)


@pytest.mark.parametrize("M,N,K", [
    (128, 128, 2048), (128, 768, 2048), (1024, 1024, 2048), (1, 1, 1),
    (32, 32, 600), (96, 130, 4097), (128, 128, 64), (2000, 50, 129),
])
def test_tn_split_covers_k_with_no_empty_chunk(M, N, K):
    split, chunk = tns.tn_split(M, N, K)
    assert 1 <= split <= tns.TN_MAX_SPLIT
    assert chunk % tns.TN_STAGE == 0
    assert (split - 1) * chunk < K <= split * chunk
    if split < tns.TN_MAX_SPLIT and K >= 2 * split * tns.TN_STAGE:
        # it stopped doubling because the grid was full
        assert _tn_ctas(M, N, split) >= tns.TARGET_CTAS


@pytest.mark.parametrize("m,r", [(2048, 48), (2048, 256), (0, 128),
                                 (tns.MAX_ROWS + 1, 128)])
def test_group_layout_refuses_what_the_kernels_do_not_take(m, r):
    # Widths are no longer refused: 48 runs gemm_nt's 64-wide tile and the
    # chain on R = 64, 256 two 128-wide column blocks and the chain on the
    # L2 route.  Heights outside 1 .. MAX_ROWS still are.
    if 1 <= m <= tns.MAX_ROWS:
        lay = tns.group_layout(m, r)
        assert lay.bn == (64 if r == 48 else 128)
        assert lay.chain.route == ("smem" if r == 48 else "l2")
        return
    with pytest.raises(ValueError, match="panel products take"):
        tns.group_layout(m, r)


def test_tn_split_refuses_an_empty_product():
    with pytest.raises(ValueError, match="nonempty"):
        tns.tn_split(128, 0, 2048)


def test_group_entries_take_the_layout():
    # K2, K3 and K5 take the layout's ten numbers (the products' five, the
    # chain's five) before the stream (K5 its scrub's split and chunk
    # after them); the probe's product entry takes one product with its
    # layout.
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build._declare(Lib())
    ci, vp = ctypes.c_int, ctypes.c_void_p
    assert lib.mpbqr_bgs_group.argtypes[-11:] == [ci] * 10 + [vp]
    assert len(lib.mpbqr_bgs_group.argtypes) == 24
    assert lib.mpbqr_bgs_group_proj.argtypes[-13:] == [ci] * 12 + [vp]
    assert len(lib.mpbqr_panel_qr.argtypes) == 21
    assert len(lib.mpbqr_group_product.argtypes) == 18


def test_group_probe_needs_a_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert group_probe.main(["--serial", "--k5-seeds", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("with_prev", [False, True])
def test_group_probe_float64_reference_is_the_plain_algorithm(with_prev):
    # The probe's float64 block Gram-Schmidt (Cholesky QR per panel) is the
    # fp32 plain version's algorithm: on a well-conditioned group they
    # agree to fp32 rounding (2e-6 of unit-scale Q).
    rng = np.random.default_rng(3)
    P = torch.from_numpy(rng.random((256, 96), dtype=np.float32) - 0.5)
    Qprev = None
    if with_prev:
        Qprev = torch.linalg.qr(torch.from_numpy(
            rng.random((256, 32), dtype=np.float32) - 0.5))[0]
        Q = tns.bgs_group_fused_proj_plain(P, Qprev, 32, (12, 6, 10),
                                           (False,) * 3, bf16_dots=False)[0]
    else:
        Q = tns.bgs_group_fused_plain(P, 32, (12, 6, 10), (False,) * 3,
                                      bf16_dots=False)[0]
    Q64 = group_probe.group_f64(P, 32, Qprev)
    assert Q64.dtype == torch.float64
    assert float((Q.double() - Q64).abs().max()) < 2e-6
