"""The port's Givens QR and streaming updates (``ops/givens.py``, the plain
versions of ``ops/kernels/givens.py``) against the JAX package on the CPU,
the cases of ``tests/test_givens.py``: the same numpy inputs, fp32 on both
sides, the same rotation convention and order, so Q and R agree within
1e-5 relative (Frobenius); plus the reference's quality checks, the
guards, the launch counters and the C entries' argument types."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixedprecisionblockqr_tpu_torch as pt
from mixedprecisionblockqr_tpu.ops import givens as jg
from mixedprecisionblockqr_tpu_torch.ops import metrics as tmetrics
from mixedprecisionblockqr_tpu_torch.ops.kernels import givens as kg
from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import LAUNCHES

RTOL = 1e-5
GIVENS = ("givens_fold_rows", "givens_chain", "givens_hessenberg")


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return (np.linalg.norm(np.asarray(t, np.float64) - j)
            / max(np.linalg.norm(j), 1e-30))


def _same(t_out, j_out):
    for t, j in zip(t_out, j_out):
        assert tuple(t.shape) == tuple(np.shape(j))
        assert _rel(t, j) <= RTOL


def _complete_qr(a):
    Q, R = np.linalg.qr(a.astype(np.float64), mode="complete")
    return Q.astype(np.float32), R.astype(np.float32)


def _check_factors(a_new, Q, R, rtol=2e-5):
    """The reference test's check (tests/test_givens.py::_check_factors)."""
    Q, R = np.asarray(Q, np.float64), np.asarray(R, np.float64)
    m = Q.shape[0]
    assert np.max(np.abs(Q.T @ Q - np.eye(m))) < rtol
    assert np.allclose(np.tril(R[: R.shape[1], :], -1), 0.0)
    scale = max(np.linalg.norm(a_new), 1e-30)
    assert np.linalg.norm(a_new - Q @ R) / scale < rtol
    Rn = np.linalg.qr(a_new, mode="r")
    k = min(a_new.shape)
    np.testing.assert_allclose(
        np.abs(np.diag(R)[:k]), np.abs(np.diag(Rn)[:k]), rtol=1e-4,
        atol=rtol * (np.abs(Rn).max() + 1),
    )


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("a,b", [(3.0, 4.0), (-2.0, 0.5), (0.0, 0.0),
                                 (-1.5, 0.0), (0.0, -2.0)])
def test_givens_rotation_matches_jax(a, b):
    c, s = kg.givens_rotation(torch.tensor(a), torch.tensor(b))
    cj, sj = jg.givens_rotation(jnp.float32(a), jnp.float32(b))
    assert float(c) == float(cj) and float(s) == float(sj)
    if a == b == 0.0:
        assert (float(c), float(s)) == (1.0, 0.0)
    G = np.array([[float(c), -float(s)], [float(s), float(c)]])
    np.testing.assert_allclose(G @ [a, b], [np.hypot(a, b), 0.0],
                               atol=1e-6)


@pytest.mark.parametrize("loop_mode", ["unroll", "scan"])
@pytest.mark.parametrize("shape", [(8, 8), (16, 8), (7, 5), (12, 12),
                                   (5, 9)])
def test_givens_qr_matches_jax(shape, loop_mode):
    A = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    k = min(shape)
    for mode in ("reduced", "complete"):
        Q, R = pt.givens_qr(_t(A), mode=mode, loop_mode=loop_mode)
        _same((Q, R), jg.givens_qr(A, mode=mode, loop_mode=loop_mode))
    Q, R = pt.givens_qr(_t(A), mode="reduced", loop_mode=loop_mode)
    assert Q.shape == (shape[0], k) and R.shape == (k, shape[1])
    np.testing.assert_allclose((Q @ R).numpy(), A, atol=1e-5)
    assert float((Q.T @ Q - torch.eye(k)).abs().max()) < 1e-5
    assert bool((torch.tril(R, -1) == 0).all())


def test_givens_qr_complete_criteria():
    A = np.random.default_rng(3).standard_normal((24, 16)).astype(np.float32)
    Q, R = pt.givens_qr(_t(A), mode="complete")
    rep = tmetrics.evaluate(_t(A), Q, R, precision_bits=23)
    assert rep.all_ok, str(rep)


def test_givens_qr_validates_modes():
    A = _t(np.ones((4, 3)))
    with pytest.raises(ValueError, match="unknown loop_mode"):
        pt.givens_qr(A, loop_mode="fast")
    with pytest.raises(ValueError, match="unknown mode"):
        pt.givens_qr(A, mode="r")


@pytest.mark.parametrize("shape", [(12, 8), (16, 16), (8, 20)])
def test_qr_rank1_update_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    A = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal(shape[0]).astype(np.float32)
    v = rng.standard_normal(shape[1]).astype(np.float32)
    Qj, Rj = (np.asarray(x) for x in jg.givens_qr(A, mode="complete"))
    Q2, R2 = pt.qr_rank1_update(_t(Qj), _t(Rj), _t(u), _t(v))
    _same((Q2, R2), jg.qr_rank1_update(Qj, Rj, u, v))
    rep = tmetrics.evaluate(_t(A + np.outer(u, v)), Q2, R2,
                            precision_bits=23)
    assert rep.all_ok, str(rep)
    assert bool((torch.tril(R2, -1) == 0).all())
    # Downdating with -u round-trips.
    Q3, R3 = pt.qr_rank1_update(Q2, R2, _t(-u), _t(v))
    np.testing.assert_allclose((Q3 @ R3).numpy(), A, atol=1e-4)


def test_qr_append_row_matches_jax():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((20, 8)).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32)
    a_new = rng.standard_normal(8).astype(np.float32)
    beta = np.float32(0.7)
    Q, R = jg.givens_qr(A, mode="reduced")
    R8 = np.asarray(R)[:8]
    qtb = np.asarray(Q).T @ b
    R2, qtb2 = pt.qr_append_row(_t(R8), _t(a_new), qtb=_t(qtb), beta=beta)
    _same((R2, qtb2), jg.qr_append_row(R8, a_new, qtb=qtb, beta=beta))
    # The stacked system's least-squares solution, and the R-only form.
    A2 = np.vstack([A, a_new]).astype(np.float64)
    x_ref = np.linalg.lstsq(A2, np.append(b, beta).astype(np.float64),
                            rcond=None)[0]
    np.testing.assert_allclose(np.linalg.solve(R2.numpy(), qtb2.numpy()),
                               x_ref, atol=1e-4)
    R3 = pt.qr_append_row(_t(R8), _t(a_new))
    np.testing.assert_allclose(R3.numpy(), R2.numpy(), atol=1e-6)
    # A multi-column Q^T b and a beta per column.
    qtbm = np.stack([qtb, 2 * qtb], axis=1)
    betas = np.array([0.7, -1.0], np.float32)
    _same(pt.qr_append_row(_t(R8), _t(a_new), qtb=_t(qtbm), beta=_t(betas)),
          jg.qr_append_row(R8, a_new, qtb=qtbm, beta=betas))


@pytest.mark.parametrize("k", [0, 7, 19])
def test_qr_delete_col_matches_jax(k):
    a = np.random.default_rng(20 + k).standard_normal((32, 20)).astype(
        np.float32)
    Q, R = _complete_qr(a)
    out = pt.qr_delete_col(_t(Q), _t(R), k)
    _same(out, jg.qr_delete_col(Q, R, k))
    _check_factors(np.delete(a, k, axis=1), *out)


@pytest.mark.parametrize("k", [0, 9, 20])
def test_qr_insert_col_matches_jax(k):
    rng = np.random.default_rng(40 + k)
    a = rng.standard_normal((32, 20)).astype(np.float32)
    u = rng.standard_normal(32).astype(np.float32)
    Q, R = _complete_qr(a)
    out = pt.qr_insert_col(_t(Q), _t(R), k, _t(u))
    _same(out, jg.qr_insert_col(Q, R, k, u))
    _check_factors(np.insert(a, k, u, axis=1), *out)


@pytest.mark.parametrize("k", [0, 13, 31])
def test_qr_delete_row_matches_jax(k):
    a = np.random.default_rng(60 + k).standard_normal((32, 20)).astype(
        np.float32)
    Q, R = _complete_qr(a)
    out = pt.qr_delete_row(_t(Q), _t(R), k)
    assert out[0].shape == (31, 31) and out[1].shape == (31, 20)
    _same(out, jg.qr_delete_row(Q, R, k))
    _check_factors(np.delete(a, k, axis=0), *out)


def test_qr_insert_then_delete_col_roundtrip():
    rng = np.random.default_rng(80)
    a = rng.standard_normal((24, 12)).astype(np.float32)
    u = rng.standard_normal(24).astype(np.float32)
    Q, R = _complete_qr(a)
    Qi, Ri = pt.qr_insert_col(_t(Q), _t(R), 5, _t(u))
    Qd, Rd = pt.qr_delete_col(Qi, Ri, 5)
    _same((Qd, Rd), jg.qr_delete_col(*jg.qr_insert_col(Q, R, 5, u), 5))
    _check_factors(a, Qd, Rd)


def _error(fn, *args):
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


def test_guards_raise_as_the_reference_does():
    a = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    Q, R = _complete_qr(a)
    Qr, Rr = (np.asarray(x) for x in jg.givens_qr(
        np.random.default_rng(0).standard_normal((10, 4)).astype(
            np.float32), mode="reduced"))
    cases = [
        ("qr_rank1_update", (Qr, np.zeros((10, 4), np.float32),
                             np.zeros(10, np.float32),
                             np.zeros(4, np.float32))),
        ("qr_insert_col", (Q, R, 0, np.ones(8, np.float32))),
        ("qr_delete_col", (Q[:, :4], R, 0)),
        ("qr_delete_row", (Q[:1, :1], R[:1, :1], 0)),
        ("qr_append_row", (R[:, :4], np.ones(8, np.float32))),
    ]
    for name, args in cases:
        want = _error(getattr(jg, name), *args)
        got = _error(getattr(pt, name), *(
            _t(x) if isinstance(x, np.ndarray) else x for x in args))
        assert got == want, (name, got, want)


def test_cpu_calls_launch_no_kernel():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((12, 6)).astype(np.float32)
    Q, R = _complete_qr(a)
    before = dict(LAUNCHES)
    pt.qr_rank1_update(_t(Q), _t(R), _t(rng.standard_normal(12)),
                       _t(rng.standard_normal(6)))
    pt.qr_delete_col(_t(Q), _t(R), 2)
    pt.qr_insert_col(_t(Q), _t(R), 2, _t(rng.standard_normal(12)))
    pt.qr_delete_row(_t(Q), _t(R), 3)
    pt.qr_append_row(_t(R[:6]), _t(rng.standard_normal(6)))
    assert dict(LAUNCHES) == before
    assert all(LAUNCHES[k] == before[k] for k in GIVENS)


def test_updates_leave_their_inputs_alone():
    rng = np.random.default_rng(2)
    Q, R = _complete_qr(rng.standard_normal((10, 6)).astype(np.float32))
    Qt, Rt = _t(Q), _t(R)
    pt.qr_rank1_update(Qt, Rt, _t(rng.standard_normal(10)),
                       _t(rng.standard_normal(6)))
    pt.qr_delete_row(Qt, Rt, 4)
    assert torch.equal(Qt, _t(Q)) and torch.equal(Rt, _t(R))


def test_c_entries_argtypes():
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    lib = _build._declare(Lib())
    ci, vp = ctypes.c_int, ctypes.c_void_p
    # Raug, rows, n, W, k, coefficient words, abort flag, slots, stream
    assert lib.mpbqr_givens_fold_rows.argtypes == [vp, vp] + [ci] * 3 + [
        vp] * 2 + [ci, vp]
    # v, X1, n1, X2, n2, m, start, vout, smem, stream
    assert lib.mpbqr_givens_chain.argtypes == [vp, vp, ci, vp, ci, ci, ci,
                                               vp, ci, vp]
    # H, nH, Qt, nQ, m, coefficient words, abort flag, warps, stream
    assert lib.mpbqr_givens_hessenberg.argtypes == [vp, ci, vp, ci, ci, vp,
                                                    vp, ci, vp]
    assert "givens.cu" in _build.SOURCES


def test_scratch_sizes():
    # G1: (n + 16) diagonals of 16 words for each block of 16 rows.
    assert kg.fold_words(2048, 16) == 2064 * 16
    assert kg.fold_words(2048, 17) == 2 * 2064 * 16
    assert kg.fold_words(256, 1) == 272 * 16
    coef, abort = kg._scratch(5, "cpu"), kg.abort_flag("cpu")
    assert coef.shape == (5,) and coef.dtype == torch.int64
    assert bool((coef == -1).all())
    assert abort.dtype == torch.int32 and int(abort) == 0
    # G2: the vector and two coefficients a rotation in shared memory.
    assert kg.chain_smem(2048, 0) == (2048 + 2 * 2047) * 4
    assert kg.chain_smem(8, 7) == (1 + 2) * 4


def test_abort_flag_raises():
    kg.raise_on_abort(kg.abort_flag("cpu"), "G3")
    with pytest.raises(RuntimeError, match="qr_rank1_update: a wait"):
        kg.raise_on_abort(torch.ones(1, dtype=torch.int32),
                          "qr_rank1_update")


def test_calls_on_the_cpu_take_no_abort_flag():
    from mixedprecisionblockqr_tpu_torch.ops import givens as og

    assert og.abort_flag_for(torch.zeros(2)) is None
    og.check_abort(None, "qr_rank1_update")


def test_wrappers_check_shapes():
    with pytest.raises(ValueError, match="givens_fold_rows"):
        kg.givens_fold_rows(torch.zeros(4, 3), torch.zeros(1, 3))
    with pytest.raises(ValueError, match="rows"):
        kg.givens_chain(torch.zeros(4), torch.zeros(3, 2), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="rows"):
        kg.givens_hessenberg(torch.zeros(4, 2), torch.zeros(3, 3))


def test_kernel_constants_match_the_source():
    import re
    from pathlib import Path

    src = (Path(kg.__file__).resolve().parents[2] / "csrc" /
           "givens.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))

    assert const("kSlots") == kg.FOLD_SLOTS
    assert const("kChainThreads") - 32 == kg.CHAIN_COLS
    assert const("kHessMaxWarps") == kg.HESS_MAX_WARPS
    # FoldShape<NS>: SPW = NS < a ? NS : a slots a warp, NW = NS / SPW
    # warps; the C entry's warps the same.
    spw = int(re.search(r"SPW = NS < (\d+) \? NS : \1;", src).group(1))
    assert kg.FOLD_WARPS == {ns: max(ns // spw, 1) for ns in kg.FOLD_WARPS}
    assert "const int warps = slots > 4 ? slots / 4 : 1;" in src
    # The clock build's slots, as utils/givens_probe.py names them.
    from mixedprecisionblockqr_tpu_torch.utils import givens_probe as gp

    names = {"make": "kGpMake", "hand_on": "kGpHand",
             "wait_cta": "kGpWaitCta", "apply": "kGpApply",
             "barrier": "kGpBarrier", "wait_warp": "kGpWaitWarp"}
    assert {k: const(v) for k, v in names.items()} == gp.PHASE_SLOTS
    assert (const("kGpSteps"), const("kGpFollow"), const("kGpTotal"),
            const("kGpWarps"), const("kGpSlots"), const("kGpFirst"),
            const("kGpLast")) == (
        gp.STEPS_SLOT, gp.FOLLOW, gp.TOTAL_SLOT, gp.PROF_WARPS,
        gp.PROF_SLOTS, gp.FIRST_SLOT, gp.LAST_SLOT)


def test_phase3_folds_reach_every_row_slot_layout():
    import re
    from pathlib import Path

    from mixedprecisionblockqr_tpu_torch.utils import givens_probe

    src = (Path(kg.__file__).resolve().parents[2] / "csrc" /
           "givens.cu").read_text()
    layouts = sorted({int(x) for x in
                      re.findall(r"fold_rows_kernel<(\d+)>", src)})
    assert layouts == [1, 2, 4, 8, 16] == sorted(kg.FOLD_WARPS)
    # The rule takes the fewest slots that hold min(k, 16) rows.
    shapes = (givens_probe.PHASE3_SHAPES["fold"]
              + givens_probe.MAIN_SHAPES["fold"])
    lays = [kg.fold_layout(n, n + nb, k) for n, nb, k in shapes]
    assert [lay.slots for lay in lays] == [
        min(ns for ns in layouts if ns >= min(k, kg.FOLD_SLOTS))
        for _, _, k in shapes]
    assert {lay.slots for lay in lays} == set(layouts)
    # Each layout also runs on more than one CTA, where a CTA waits on
    # coefficients of an earlier CTA; 20 rows run two blocks.
    assert {lay.slots for lay in lays if lay.ctas > 1} == set(layouts)
    assert any(k > kg.FOLD_SLOTS for _, _, k in shapes)


@pytest.mark.parametrize("argv", [["--main"], ["--phases"],
                                  ["--main", "--layouts", "--phases"]])
def test_probe_needs_a_device(monkeypatch, capsys, argv):
    from mixedprecisionblockqr_tpu_torch.utils import givens_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert givens_probe.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_phase3_hessenberg_shapes_reach_every_g3_case():
    from mixedprecisionblockqr_tpu_torch.utils import givens_probe

    shapes = (givens_probe.PHASE3_SHAPES["hessenberg"]
              + givens_probe.MAIN_SHAPES["hessenberg"])
    cases = set()
    for m, n in shapes:
        lay = kg.hessenberg_layout(m, n, m)
        per_cta = 32 * lay.warps
        assert lay.ctas * per_cta >= n + m > (lay.ctas - 1) * per_cta
        cases.add("tall" if m - 1 > n else "square")
        # H's columns on more than one CTA: the front crosses a CTA
        # boundary through global memory; a CTA holding both H and Q^T.
        if n > per_cta:
            cases.add("h_crosses_ctas")
        if n % per_cta:
            cases.add("h_and_qt_in_one_cta")
    assert cases == {"tall", "square", "h_crosses_ctas",
                     "h_and_qt_in_one_cta"}


@pytest.mark.parametrize("slots", [1, 2, 4, 8, 16])
def test_fold_layout_rule(slots):
    # k rows that take `slots` slots, on widths from one group of 32
    # columns to rls_update's 2049: a CTA per 32 columns, four slots a warp.
    k = slots if slots < 16 else 19
    for W in (5, 32, 257, 1101, 2049):
        lay = kg.fold_layout(W - 1, W, k)
        assert lay == kg.GivensLayout(-(-W // 32), max(slots // 4, 1), slots)
        assert lay.total_warps == lay.ctas * lay.warps


def test_hessenberg_layout_rule():
    assert kg.hessenberg_layout(2048, 2048, 2048) == kg.GivensLayout(
        128 // kg.HESS_WARPS, kg.HESS_WARPS)
    assert kg.hessenberg_layout(300, 120, 300) == kg.GivensLayout(
        -(-14 // kg.HESS_WARPS), kg.HESS_WARPS)
    assert kg.hessenberg_layout(2048, 2048, 2048, 8) == kg.GivensLayout(
        16, 8)
    assert kg.hessenberg_layout(2, 1, 2) == kg.GivensLayout(1, 1)
    with pytest.raises(ValueError, match="warps a CTA"):
        kg.hessenberg_layout(64, 64, 64, kg.HESS_MAX_WARPS + 1)


def test_phase_summary_reads_the_clocks():
    import numpy as np

    from mixedprecisionblockqr_tpu_torch.utils import givens_probe as gp

    prof = np.zeros((gp.PROF_WARPS, gp.PROF_SLOTS), np.int64)
    # Warp 0 made 4 coefficients (make 400, apply 200 cycles); warp 1
    # followed 4 steps (waits 300, apply 100); warp 2 is not in the launch.
    prof[0, [gp.PHASE_SLOTS["make"], gp.PHASE_SLOTS["apply"],
             gp.STEPS_SLOT, gp.TOTAL_SLOT]] = [400, 200, 4, 700]
    prof[1, [gp.FOLLOW + gp.PHASE_SLOTS["wait_warp"],
             gp.FOLLOW + gp.PHASE_SLOTS["apply"],
             gp.FOLLOW + gp.STEPS_SLOT, gp.TOTAL_SLOT]] = [300, 100, 4, 500]
    prof[2, gp.TOTAL_SLOT] = 10 ** 9
    prof[0, [gp.FIRST_SLOT, gp.LAST_SLOT]] = [5000, 9000]
    out = gp.phase_summary(prof, 2, 1000.0)
    assert out["kernel_us"] == 0.7
    assert out["front"]["warp_steps"] == 4
    assert out["front"]["cycles_per_step"]["make"] == 100
    assert out["front"]["shares"]["make"] == pytest.approx(2 / 3)
    assert out["follower"]["shares"]["wait_warp"] == 0.75
    assert out["follower"]["cycles_per_step"]["apply"] == 25
    # One front warp, from 5 to 9 us of the global timer.
    assert out["front_timeline_us"] == {
        "front_warps": 1, "first_to_last": 4.0, "in_front_warps": 4.0,
        "between_front_warps": 0.0, "largest_gap": 0.0}
