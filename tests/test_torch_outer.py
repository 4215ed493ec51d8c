"""The port's outer layer against the JAX package's: ``utils/logging.py``
(files byte for byte the reference's for the same records, the parsers'
results equal), ``utils/plotting.py`` (PNG files, and the markdown table
without matplotlib byte for byte the reference's) and
``models/precision_study.py`` (the ``fp16(cpu)`` and ``lapack_fp64`` rows
equal to the reference's, the ``bf16`` / ``fp32`` errors within 2x of its,
the same tables)."""

import builtins
import os

import numpy as np
import pytest

from mixedprecisionblockqr_tpu.models import precision_study as jstudy
from mixedprecisionblockqr_tpu.utils import logging as jlog
from mixedprecisionblockqr_tpu.utils import plotting as jplot
from mixedprecisionblockqr_tpu_torch.models import precision_study as tstudy
from mixedprecisionblockqr_tpu_torch.utils import logging as tlog
from mixedprecisionblockqr_tpu_torch.utils import plotting as tplot

RECORDS = [
    ("cpu_householder", 100, 50, 0.5, 1e9, 1e-6),
    ("cpu_householder", 100, 50, 0.7, 1e9, 2e-6),
    ("cpu_householder", 200, 50, 1.0, 2e9, 1.25e-6),
    ("gpu_block_fp32", 2048, 2048, 0.0029, 2.86e10, 2.42e-3),
]


def _write(mod, d):
    lg = mod.ResultsLogger(d)
    for rec in RECORDS:
        lg.write_csv(*rec)
    lg.write_jsonl("run", {"m": 8, "tflops": 1.5, "ts": 1.0})
    lg.write_jsonl("run", {"m": 16, "ok": True, "ts": 2.0})


def test_logging_files_byte_identical(tmp_path):
    _write(tlog, str(tmp_path / "port"))
    _write(jlog, str(tmp_path / "ref"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name
    assert tlog.CSV_HEADER == jlog.CSV_HEADER


def test_read_and_average_equal(tmp_path):
    _write(tlog, str(tmp_path))
    path = str(tmp_path / "cpu_householder.txt")
    with open(path, "a") as f:
        f.write("1,2,3\n")  # a short line: skipped by both
    recs = tlog.read_csv_log(path)
    assert recs == jlog.read_csv_log(path) and len(recs) == 3
    avg = tlog.average_by_rows(recs)
    assert avg == jlog.average_by_rows(recs)
    assert [a["rows"] for a in avg] == [100, 200]
    assert avg[0]["runtime"] == pytest.approx(0.6)


def test_jsonl_sets_ts(tmp_path):
    tlog.ResultsLogger(str(tmp_path)).write_jsonl("x", {"m": 1})
    import json

    rec = json.loads((tmp_path / "x.jsonl").read_text())
    assert rec["m"] == 1 and "ts" in rec


def test_plot_logs_writes_pngs(tmp_path):
    _write(tlog, str(tmp_path / "log"))
    logs = [str(tmp_path / "log" / f) for f in ("cpu_householder.txt",
                                                "gpu_block_fp32.txt")]
    written = tplot.plot_logs(logs, out_dir=str(tmp_path / "plots"))
    assert [os.path.basename(p) for p in written] == [
        "runtime.png", "gflops.png", "error.png"]
    assert all(os.path.getsize(p) > 0 for p in written)


def test_plot_logs_markdown_without_matplotlib(tmp_path, monkeypatch):
    _write(tlog, str(tmp_path / "a"))
    _write(tlog, str(tmp_path / "b"))
    # Two logs with one base name: the labels take their directories.
    logs = [str(tmp_path / d / "cpu_householder.txt") for d in ("a", "b")]
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    (got,) = tplot.plot_logs(logs, out_dir=str(tmp_path / "port"))
    (ref,) = jplot.plot_logs(logs, out_dir=str(tmp_path / "ref"))
    assert os.path.basename(got) == "summary.md"
    with open(got, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


@pytest.fixture(scope="module")
def studies():
    kw = dict(sizes=(64,), condition_numbers=(1e3, 1e6))
    return tstudy.run_study(device="cpu", **kw), jstudy.run_study(**kw)


def _rows(study, dtype):
    return [r for r in study["records"] if r["dtype"] == dtype]


@pytest.mark.parametrize("dtype", ["fp16(cpu)", "lapack_fp64"])
def test_study_numpy_rows_equal(studies, dtype):
    got, ref = (_rows(s, dtype) for s in studies)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert (g["n"], g["cond"], g["finite"]) == (r["n"], r["cond"],
                                                    r["finite"])
        np.testing.assert_array_equal(g["error"], r["error"])


def test_study_fp16_overflows_at_1e6(studies):
    got = _rows(studies[0], "fp16(cpu)")
    assert got[0]["finite"] and not got[1]["finite"]


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_study_block_qr_rows_within_2x(studies, dtype):
    got, ref = (_rows(s, dtype) for s in studies)
    assert [g["cond"] for g in got] == [r["cond"] for r in ref]
    for g, r in zip(got, ref):
        assert g["finite"] and g["error"] <= 2.0 * r["error"], (g, r)


def test_study_tables(studies, tmp_path):
    got = tstudy.to_markdown(studies[0])
    ref = jstudy.to_markdown(studies[0])
    for name in ("error.md", "duration.md"):
        table = [line for line in got[name].splitlines()
                 if line.startswith("|")]
        assert table == [line for line in ref[name].splitlines()
                         if line.startswith("|")]
    assert "| 64 | 1e+06 |" in got["error.md"] and "NaN" in got["error.md"]
    paths = tstudy.write_study(str(tmp_path), sizes=(32,),
                               condition_numbers=(1e3,), block_size=16,
                               device="cpu")
    assert [os.path.basename(p) for p in paths] == ["error.md",
                                                    "duration.md"]


def test_fp16_qr_bit_for_bit():
    a = (np.random.default_rng(0).random((24, 12)) * 400.0).astype(np.float32)
    for got, ref in zip(tstudy._qr_numpy_fp16(a), jstudy._qr_numpy_fp16(a)):
        assert got.dtype == ref.dtype == np.float16
        np.testing.assert_array_equal(got, ref)


def test_study_needs_cuda_or_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstudy.run_study(sizes=(8,), condition_numbers=(1e3,))
