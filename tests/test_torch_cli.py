"""The port's command-line interface (``mixedprecisionblockqr_tpu_torch.cli``)
with ``--platform cpu``, in-process, at small shapes: the cases of
``tests/test_cli.py`` through the port's ``main``, with the exit codes the
reference CLI gives on the same arguments (its error exit 2 paths and the
JSON keys of ``bench`` / ``tsqr-bench`` checked against a run of the JAX
package's ``main``), the device-tagged log names, the refusal without CUDA
and without ``--platform cpu``, and one ``python -m`` run."""

import json
import os
import subprocess
import sys

import pytest
import torch

from mixedprecisionblockqr_tpu.cli import main as jmain
from mixedprecisionblockqr_tpu_torch.cli import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(args):
    return tmain(["--platform", "cpu", *args])


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_cli_dataset_qr_solve_plot(tmp_path):
    d = str(tmp_path)
    assert main(["dataset", "--out", f"{d}/jac", "--sizes", "64x32,48x24"]) == 0
    assert os.path.exists(f"{d}/jac/A_000000100.txt")
    assert main(["qr", "--m", "96", "--n", "64", "--block-size", "32",
                 "--policy", "fp32", "--log-dir", f"{d}/log"]) == 0
    assert main(["qr", "--file", f"{d}/jac/A_000000100.txt", "--block-size",
                 "16", "--log-dir", f"{d}/log"]) == 0
    assert main(["solve", "--m", "128", "--n", "48", "--block-size", "16",
                 "--log-dir", f"{d}/log"]) == 0
    # The device tag starts the log name where the JAX package writes tpu_.
    assert sorted(os.listdir(f"{d}/log")) == ["cpu_block_fp32.txt",
                                              "cpu_block_mixed.txt"]
    assert main(["plot", f"{d}/log/cpu_block_fp32.txt", "--out",
                 f"{d}/p"]) == 0
    assert os.listdir(f"{d}/p")


def test_cli_qr_conditioned(tmp_path):
    assert main(["qr", "--n", "64", "--cond", "1000", "--block-size", "16",
                 "--policy", "fp32", "--panel-method", "cholqr2s",
                 "--log-dir", str(tmp_path)]) == 0


def test_cli_cond_refuses_rectangle(tmp_path):
    args = ["qr", "--m", "96", "--n", "64", "--cond", "1000",
            "--log-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="square") as got:
        main(args)
    with pytest.raises(SystemExit) as ref:
        jmain(args)
    assert str(got.value) == str(ref.value)


def test_cli_suite_quick(tmp_path, capsys):
    assert main(["suite", "--quick", "--max-jacobians", "0",
                 "--log-dir", str(tmp_path)]) == 0
    assert "suite complete, 0 failures" in capsys.readouterr().out


def test_cli_dist(tmp_path):
    assert main(["dist", "--m", "128", "--n", "64", "--block-size", "16",
                 "--policy", "fp32", "--log-dir", str(tmp_path)]) == 0


def test_cli_bench_matches_public_dispatch(tmp_path, capsys):
    """bgs1 at a size it does not divide falls back through the shared
    resolver; the printed keys are the reference CLI's."""
    args = ["bench", "--sizes", "96", "--iters", "2", "--panel-method",
            "bgs1", "--policy", "fp32", "--log-dir", str(tmp_path)]
    assert main(args) == 0
    (got,) = _json_lines(capsys.readouterr().out)
    assert got["m"] == 96 and got["criteria_ok"] is True
    assert jmain(args) == 0
    (ref,) = _json_lines(capsys.readouterr().out)
    assert list(got) == list(ref)


def test_cli_bench_scan_fallback(tmp_path, capsys):
    assert main(["bench", "--sizes", "64", "--iters", "2", "--block-size",
                 "64", "--loop-mode", "scan", "--policy", "fp32",
                 "--log-dir", str(tmp_path)]) == 0
    assert '"criteria_ok": true' in capsys.readouterr().out


def test_cli_dist_bgs_and_rejection(tmp_path, capsys):
    assert main(["dist", "--m", "256", "--n", "64", "--block-size", "32",
                 "--policy", "fp32", "--panel-method", "bgs",
                 "--log-dir", str(tmp_path)]) == 0
    bad = ["dist", "--m", "128", "--n", "64", "--block-size", "16",
           "--panel-method", "polar", "--log-dir", str(tmp_path)]
    assert main(bad) == 2 == jmain(bad)
    assert "polar" in capsys.readouterr().err


def test_cli_dist_quality_conflict(tmp_path, capsys):
    bad = ["dist", "--m", "128", "--n", "64", "--block-size", "16",
           "--panel-method", "bgs", "--quality", "fast",
           "--log-dir", str(tmp_path)]
    assert main(bad) == 2 == jmain(bad)
    assert "--quality" in capsys.readouterr().err


def test_cli_dist_auto_leaf_selection(tmp_path):
    assert main(["dist", "--m", "128", "--n", "96", "--block-size", "16",
                 "--policy", "fp32", "--log-dir", str(tmp_path)]) == 0


def test_cli_dist_auto_large_nb_takes_grouped_bgs2_scan(tmp_path, capsys):
    assert main(["dist", "--m", "1024", "--n", "1024", "--block-size", "16",
                 "--policy", "fp32", "--log-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "panel_method=bgs2" in out and "loop_mode=scan" in out, out
    assert "devices=1 mesh={'rows': 1}" in out


def test_cli_dist_explicit_bgs2(tmp_path):
    assert main(["dist", "--m", "256", "--n", "128", "--block-size", "16",
                 "--policy", "fp32", "--panel-method", "bgs2",
                 "--loop-mode", "scan", "--log-dir", str(tmp_path)]) == 0


def test_cli_dist_joins_started_group(tmp_path, capsys):
    """Inside a started process group ``dist`` runs there and leaves the
    group up; by itself it starts and destroys a one-rank group."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        assert main(["dist", "--m", "128", "--n", "64", "--block-size", "16",
                     "--policy", "fp32", "--log-dir", str(tmp_path)]) == 0
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_cli_tsqr_bench(capsys):
    args = ["tsqr-bench", "--m", "2048", "--n", "32", "--leaves", "4",
            "--iters", "2"]
    assert main(args) == 0
    (got,) = _json_lines(capsys.readouterr().out)
    assert got["backward_error"] < 1e-5
    assert jmain(args) == 0
    (ref,) = _json_lines(capsys.readouterr().out)
    assert list(got) == list(ref)


def test_cli_precision_study(tmp_path, capsys):
    assert main(["precision-study", "--sizes", "32", "--conds", "1e3",
                 "--block-size", "16", "--out", str(tmp_path / "ps")]) == 0
    written = capsys.readouterr().out.strip().splitlines()
    assert written and all(os.path.exists(p) for p in written)


def test_cli_suite_resume_skips_done(tmp_path, capsys):
    d = str(tmp_path)
    assert main(["suite", "--quick", "--max-jacobians", "0",
                 "--log-dir", d]) == 0
    first = capsys.readouterr().out
    assert "suite complete, 0 failures" in first
    assert main(["suite", "--quick", "--max-jacobians", "0", "--resume",
                 "--log-dir", d]) == 0
    second = capsys.readouterr().out
    assert "suite complete, 0 failures" in second
    assert second.count("cpu_block_fp32") < first.count("cpu_block_fp32")


def test_cli_dist_quality_flag(tmp_path, capsys):
    assert main(["dist", "--m", "256", "--n", "256", "--block-size", "32",
                 "--policy", "fp32", "--quality", "balanced",
                 "--log-dir", str(tmp_path)]) == 0
    assert "panel_method=bgs2" in capsys.readouterr().out


def test_cli_qr_pivoted(tmp_path, capsys):
    d = str(tmp_path)
    assert main(["qr", "--n", "64", "--block-size", "16", "--pivoted",
                 "exact", "--log-dir", f"{d}/log"]) == 0
    assert main(["qr", "--n", "512", "--block-size", "128", "--pivoted",
                 "rqrcp", "--log-dir", f"{d}/log"]) == 0
    out = _json_lines(capsys.readouterr().out)
    assert [o["rank"] for o in out] == [64, 512]
    assert "cpu_pivoted_rqrcp.txt" in os.listdir(f"{d}/log")


@pytest.mark.parametrize("cmd", ["qr", "bench", "suite", "solve", "dist",
                                 "tsqr-bench", "precision-study"])
def test_cli_needs_cuda_or_platform_cpu(monkeypatch, capsys, tmp_path, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmain([cmd]) == 2
    assert "--platform cpu" in capsys.readouterr().err
    assert tmain(["--platform", "gpu", cmd]) == 2


def test_python_m_runs_the_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run(
        [sys.executable, "-m", "mixedprecisionblockqr_tpu_torch",
         "--platform", "cpu", "qr", "--n", "64", "--block-size", "16",
         "--policy", "fp32", "--log-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "Error Criteria: True" in run.stdout


def test_cli_dist_under_torchrun_env(tmp_path, monkeypatch):
    """With torchrun's variables set, ``dist`` starts its group from the
    environment (here one gloo rank on a localhost store) and ends it."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(port))):
        monkeypatch.setenv(key, value)
    assert main(["dist", "--m", "128", "--n", "64", "--block-size", "16",
                 "--policy", "fp32", "--log-dir", str(tmp_path)]) == 0
    assert not dist.is_initialized()
