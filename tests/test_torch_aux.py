"""The port's metrics and command line (numpywren_tpu_torch.metrics, .cli,
.__main__) on the CPU: level_report and info against the JAX package's on
the same inputs, and the port's own rules: device= on FlopMeter and on
info/doctor, trace that lets the traced code's exception through, the
doctor's reporting, bench's delegation to bench_torch.py.

Small sizes (96, tile 32); each case takes seconds."""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import numpywren_tpu as jnpw
import numpywren_tpu_torch as npw
from numpywren_tpu import cli as jcli
from numpywren_tpu import metrics as jmetrics
from numpywren_tpu.matrix_init import random_spd
from numpywren_tpu_torch import cli, metrics
from numpywren_tpu_torch.parallel.mesh import _factor_2d

ROOT = Path(__file__).resolve().parent.parent
CHECKS = ("tiled store round-trip", "device matmul kernel", "fused cholesky program",
          "models (svd + least squares)")
METER_KEYS = {"label", "wall_s", "flops", "tflops_per_s"}


@pytest.fixture(scope="module")
def local_program():
    """The port's local-executor Cholesky of random_spd(96, seed=2) on the
    host tier, and the JAX package's, both run."""
    a = random_spd(96, seed=2)
    prog, _, _ = npw.cholesky(a, tile=(32, 32), storage="host", device="cpu")
    assert npw.run_program(prog, executor="local").name == "SUCCESS"
    jprog, _, _ = jnpw.cholesky(a, tile=(32, 32), storage="host")
    assert jnpw.run_program(jprog, executor="local").name == "SUCCESS"
    return prog, jprog


def test_level_report_matches_jax(local_program):
    prog, jprog = local_program
    recs, jrecs = metrics.level_report(prog), jmetrics.level_report(jprog)
    assert len(recs) == len(jrecs) == len(prog.levels)
    for r, jr in zip(recs, jrecs):
        assert {k: r[k] for k in ("level", "nodes", "ops", "flops")} == \
            {k: jr[k] for k in ("level", "nodes", "ops", "flops")}
        assert r["wall_s"] >= 0 and "tflops_per_s" in r
    assert sum(sum(r["ops"].values()) for r in recs) == prog.num_nodes
    assert sum(r["flops"] for r in recs) == sum(prog.node_flops(i) for i in range(prog.num_nodes))


def test_log_program_one_step_line_a_level(local_program, caplog):
    prog, _ = local_program
    with caplog.at_level(logging.INFO, logger="numpywren_tpu_torch"):
        metrics.log_program(prog)
    steps = [json.loads(r.getMessage()[len("npw-step "):]) for r in caplog.records
             if r.name == "numpywren_tpu_torch" and r.getMessage().startswith("npw-step ")]
    assert len(steps) == len(prog.levels)
    assert steps == metrics.level_report(prog)


def test_info_matches_jax_keys(capsys):
    assert jcli.main(["info"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert cli.main(["info", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(ref) - {"hbm_bytes_limit", "hbm_bytes_in_use"}
    assert got["backend"] == ref["backend"] == "cpu"
    assert all(set(d) == set(ref["devices"][0]) for d in got["devices"])
    assert tuple(got["default_mesh"]) == _factor_2d(len(got["devices"]))


def _meter_records(caplog):
    return [json.loads(r.getMessage()[len("npw-meter "):]) for r in caplog.records
            if r.name == "numpywren_tpu_torch" and r.getMessage().startswith("npw-meter ")]


def test_flop_meter_on_the_cpu(caplog):
    x = torch.ones(64, 64)
    with caplog.at_level(logging.INFO, logger="numpywren_tpu_torch"):
        with metrics.FlopMeter(flops=2 * 64 ** 3, label="mm", device="cpu") as m:
            x @ x
    assert m.wall_s > 0 and m.tflops == pytest.approx(2 * 64 ** 3 / m.wall_s / 1e12)
    (rec,) = _meter_records(caplog)
    assert set(rec) == METER_KEYS and rec["label"] == "mm" and rec["wall_s"] == m.wall_s


def test_flop_meter_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        metrics.FlopMeter(flops=1e9)


def test_flop_meter_propagates_and_logs(caplog):
    with caplog.at_level(logging.INFO, logger="numpywren_tpu_torch"):
        with pytest.raises(ValueError, match="in the body"):
            with metrics.FlopMeter(flops=1e9, label="t", device="cpu") as m:
                raise ValueError("in the body")
    assert m.wall_s is not None and [r["label"] for r in _meter_records(caplog)] == ["t"]


def test_trace_none_is_a_noop(tmp_path):
    before = set(os.listdir(tmp_path))
    with metrics.trace(None):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert set(os.listdir(tmp_path)) == before


def test_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "prof"
    with metrics.trace(str(out)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(out.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::mm" in names


def test_trace_propagates_the_body_exception(tmp_path):
    with pytest.raises(ValueError, match="in the body"):
        with metrics.trace(str(tmp_path / "prof")):
            raise ValueError("in the body")
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json"))) == 1


def test_doctor_on_the_cpu(capsys):
    assert cli.main(["doctor", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [f"ok   {name}" for name in CHECKS]


def test_doctor_reports_a_failing_check(monkeypatch, capsys):
    import importlib

    def broken(*args, **kw):
        raise RuntimeError("injected")

    monkeypatch.setattr(importlib.import_module("numpywren_tpu_torch.ops.gemm"), "matmul", broken)
    assert cli.main(["doctor", "--device", "cpu"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "FAIL device matmul kernel: RuntimeError('injected')"
    assert [ln for i, ln in enumerate(lines) if i != 1] == \
        [f"ok   {name}" for name in CHECKS if name != "device matmul kernel"]


@pytest.mark.parametrize("cmd", ["info", "doctor"])
def test_no_card_without_device_cpu(cmd, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([cmd]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device: pass device='cpu'" in out.err


def _spawned(monkeypatch):
    started = []
    popen = subprocess.Popen

    def record(args, *a, **kw):
        started.append(list(args))
        return popen(args, *a, **kw)

    monkeypatch.setattr(subprocess, "Popen", record)
    return started


def test_bench_without_bench_torch(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(cli, "BENCH", str(tmp_path / "bench_torch.py"))
    started = _spawned(monkeypatch)
    assert cli.main(["bench", "--alg", "gemm"]) == 1
    assert "bench_torch.py not found" in capsys.readouterr().err
    assert not any("bench.py" in str(arg) for args in started for arg in args)


def test_bench_delegates_to_bench_torch(monkeypatch, tmp_path):
    bench = tmp_path / "bench_torch.py"
    bench.write_text("import json, pathlib, sys\n"
                     "pathlib.Path(sys.argv[0]).with_suffix('.argv').write_text("
                     "json.dumps(sys.argv[1:]))\n"
                     "sys.exit(3)\n")
    monkeypatch.setattr(cli, "BENCH", str(bench))
    started = _spawned(monkeypatch)
    assert cli.main(["bench", "--alg", "gemm", "--n", "256"]) == 3
    assert json.loads(bench.with_suffix(".argv").read_text()) == ["--alg", "gemm", "--n", "256"]
    assert started == [[sys.executable, str(bench), "--alg", "gemm", "--n", "256"]]


def test_python_m_info_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m", "numpywren_tpu_torch",
                           "info", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout)["backend"] == "cpu"
    imported = {ln.rsplit("|", 1)[1].strip() for ln in proc.stderr.splitlines()
                if ln.startswith("import time:")}
    assert "numpywren_tpu_torch.cli" in imported
    assert not {m.split(".")[0] for m in imported} & {"jax", "jaxlib", "numpywren_tpu"}
