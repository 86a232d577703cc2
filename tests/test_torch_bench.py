"""bench_torch.py, the port's benchmark harness, on the CPU (--device cpu).

Its stdout contract, as tests/test_bench_robustness.py pins bench.py's: a
parseable line from the first moment, the budget's exit, a measured line
superseding the provisional one. Without a card and without --device cpu
it measures nothing. Each bench function runs beside bench.py's on JAX's
CPU at the same arguments: the same extra keys, flop count and metric
name, the errors within their bars in both. Then the operands and the
streamed residual, the numerics ladder against the reference's
fused_tsqr and singular_values, last-good, and the command line.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench  # noqa: E402  (the reference's harness)
import bench_torch  # noqa: E402

import numpywren_tpu_torch as npw  # noqa: E402
from numpywren_tpu_torch import cli  # noqa: E402
from numpywren_tpu_torch.trapezoid import _trapezoid_chol_fn  # noqa: E402

BENCH = os.path.join(REPO, "bench_torch.py")
CPU = torch.device("cpu")

FAKE_LASTGOOD = {
    "metric": "cholesky_n65536_float32_compensated_tflops",
    "value": 56.4, "unit": "TFLOP/s", "vs_baseline": 1.266,
    "device": "NVIDIA H100 80GB HBM3",
}


def _env(tmp_path, **extra):
    lg = tmp_path / "lastgood.json"
    lg.write_text(json.dumps(FAKE_LASTGOOD))
    env = dict(os.environ)
    env.pop("NPW_COMPENSATED", None)
    env.update({"NPW_BENCH_LASTGOOD": str(lg),
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    env.update(extra)
    return env


def _read_json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.strip().startswith("{")]


# ---------------------------------------------------------------------------
# The stdout contract (tests/test_bench_robustness.py's cases)
# ---------------------------------------------------------------------------

def test_sigkill_leaves_parseable_line(tmp_path):
    """Killed the moment its first line is out, before it measures
    anything: that line is the provisional last-good one, parseable."""
    p = subprocess.Popen(
        [sys.executable, BENCH, "--alg", "cholesky", "--n", "1024", "--device", "cpu"],
        env=_env(tmp_path), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        deadline = time.time() + 60
        first = None
        while time.time() < deadline:
            line = p.stdout.readline()
            if line.strip().startswith("{"):
                first = line
                break
        assert first is not None, "no JSON line before deadline"
        os.kill(p.pid, signal.SIGKILL)
        rest = p.stdout.read()
    finally:
        if p.poll() is None:
            p.kill()
        p.wait()
    recs = _read_json_lines(first + rest)
    assert recs, "nothing parseable on stdout after SIGKILL"
    prov = recs[0]
    assert prov["stale"] is True and prov["provisional"] is True
    assert prov["value"] == 56.4 and prov["metric"].startswith("cholesky_")


def test_budget_exhaustion_exits_zero(tmp_path):
    """A 3 s budget: the watchdog exits 0 with the last-good line on
    stdout, long before the CPU's n=4096 Cholesky would end."""
    t0 = time.time()
    p = subprocess.run(
        [sys.executable, BENCH, "--alg", "cholesky", "--n", "4096", "--device", "cpu"],
        env=_env(tmp_path, NPW_BENCH_BUDGET_S="3"), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, timeout=240)
    took = time.time() - t0
    assert p.returncode == 0, p.stdout[-2000:]
    recs = _read_json_lines(p.stdout)
    assert recs, "no JSON line on budget exhaustion"
    last = recs[-1]
    assert last["value"] == 56.4 and last.get("stale") is True
    assert "budget" in last["stale_reason"]
    assert took < 180, f"watchdog did not bound the run ({took:.0f}s)"


def test_full_run_supersedes_provisional(tmp_path):
    """A run to its end prints the measured line last; gemm has no last-good
    line in the file, so it is the only line. A run on the CPU leaves the
    last-good file as it was."""
    env = _env(tmp_path)
    p = subprocess.run(
        [sys.executable, BENCH, "--alg", "gemm", "--n", "256", "--tile", "64", "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    recs = _read_json_lines(p.stdout)
    assert len(recs) == 1
    real = recs[-1]
    assert real["metric"] == "gemm_n256_float32_high_tflops"
    assert "stale" not in real and real["value"] > 0 and real["seconds_per_run"] > 0
    assert real["device"] == "cpu" and real["route"] == "torch_fp32"
    assert json.loads((tmp_path / "lastgood.json").read_text()) == FAKE_LASTGOOD


@pytest.mark.parametrize("with_lastgood", [False, True])
def test_no_card_measures_nothing(with_lastgood, tmp_path, monkeypatch, capsys):
    """--device cuda (the default) on a host without a card: the failure's
    line (the stale last-good one where there is one), rc 1, nothing
    measured and nothing saved."""
    lg = tmp_path / "lastgood.json"
    if with_lastgood:
        lg.write_text(json.dumps(FAKE_LASTGOOD))
    monkeypatch.setattr(bench_torch, "LASTGOOD_PATH", str(lg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    measured = []
    for name in ("measure_matmul_peak", "bench_cholesky_trapezoid", "bench_gemm"):
        monkeypatch.setattr(bench_torch, name, lambda *a, _n=name, **k: measured.append(_n))
    assert bench_torch.main(["--alg", "cholesky", "--n", "256"]) == 1
    recs = _read_json_lines(capsys.readouterr().out)
    assert measured == []
    if with_lastgood:
        assert [r.get("provisional") for r in recs] == [True, None]
        assert recs[-1]["value"] == 56.4 and recs[-1]["stale"] is True
        assert "no CUDA device" in recs[-1]["stale_reason"]
        assert json.loads(lg.read_text()) == FAKE_LASTGOOD
    else:
        assert len(recs) == 1 and recs[0]["value"] == 0.0
        assert recs[0]["metric"] == "cholesky_tflops"
        assert "no CUDA device: pass --device cpu" in recs[0]["error"]
        assert not lg.exists()


def test_lastgood_default_path_and_cpu_runs_save_nothing(tmp_path, monkeypatch, capsys):
    """The default last-good file is the port's own, never bench.py's; a run
    on the CPU reads it but writes nothing."""
    env = {k: v for k, v in os.environ.items() if k != "NPW_BENCH_LASTGOOD"}
    code = "import bench_torch; print(bench_torch.LASTGOOD_PATH)"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=60).stdout.strip()
    assert out == os.path.join(REPO, "BENCH_LASTGOOD_TORCH.json")
    assert os.path.basename(out) != "BENCH_LASTGOOD.json"  # bench.py's record
    lg = tmp_path / "lastgood.json"
    monkeypatch.setattr(bench_torch, "LASTGOOD_PATH", str(lg))
    monkeypatch.delenv("NPW_COMPENSATED", raising=False)
    assert bench_torch.main(["--alg", "gemm", "--n", "128", "--tile", "64",
                             "--device", "cpu"]) == 0
    assert len(_read_json_lines(capsys.readouterr().out)) == 1
    assert not lg.exists()


def test_cli_bench_runs_bench_torch(tmp_path, monkeypatch, capfd):
    """`python -m numpywren_tpu_torch bench ...` reaches the repo's
    bench_torch.py and its one measured line."""
    monkeypatch.setenv("NPW_BENCH_LASTGOOD", str(tmp_path / "lastgood.json"))
    monkeypatch.delenv("NPW_COMPENSATED", raising=False)
    assert cli.BENCH == BENCH
    assert cli.main(["bench", "--alg", "gemm", "--n", "256", "--tile", "64",
                     "--device", "cpu"]) == 0
    recs = _read_json_lines(capfd.readouterr().out)
    assert len(recs) == 1 and recs[0]["metric"] == "gemm_n256_float32_high_tflops"
    assert recs[0]["value"] > 0 and "stale" not in recs[0]


# ---------------------------------------------------------------------------
# Each bench function against bench.py's on JAX's CPU
# ---------------------------------------------------------------------------

# case: (function, n, tile, keyword arguments, perf-main arguments)
CASES = {
    "cholesky_trapezoid": ("bench_cholesky_trapezoid", 512, 32, {}, dict(alg="cholesky")),
    "cholesky_trapezoid_blockwise": ("bench_cholesky_trapezoid", 512, 32, {},
                                     dict(alg="cholesky")),
    "cholesky_flat": ("bench_cholesky", 256, 32, {}, dict(alg="cholesky", layout="flat")),
    "gemm": ("bench_gemm", 256, 64, {}, dict(alg="gemm")),
    "tsqr_cholqr2": ("bench_tsqr", 4096, 512, {"method": "cholqr2"}, dict(alg="tsqr")),
    "tsqr_cholqr3s": ("bench_tsqr", 4096, 512, {"method": "cholqr3s"},
                      dict(alg="tsqr", tsqr_method="cholqr3s")),
    "tsqr_tree": ("bench_tsqr", 4096, 512, {"method": "tree"},
                  dict(alg="tsqr", tsqr_method="tree")),
    "bdfac": ("bench_bdfac", 256, 64, {}, dict(alg="bdfac")),
}
ERROR_BAR = 1e-5
# cholqr3s stops its chain once a pass lands under conv_tol 1e-4, one
# Neumann cleanup after the shifted pass: its R's Gram parity is of that
# order (both packages read ~1.05e-5 here), so it is held to conv_tol
CHOLQR3S_GRAM_BAR = 1e-4


def _args(**kw):
    base = dict(alg="cholesky", n=None, tile=None, dtype="float32", precision="high",
                syrk_depth=3, layout="trapezoid", panel=None, tsqr_method="cholqr2",
                target_frac=0.70, device="cpu", numerics=False)
    return argparse.Namespace(**{**base, **kw})


def _line(module, fn_name, result, args, monkeypatch, capsys, run):
    """The JSON line that `module`'s _perf_main prints for `args` when its
    bench function returns `result` (the speed of light stubbed to 1)."""
    monkeypatch.setattr(module, "measure_matmul_peak", lambda *a, **k: 1.0)
    monkeypatch.setattr(module, fn_name, lambda *a, **k: result)
    capsys.readouterr()
    run()
    return _read_json_lines(capsys.readouterr().out)[-1]


@pytest.mark.parametrize("case", list(CASES))
def test_bench_function_matches_reference(case, monkeypatch, capsys):
    fn_name, n, tile, kw, main_kw = CASES[case]
    monkeypatch.delenv("NPW_COMPENSATED", raising=False)
    monkeypatch.setenv("NPW_BENCH_BUDGET_S", "1e9")  # bench.py's watchdog thread never fires
    if case.endswith("_blockwise"):
        monkeypatch.setenv("NPW_BENCH_FORCE_BIG", "1")
    ref = getattr(bench, fn_name)(n, tile, jnp.float32, jax.lax.Precision.HIGH, 3, **kw)
    got = getattr(bench_torch, fn_name)(n, tile, torch.float32, "high", 3, CPU, **kw)

    (t_ref, per_ref, x_ref), (t_got, per_got, x_got) = ref, got
    assert per_got > 0 and t_got > 0
    # the same work: flops = TFLOP/s x seconds
    assert t_got * per_got == pytest.approx(t_ref * per_ref, rel=1e-9)
    # the same extra keys; the port's trapezoid residual is always the full one
    added = {"residual_full"} if fn_name == "bench_cholesky_trapezoid" else set()
    assert set(x_got) == set(x_ref) | added
    for key in set(x_ref) - {"residual_fro", "gram_rel_err"}:
        assert x_got[key] == x_ref[key], key
    for key in {"residual_fro", "gram_rel_err"} & set(x_ref):
        bar = CHOLQR3S_GRAM_BAR if case == "tsqr_cholqr3s" else ERROR_BAR
        assert 0 < x_ref[key] <= bar and 0 < x_got[key] <= bar, (key, x_ref[key], x_got[key])

    # the same metric name and keys in the harness's line, the port adding
    # its route and its kernels' launches
    args = _args(n=n, tile=tile, **main_kw)
    ref_line = _line(bench, fn_name, ref, args, monkeypatch, capsys,
                     lambda: bench._perf_main(args))
    got_line = _line(bench_torch, fn_name, got, args, monkeypatch, capsys,
                     lambda: bench_torch._perf_main(args, time.monotonic() + 600))
    assert got_line["metric"] == ref_line["metric"]
    assert set(got_line) - set(x_got) == set(ref_line) - set(x_ref) | {"route", "launches"}
    assert got_line["route"] == "torch_fp32" and got_line["device"] == "cpu"
    assert got_line["launches"] == {"matmul": 0, "matmul3": 0}


@pytest.mark.parametrize("precision, compensated, route, token", [
    ("high", False, "torch_fp32", "high"),
    ("high", True, "matmul3", "compensated"),
    ("highest", True, "matmul", "highest"),
])
def test_route_and_metric_token(precision, compensated, route, token, monkeypatch, capsys):
    """The line names the GEMM route of the products and the metric's
    precision token says `compensated` where the route is matmul3."""
    cfg = npw.default_config()
    monkeypatch.setattr(cfg, "compensated", compensated)
    assert bench_torch.route(torch.float32, precision) == route
    args = _args(alg="gemm", n=128, tile=64, precision=precision)
    line = _line(bench_torch, "bench_gemm", (1.0, 1.0, {}), args, monkeypatch, capsys,
                 lambda: bench_torch._perf_main(args, time.monotonic() + 600))
    assert line["metric"] == f"gemm_n128_float32_{token}_tflops" and line["route"] == route


# ---------------------------------------------------------------------------
# Operands and the streamed residual
# ---------------------------------------------------------------------------

def _dense_lower(cols, panel):
    n = cols[0].shape[0]
    out = np.zeros((n, n))
    for c, col in enumerate(cols):
        out[c * panel:, c * panel:(c + 1) * panel] = col.double().numpy()
    return out


@pytest.mark.parametrize("operand", ["blockwise", "gram"])
def test_operand_and_streamed_residual(operand):
    """The blockwise operand (NPW_BENCH_FORCE_BIG's) and the Gram one at
    n = 512: symmetric and positive definite, rebuilt bit for bit from the
    seed, and the streamed fp64 residual of their factor equal to the
    dense fp64 residual of the whole symmetric matrix."""
    n, panel = 512, 256
    if operand == "blockwise":
        make, column = bench_torch.blockwise_columns(n, panel, torch.float32, CPU)
        for c in range(n // panel):
            assert torch.equal(column(0, c), make(0)[c])
    else:
        make = bench_torch.gram_columns(n, n, panel, torch.float32, CPU)
    cols = make(0)
    assert all(torch.equal(a, b) for a, b in zip(cols, make(0)))
    assert not torch.equal(cols[0], make(1)[0])
    low = _dense_lower(cols, panel)
    for c in range(n // panel):  # every diagonal block exactly symmetric
        d = low[c * panel:(c + 1) * panel, c * panel:(c + 1) * panel]
        assert np.array_equal(d, d.T)
    a = np.tril(low) + np.tril(low, -1).T
    assert np.linalg.eigvalsh(a)[0] > 0.5

    l_cols = [c.clone() for c in cols]
    _trapezoid_chol_fn(panel, 32, "high")(l_cols)
    lo = np.tril(_dense_lower(l_cols, panel))
    dense = np.linalg.norm(a - lo @ lo.T) / np.linalg.norm(a)
    streamed = bench_torch.trapezoid_residual(l_cols, cols.__getitem__, panel)
    assert 0 < dense < 1e-5
    assert abs(streamed - dense) <= 1e-10


# ---------------------------------------------------------------------------
# The numerics ladder
# ---------------------------------------------------------------------------

def test_numerics_fast_against_reference(monkeypatch, capsys):
    """--numerics under NPW_BENCH_FAST: every rung passes, and each rung's
    errors are within 10x of the reference's (fused_tsqr cholqr3s,
    singular_values) on the same numpy operands."""
    from numpywren_tpu import models as ref_models
    from numpywren_tpu.compiler.lower import fused_tsqr as ref_tsqr

    monkeypatch.setenv("NPW_BENCH_FAST", "1")
    monkeypatch.delenv("NPW_COMPENSATED", raising=False)
    assert bench_torch.main(["--numerics", "--device", "cpu"]) == 0
    line = _read_json_lines(capsys.readouterr().out)[-1]
    assert line["metric"] == "numerics_gate_maxerr" and line["vs_baseline"] == 1.0
    assert line["device"] == "cpu" and all(r["pass"] for r in line["rungs"].values())

    rng = np.random.default_rng(0)  # the same draws, in the same order
    m, b = 8192, 128
    for kappa in (1e2, 1e4, 1e6, 1e8):
        u, _ = np.linalg.qr(rng.standard_normal((m, b)))
        v, _ = np.linalg.qr(rng.standard_normal((b, b)))
        a = ((u * np.logspace(0, -np.log10(kappa), b)) @ v.T).astype(np.float32)
        q, r = ref_tsqr(jnp.asarray(a), tile_rows=m, compute_q=True, method="cholqr3s")
        q, r = np.asarray(q), np.asarray(r)
        ortho = float(np.max(np.abs(q.T @ q - np.eye(b))))
        resid = float(np.linalg.norm(q @ r - a) / np.linalg.norm(a))
        rung = line["rungs"][f"cholqr3s_kappa_{kappa:.0e}"]
        assert rung["ortho_max"] <= 10 * ortho and rung["resid"] <= 10 * resid, (rung, ortho,
                                                                                  resid)
    x = rng.standard_normal((1024, 1024)).astype(np.float32)
    s_ref = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    err = float(np.max(np.abs(ref_models.singular_values(x, tile=256) - s_ref)) / s_ref[0])
    assert line["rungs"]["bdfac_sv_tile256"]["sv_maxerr"] <= 10 * err
