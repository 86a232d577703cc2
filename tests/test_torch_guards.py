"""Guards for the PyTorch/CUDA port: it never imports jax or the JAX
package, it has no silent fallback around its kernels or to the CPU, and
chip_smoke.py refuses to report a result from a host without a CUDA device
or without the port beside it."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "numpywren_tpu_torch"


def _run(args, cwd, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_runs_without_jax():
    code = (
        "import sys, numpy as np\n"
        "import numpywren_tpu_torch as npw\n"
        "from numpywren_tpu_torch.matrix_init import random_spd\n"
        "a = random_spd(96, seed=1)\n"
        "l = npw.cholesky_trapezoid(npw.TrapezoidMatrix.from_array(a, panel=32, device='cpu')).numpy()\n"
        "assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-5\n"
        "prog, o, _ = npw.cholesky(a, tile=(32, 32), device='cpu')\n"
        "npw.run_program(prog)\n"
        "print('jax' in sys.modules)\n"
    )
    proc = _run(["-c", code], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


WORKERS = [ROOT / "tests" / "torch_parallel_worker.py"]
BENCH = ROOT / "bench_torch.py"


def test_no_jax_import_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", BENCH] + WORKERS
    assert len(files) >= 15
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib"), f"{path}: imports {mod}"


def test_no_jax_package_import_in_port_sources():
    """The port keeps its own copies of the backend-neutral modules: no
    import whose top-level name is numpywren_tpu, in the package or in
    chip_smoke.py, nor in the port's rank worker or bench_torch.py."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", BENCH] + WORKERS
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] != "numpywren_tpu", f"{path}: imports {mod}"


def test_port_runs_with_the_jax_package_blocked():
    code = (
        "import sys\n"
        "sys.modules['numpywren_tpu'] = None\n"
        "import numpy as np\n"
        "import numpywren_tpu_torch as npw\n"
        "from numpywren_tpu_torch.matrix_init import random_spd\n"
        "a = random_spd(96, seed=1)\n"
        "prog, o, _ = npw.cholesky(a, tile=(32, 32), device='cpu')\n"
        "npw.run_program(prog)\n"
        "l = o.numpy()\n"
        "assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-5\n"
        "x = np.random.default_rng(0).standard_normal((256, 16)).astype(np.float32)\n"
        "prog, out, _ = npw.tsqr(x, tile_rows=64, compute_q=True, device='cpu')\n"
        "npw.run_program(prog)\n"
        "q, r = out['Q'].numpy(), npw.tsqr_r_factor(out)\n"
        "assert np.abs(q @ r - x).max() < 1e-4\n"
        "prog, c, _ = npw.gemm(x.T, x, tile=(16, 16), device='cpu')\n"
        "npw.run_program(prog)\n"
        "assert np.abs(c.numpy() - x.T @ x).max() < 1e-3\n"
        "y = np.random.default_rng(1).standard_normal((48, 48)).astype(np.float32)\n"
        "for ex, st in (('jax', 'hbm'), ('spill', 'host'), ('local', 'host')):\n"
        "    prog, b, _ = npw.bdfac(y, tile=(16, 16), storage=st, device='cpu')\n"
        "    npw.run_program(prog, executor=ex)\n"
        "    s = np.linalg.svd(b.numpy(), compute_uv=False)\n"
        "    assert np.abs(s - np.linalg.svd(y, compute_uv=False)).max() < 1e-4 * s[0]\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'numpywren_tpu')"
        " and sys.modules[m] is not None))\n"
    )
    proc = _run(["-c", code], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_no_cpu_fallback_without_a_device(monkeypatch):
    """On a host without CUDA, an entry point given an ndarray and no
    device= raises; it does not run on the CPU."""
    import numpy as np
    import pytest
    import torch

    import numpywren_tpu_torch as npw
    from numpywren_tpu_torch.matrix_init import random_spd, shard_matrix
    from numpywren_tpu_torch.ops.common import default_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = random_spd(64, seed=2)
    x = np.ones((128, 8), np.float32)
    for call in (default_device,
                 lambda: shard_matrix(a),
                 lambda: npw.cholesky(a, tile=(32, 32)),
                 lambda: npw.cholesky(a, storage="trapezoid", panel=32),
                 lambda: npw.TrapezoidMatrix.from_array(a, panel=32),
                 lambda: npw.tsqr(x, tile_rows=64),
                 lambda: npw.gemm(a, a, tile=(32, 32)),
                 lambda: npw.bdfac(a, tile=(32, 32)),
                 lambda: shard_matrix(a, storage="host"),
                 lambda: npw.TiledMatrix(shape=(64, 64), storage="host")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_no_try_around_kernel_launches():
    """A CUDA tensor launches the kernel or raises: the ops and the
    lowering hold no try/except that could fall back to another GEMM."""
    for rel in ("ops/gemm.py", "ops/gemm3.py", "ops/pallas_factor.py", "ops/factor.py",
                "ops/dispatch.py", "compiler/lower.py"):
        tree = ast.parse((PKG / rel).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), rel
    # bench_torch.py: its try statements are the last-good file's I/O and
    # the run's boundary (a failure becomes its JSON line; a failed stage
    # falls back to a smaller one on the same device and route); no
    # function that measures holds one
    tree = ast.parse(BENCH.read_text())
    tries = sum(isinstance(n, ast.Try) for n in ast.walk(tree))
    owners = {}
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for n in ast.walk(fn):
                if isinstance(n, ast.Try):
                    owners.setdefault(fn.name, set()).add(id(n))
    assert set(owners) == {"save_lastgood", "load_lastgood", "main", "_perf_main"}, owners
    assert len(set().union(*owners.values())) == tries


def _assert_refused(proc):
    assert proc.returncode != 0
    assert not any(json.loads(line).get("ok") is True
                   for line in proc.stdout.splitlines() if line.startswith("{"))


def test_chip_smoke_fails_without_a_gpu():
    proc = _run(["chip_smoke.py"], cwd=ROOT)
    _assert_refused(proc)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    _assert_refused(proc)


# P21 (b)'s ranks on the CPU at a tiny size: the kernels' plain versions
_P21B = ("import torch, chip_smoke\n"
         "chip_smoke.p21_multi(torch, {'n_chol': 256, 'n_gemm': 128, 'm': 2048, 'b': 32},\n"
         "                     {'n_chol': 128, 'n_gemm': 64, 'm': 1024, 'b': 32}, 0, 'cpu')\n")


def _p21b(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-c", _P21B], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_p21_ranks_rehearse_on_the_cpu():
    """chip_smoke.py's P21 (b) runs its four ranks to their end here, on
    the CPU: each reports, and rank 0's checks against the 1-rank results
    hold."""
    proc = _p21b(ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    ranks = [r for r in rows if "rank" in r]
    assert sorted(r["rank"] for r in ranks) == [0, 1, 2, 3]
    assert ranks[0]["cholesky_rel_diff_vs_1_rank"] <= 1e-4


# Stand-ins for a card and for every phase before P21 (b), which then runs
# its ranks on the CPU at a tiny size; a broadcast on rank 1 raises.
_ONLY_P21B = """
import pathlib as _pathlib

import torch as _torch
import torch.distributed as _dist
from numpywren_tpu_torch.ops import _build as _b


def _nothing(*args, **kw):
    return None


for _name in ("p1_kernels", "p6_factor", "p6_ops_path", "p7_chain", "tsqr_phases", "p13_qr",
              "p14_qr_leaf", "p15_generic", "p16_host_tier", "p21_single"):
    globals()[_name] = _nothing
main_path = lambda *a, **kw: ({"matmul3": 0}, ({"seconds": 0.0}, None, None))
p12_gemm = lambda *a, **kw: (0, {})
p17_spill = p18_models = p20_qdwh_ooc = lambda *a, **kw: ({}, None)
p19_bdfac = lambda *a, **kw: ({}, None, {"tile512_seconds": {}})
gpu_line = lambda: "no card"
_p21_multi, _main, _generator = p21_multi, main, _torch.Generator
p21_multi = lambda torch, sizes, small, seed: _p21_multi(
    torch, {"n_chol": 256, "n_gemm": 128, "m": 2048, "b": 32},
    {"n_chol": 128, "n_gemm": 64, "m": 1024, "b": 32}, seed, "cpu")


def main(argv=None):
    _torch.cuda.is_available = lambda: True
    _torch.cuda.get_device_name = lambda i=0: "no card"
    _torch.Generator = lambda device=None: _generator()
    _b.build, _b.library = (lambda: _pathlib.Path("none.so")), _nothing
    return _main(argv)


_broadcast = _dist.broadcast


def _faulty_broadcast(tensor, *args, **kw):
    if _dist.get_rank() == 1:
        raise RuntimeError("injected collective fault")
    return _broadcast(tensor, *args, **kw)


_dist.broadcast = _faulty_broadcast

"""


def test_a_failing_rank_fails_chip_smoke(tmp_path):
    """A collective that raises on one rank of P21 (b) makes chip_smoke.py,
    run as a script through its main, exit 1 without the ok line, naming
    the rank and its error; the other ranks are stopped."""
    src = (ROOT / "chip_smoke.py").read_text()
    tail = '\nif __name__ == "__main__":\n'
    assert src.count(tail) == 1
    (tmp_path / "chip_smoke.py").write_text(src.replace(tail, _ONLY_P21B + tail))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert '"phase": "P0"' in proc.stdout  # main ran up to P21 (b)
    assert "chip_smoke: FAIL: P21 (b): rank " in proc.stderr and "rank 1 exit 1" in proc.stderr
    assert "injected collective fault" in proc.stderr
    assert not any(json.loads(line).get("ok") is True
                   for line in proc.stdout.splitlines() if line.startswith("{"))
