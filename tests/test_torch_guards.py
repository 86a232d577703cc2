"""Guards for the PyTorch/CUDA port: it never imports jax, it has no silent
fallback around its kernels, and chip_smoke.py refuses to report a result
from a host without a CUDA device or without the port beside it."""

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


def test_no_jax_import_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib"), f"{path}: imports {mod}"


def test_no_try_around_kernel_launches():
    """A CUDA tensor launches the kernel or raises: the ops and the
    lowering hold no try/except that could fall back to another GEMM."""
    for rel in ("ops/gemm.py", "ops/gemm3.py", "compiler/lower.py"):
        tree = ast.parse((PKG / rel).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), rel


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
