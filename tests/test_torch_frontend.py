"""The port's own DSL stack (frontend, schedule compiler, native core)
against the JAX package's: the same program binds to the same DAG, node for
node and level for level, with the native core and without it."""

import os
import subprocess
import sys

import numpy as np
import pytest

import numpywren_tpu as jnpw
import numpywren_tpu_torch as npw
from numpywren_tpu.matrix_init import random_spd


def _programs(alg):
    rng = np.random.default_rng(0)
    if alg == "cholesky":
        a = random_spd(256, seed=1)
        return npw.cholesky(a, tile=(32, 32), device="cpu")[0], jnpw.cholesky(a, tile=(32, 32))[0]
    if alg == "gemm":
        a = rng.standard_normal((256, 192)).astype(np.float32)
        b = rng.standard_normal((192, 128)).astype(np.float32)
        return (npw.gemm(a, b, tile=(32, 32), device="cpu")[0],
                jnpw.gemm(a, b, tile=(32, 32))[0])
    x = rng.standard_normal((576, 32)).astype(np.float32)
    kw = {"tsqr": {}, "tsqr_q": dict(compute_q=True), "tsqr_b3": dict(b_fac=3)}[alg]
    return (npw.tsqr(x, tile_rows=64, device="cpu", **kw)[0],
            jnpw.tsqr(x, tile_rows=64, **kw)[0])


@pytest.mark.parametrize("native", ["auto", "0"])
@pytest.mark.parametrize("alg", ["cholesky", "gemm", "tsqr", "tsqr_q", "tsqr_b3"])
def test_program_structure_matches_jax(monkeypatch, native, alg):
    monkeypatch.setenv("NPW_NATIVE", native)
    prog, jprog = _programs(alg)
    assert prog.dag.template.name == jprog.dag.template.name
    assert prog.num_nodes == jprog.num_nodes
    assert prog.levels == jprog.levels
    assert prog.dag.stats() == jprog.dag.stats()


def test_port_frontend_is_its_own():
    from numpywren_tpu_torch.frontend import lpcompile
    from numpywren_tpu_torch.runtime.program import TiledProgram

    prog, _ = _programs("cholesky")
    assert isinstance(prog, TiledProgram)
    assert lpcompile.__module__.startswith("numpywren_tpu_torch.")
    assert type(prog.dag).__module__ == "numpywren_tpu_torch.compiler.schedule"


def test_native_build_is_atomic(tmp_path):
    """Six processes build the native core into one path at once (as xdist
    workers do at collection); each then loads it. g++ writes a file of its
    own and os.replace puts it in place, so no loader opens half a file."""
    so = tmp_path / "_schedule_core.so"
    code = ("import ctypes, sys; from numpywren_tpu_torch import native; "
            "ok = native.build(so=sys.argv[1]); "
            "ctypes.CDLL(sys.argv[1]).npw_build; print(ok)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(so)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    results = [p.communicate(timeout=240) + (p.returncode,) for p in procs]
    assert all(rc == 0 and out.strip() == "True" for out, _, rc in results), results
    assert [p.name for p in tmp_path.iterdir()] == [so.name]  # no temporary file left


def test_native_build_never_exposes_half_a_file(tmp_path, monkeypatch):
    """While the compiler is still writing its output, the library's path
    holds nothing (or the last whole library), never the part written so far."""
    import threading
    import time

    from numpywren_tpu_torch import native

    so, whole = tmp_path / "_schedule_core.so", b"\x7fELF" + bytes(4092)
    writing, seen = threading.Event(), []

    def slow_compiler(cmd, **kw):  # writes its -o file in two halves
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(whole[:2048])
            f.flush()
            writing.set()
            time.sleep(0.3)
            f.write(whole[2048:])

    monkeypatch.setattr(native.subprocess, "run", slow_compiler)
    worker = threading.Thread(target=lambda: seen.append(native.build(force=True, so=str(so))))
    worker.start()
    assert writing.wait(10)
    assert not so.exists() or so.read_bytes() == whole
    worker.join()
    assert seen == [True] and so.read_bytes() == whole
    assert [p.name for p in tmp_path.iterdir()] == [so.name]
