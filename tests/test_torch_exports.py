"""The port's runtime and compiler packages export the reference's names
(numpywren_tpu/runtime/__init__.py, numpywren_tpu/compiler/__init__.py), so
code written against the JAX package's `from numpywren_tpu.runtime import
PS, run_program` runs on the port by its package name alone.

The runtime's list is the reference's, `out_of_core_cholesky` included.
The Cholesky through the exported names holds the reference tests' bars (tests/test_cholesky.py):
residual below 5e-6, and the port's factor within rtol 1e-4, atol 1e-5 of
the JAX package's on the same input.
"""

import subprocess
import sys

import numpy as np
import pytest

import numpywren_tpu.compiler as jcompiler
import numpywren_tpu.runtime as jruntime
from numpywren_tpu import alg_wrappers as jalg
from numpywren_tpu.matrix_init import random_spd
from numpywren_tpu_torch import alg_wrappers
from numpywren_tpu_torch import compiler, runtime


def test_runtime_exports_the_reference_names():
    assert runtime.__all__ == jruntime.__all__
    assert len(runtime.__all__) == len(set(runtime.__all__))
    for name in runtime.__all__:
        assert getattr(runtime, name) is not None
    assert runtime.JaxTaskExecutor is runtime.TorchTaskExecutor


def test_compiler_exports_the_reference_names():
    assert compiler.__all__ == jcompiler.__all__
    from numpywren_tpu_torch.compiler.schedule import compile_schedule

    assert compiler.compile_schedule is compile_schedule


@pytest.mark.parametrize("executor,storage", [("local", "host"), ("jax", "hbm")])
def test_cholesky_through_the_exported_names(executor, storage):
    from numpywren_tpu_torch.runtime import NS, PS, TiledProgram, run_program

    a = random_spd(128, seed=0)
    prog, out, _ = alg_wrappers.cholesky(a, tile=(32, 32), storage=storage, device="cpu")
    assert isinstance(prog, TiledProgram)
    assert run_program(prog, executor=executor) == PS.SUCCESS
    assert prog.get_node_status(prog.num_nodes - 1) == NS.FINISHED
    l = out.numpy()
    assert np.linalg.norm(a - np.tril(l) @ np.tril(l).T) / np.linalg.norm(a) < 5e-6
    jprog, jout, _ = jalg.cholesky(a, tile=(32, 32), storage=storage)
    assert jruntime.run_program(jprog, executor=executor) == jruntime.PS.SUCCESS
    np.testing.assert_allclose(l, jout.numpy(), rtol=1e-4, atol=1e-5)


def test_runtime_imports_first_without_a_cycle_or_jax():
    """A fresh interpreter that imports the runtime package before anything
    else of the port (the order an import cycle would break), then the
    compiler's, gets every name and has loaded no jax and nothing of the
    JAX package."""
    code = (
        "import sys\n"
        "from numpywren_tpu_torch.runtime import (NS, PS, TiledProgram, LocalExecutor,\n"
        "    JaxTaskExecutor, SpillTaskExecutor, out_of_core_cholesky, run_program)\n"
        "from numpywren_tpu_torch.compiler import compile_schedule\n"
        "import numpywren_tpu_torch\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'numpywren_tpu.'))\n"
        "             or m == 'numpywren_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
