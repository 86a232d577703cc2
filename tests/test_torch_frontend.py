"""The port's own DSL stack (frontend, schedule compiler, native core)
against the JAX package's: the same program binds to the same DAG, node for
node and level for level, with the native core and without it."""

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
