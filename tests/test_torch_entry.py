"""The port's user entry points against the JAX package's, on the CPU:
cholesky(X, storage=...) and gemm(A, B) + run_program (the DSL path through
lower_fused), cholesky_solve, and carrying matrices across with convert.

Same numpy inputs through both packages; tolerance rtol 1e-4, atol 1e-5 on
factors (as tests/test_trapezoid.py), 1e-4 relative on solutions.
"""

import numpy as np
import pytest

import numpywren_tpu as jnpw
import numpywren_tpu_torch as npw
from numpywren_tpu import config
from numpywren_tpu.matrix_init import random_spd
from numpywren_tpu.matrix_init import shard_matrix as jshard
from numpywren_tpu_torch import config as pconfig
from numpywren_tpu_torch import convert
from numpywren_tpu_torch.exceptions import ShapeError
from numpywren_tpu_torch.runtime.program import NS, PS

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(params=[False, True], ids=["high", "compensated"])
def compensated(request, monkeypatch):  # each package has its own config: set both
    monkeypatch.setattr(config, "_default", config.NpwConfig(compensated=request.param))
    monkeypatch.setattr(pconfig, "_default", pconfig.NpwConfig(compensated=request.param))
    return request.param


def _both(a, **kw):
    """(port O, port meta, JAX O, JAX meta) after binding and running."""
    prog, o, meta = npw.cholesky(a, device="cpu", **kw)
    assert npw.run_program(prog) == PS.SUCCESS
    assert prog.program_status == PS.SUCCESS
    assert prog._finished_count == prog.num_nodes
    assert prog.get_node_status(prog.num_nodes - 1) == NS.FINISHED
    jprog, jo, jmeta = jnpw.cholesky(a, **kw)
    jnpw.run_program(jprog)
    return o, meta, jo, jmeta


@pytest.mark.parametrize("storage,n,kw", [
    ("hbm", 300, dict(tile=(64, 64))),                  # padded edge tiles
    ("hbm", 256, dict(tile=(32, 32))),                  # inner blocking 128
    ("trapezoid", 256, dict(tile=(32, 32), panel=64)),
    ("trapezoid", 200, dict(tile=(64, 64), panel=128)),  # padded trapezoid
])
def test_cholesky_run_program_matches_jax(compensated, storage, n, kw):
    a = random_spd(n, seed=n)
    o, _, jo, _ = _both(a, storage=storage, **kw)
    assert o.storage == jo.storage
    got = o.numpy()
    np.testing.assert_allclose(got, jo.numpy(), rtol=RTOL, atol=ATOL)
    assert np.linalg.norm(a - got @ got.T) / np.linalg.norm(a) < 1e-5
    assert o.block_idxs_exist == jo.block_idxs_exist


@pytest.mark.parametrize("storage,kw", [
    ("hbm", dict(tile=(32, 32), truncate=3)),
    ("trapezoid", dict(tile=(32, 32), panel=64, truncate=4)),
])
def test_truncate_prefix_run_matches_jax(compensated, storage, kw):
    """A prefix run: the factored columns in O, the Schur complement where
    each tier keeps it (S on the flat tier, O's own buffers on the
    trapezoid tier), and the same computed-block mask."""
    a = random_spd(256, seed=41)
    o, meta, jo, jmeta = _both(a, storage=storage, **kw)
    if storage == "hbm":
        np.testing.assert_allclose(o.numpy(), jo.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(meta["scratch"].numpy(), jmeta["scratch"].numpy(),
                                   rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(o.trap.numpy(), np.asarray(jo.trap.to_array()),
                                   rtol=RTOL, atol=ATOL)
    assert o.block_idxs_exist == jo.block_idxs_exist


def test_cholesky_solve_matches_jax():
    rng = np.random.default_rng(3)
    a = random_spd(200, seed=5)
    b = rng.standard_normal((200, 3)).astype(np.float32)
    o, _, jo, _ = _both(a, tile=(64, 64))
    x = npw.cholesky_solve(o, b)
    np.testing.assert_allclose(x, jnpw.cholesky_solve(jo, b), rtol=1e-4, atol=1e-5)
    x1 = npw.cholesky_solve(o, b[:, 0])
    assert x1.shape == (200,)
    assert np.linalg.norm(a @ x1 - b[:, 0]) / np.linalg.norm(b[:, 0]) < 1e-4


def test_convert_round_trip():
    """Stores carried from the JAX package hold the same state, and the
    port factors them as JAX does."""
    a = random_spd(192, seed=6)
    jm = jshard(a, tile=(64, 64))
    m = convert.from_reference(jm, device="cpu")
    np.testing.assert_array_equal(convert.to_numpy(m), jm.numpy())
    assert m.block_idxs_exist == jm.block_idxs_exist
    o, _, jo, _ = _both(a, storage="trapezoid", tile=(64, 64), panel=64)
    np.testing.assert_array_equal(convert.to_numpy(convert.from_reference(jo, device="cpu")),
                                  jo.numpy())
    # the same state into both packages' factorizations
    prog, o2, _ = npw.cholesky(m)
    npw.run_program(prog)
    np.testing.assert_allclose(convert.to_numpy(o2), jo.numpy(), rtol=RTOL, atol=ATOL)
    with pytest.raises(TypeError):
        convert.from_reference(object(), device="cpu")


def test_unported_paths_raise(monkeypatch):
    """What is left unported raises and names its ROADMAP item: "auto" on a
    program whose fused lowering the port lacks (bdfac). A host-tier
    cholesky too large for the device budget runs out of core
    (runtime/spill.py) as the JAX package's auto dispatch does: L stays on
    the host tier and matches the JAX package's factor."""
    a = random_spd(128, seed=7)
    x = np.ones((64, 64), np.float32)
    prog, _, _ = npw.bdfac(x, tile=(32, 32), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #5"):
        npw.run_program(prog)
    monkeypatch.setattr(npw.default_config(), "hbm_budget_bytes", 1024)
    monkeypatch.setattr(config, "_default", config.NpwConfig(hbm_budget_bytes=1024))
    prog, o, _ = npw.cholesky(a, tile=(32, 32), storage="host", device="cpu")
    assert npw.run_program(prog, executor="auto") == PS.SUCCESS
    assert o.storage == "host"
    jprog, jo, _ = jnpw.cholesky(jshard(a, tile=(32, 32), storage="host"), tile=(32, 32),
                                 storage="host")
    jnpw.run_program(jprog, executor="auto")
    assert jo.storage == "host"
    got = np.tril(o.numpy())
    np.testing.assert_allclose(got, np.tril(jo.numpy()), rtol=RTOL, atol=ATOL)
    assert np.linalg.norm(a - got @ got.T) / np.linalg.norm(a) < 1e-5
    with pytest.raises(ValueError, match="unknown executor"):
        npw.run_program(prog, executor="bogus")


@pytest.mark.parametrize("m,k,n,tile,k_chunk", [
    (300, 200, 150, 64, None),   # padded edge tiles, default chunking
    (256, 512, 128, 64, 1),      # the full log-depth reduce tree
    (128, 128, 128, 128, None),  # one tile
])
def test_gemm_run_program_matches_jax(compensated, m, k, n, tile, k_chunk):
    """gemm(A, B) + run_program through the fused lowering: "high" is
    torch.matmul in true FP32, compensated the bf16x3 route (its plain
    version here, ~4e-6 relative to the exact product where JAX's CPU path
    is plain fp32). Tolerance: relative Frobenius 1e-5."""
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    kw = dict(tile=(tile, tile), k_chunk=k_chunk)
    prog, c, meta = npw.gemm(a, b, device="cpu", **kw)
    assert npw.run_program(prog) == PS.SUCCESS
    jprog, jc, jmeta = jnpw.gemm(a, b, **kw)
    jnpw.run_program(jprog)
    assert meta == jmeta
    assert prog.matrices["P"].matrix._data is None  # the partials stay unallocated
    exact = a.astype(np.float64) @ b
    for want in (jc.numpy(), exact):
        assert np.linalg.norm(c.numpy() - want) <= 1e-5 * np.linalg.norm(want)
    assert c.block_idxs_exist == jc.block_idxs_exist


def test_gemm_checks():
    a = np.ones((64, 32), np.float32)
    with pytest.raises(ShapeError, match="mismatch"):
        npw.gemm(a, a, tile=(32, 32), device="cpu")
    prog, c, _ = npw.gemm(a, a.T, tile=(32, 32), storage="host", device="cpu")
    assert c.storage == "host" and npw.run_program(prog) == PS.SUCCESS
    np.testing.assert_allclose(c.numpy(), a @ a.T, rtol=1e-6)


def test_restored_names_match_the_reference():
    """The package surface the reference has: __version__, the lazy binops
    and lpcompile, matrix_init.local_numpy_init, TrapezoidMatrix.block."""
    from numpywren_tpu import matrix_init as jmi
    from numpywren_tpu.frontend import lpcompile as jlpcompile
    from numpywren_tpu_torch import matrix_init as pmi
    from numpywren_tpu_torch import trapezoid

    assert npw.__version__ == jnpw.__version__
    assert "__version__" in npw.__all__
    assert npw.binops.__name__ == "numpywren_tpu_torch.binops"
    for fn in ("gemm", "add", "sub"):
        assert callable(getattr(npw.binops, fn)) and callable(getattr(jnpw.binops, fn))
    assert npw.lpcompile.__name__ == jlpcompile.__name__ == "lpcompile"
    with pytest.raises(AttributeError, match="has no attribute 'bogus'"):
        npw.bogus  # noqa: B018
    a = np.arange(96 * 64, dtype=np.float32).reshape(96, 64)
    m = pmi.local_numpy_init(a, tile=(32, 32), device="cpu")
    s = pmi.shard_matrix(a, tile=(32, 32), device="cpu")
    jm = jmi.local_numpy_init(a, tile=(32, 32))
    assert m.block_idxs == s.block_idxs == jm.block_idxs
    for (i, j) in m.block_idxs:
        np.testing.assert_array_equal(m.get_block(i, j).numpy(), s.get_block(i, j).numpy())
        np.testing.assert_array_equal(m.get_block(i, j).numpy(), np.asarray(jm.get_block(i, j)))
    t = trapezoid.TrapezoidMatrix.from_array(random_spd(96, seed=8), panel=32, device="cpu")
    jt = jnpw.TrapezoidMatrix.from_array(random_spd(96, seed=8), panel=32)
    for c in range(t.nb):
        assert t.block(c) is t.cols[c]
        np.testing.assert_array_equal(t.block(c).numpy(), np.asarray(jt.block(c)))
