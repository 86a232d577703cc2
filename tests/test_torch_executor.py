"""The port's generic DSL executors and the layers under them, against the
JAX package on the CPU, from the same numpy inputs:

- ops.factor and the TORCH_KERNELS table against ops.factor / JAX_KERNELS
  (the table covers kernels.KERNELS, as tests/test_ops.py requires of the
  JAX one);
- cholesky, gemm, tsqr (R, Q, k-ary b_fac 3 and 4) and bdfac through
  ("jax", "hbm"), ("local", "host") and ("spill", "host"), each against
  the JAX package on the same executor;
- both schedule policies, LocalExecutor with faults and duplicate
  deliveries, its priority order, resume from a half-run program, the
  spill prefetch's event order, binops on both tiers, and "auto" on bdfac.

Tolerances are the reference tests' own: L rtol 1e-4 / atol 1e-5
(tests/test_cholesky.py), C rtol 1e-4 / atol 1e-4 (tests/test_gemm.py), R
up to row signs rtol 1e-4 / atol 1e-5·max|R| (both packages use geqrf
signs; the sign fix is the reference tests'), the singular values of B
within 2e-4·σ_max (tests/test_lookahead.py), tile ops rtol 1e-4 /
atol 1e-4·max|x| (fp32 in another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import numpywren_tpu as jnpw
from numpywren_tpu import binops as jbinops
from numpywren_tpu import checkpoint as jcheckpoint
from numpywren_tpu import kernels as jkernels
from numpywren_tpu.matrix_init import shard_matrix as jshard
from numpywren_tpu.ops import factor as jfactor
from numpywren_tpu.ops.dispatch import JAX_KERNELS
from numpywren_tpu.runtime import executor as jexecutor

import numpywren_tpu_torch as npw
from numpywren_tpu_torch import binops, checkpoint, convert, kernels
from numpywren_tpu_torch.exceptions import BlockNotFoundError
from numpywren_tpu_torch.matrix_init import random_spd, shard_matrix
from numpywren_tpu_torch.ops import factor
from numpywren_tpu_torch.ops.dispatch import TORCH_KERNELS, torch_kernel
from numpywren_tpu_torch.runtime.executor import (
    LocalExecutor,
    SpillTaskExecutor,
    TorchTaskExecutor,
    execute_node_numpy,
)
from numpywren_tpu_torch.runtime.program import PS

T = 16  # tile


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, rtol=1e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _sign_fixed(r):
    s = np.sign(np.diag(r))
    s[s == 0] = 1
    return s[:, None] * r


# ---------------------------------------------------------------------------
# The tile ops and the dispatch table
# ---------------------------------------------------------------------------

def _kernel_args(name, rng):
    """Inputs that suit kernel `name` (a tile of T rows unless the op
    stacks or factors them)."""
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def upper():
        return np.triu(r(T, T)) + 4 * np.eye(T, dtype=np.float32)

    if name == "potrf":
        return [random_spd(T, seed=1)]
    if name == "trsm":
        return [r(T, T), np.linalg.cholesky(random_spd(T, seed=2)).astype(np.float32)]
    if name in ("syrk", "gemm_acc"):
        return [r(T, T), r(T, T), r(T, T)]
    if name == "qr_leaf":
        return [r(4 * T, T)]
    if name == "lq_leaf":
        return [r(T, 4 * T)]
    if name == "qr_combine":
        return [upper(), upper()]
    if name.startswith("qr_combine_r"):
        return [upper() for _ in range(int(name[len("qr_combine_r"):]))]
    if name in ("qr_apply2", "lq_apply2"):
        return [r(T, T) for _ in range(6)]
    if name in ("copy", "transpose", "identity", "qr_r"):
        return [r(T, T)]
    return [r(T, T), r(T, T)]


def test_torch_kernels_cover_the_numpy_registry():
    assert set(TORCH_KERNELS) == set(kernels.KERNELS) == set(JAX_KERNELS)
    assert torch_kernel("gemm") is TORCH_KERNELS["gemm"]


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_torch_kernels_match_jax_kernels(name, rng):
    args = _kernel_args(name, rng)
    got = TORCH_KERNELS[name](*[torch.from_numpy(a) for a in args])
    want = JAX_KERNELS[name](*[jnp.asarray(a) for a in args])
    ref = jkernels.KERNELS[name](*args)
    got, want, ref = ((x if isinstance(x, tuple) else (x,)) for x in (got, want, ref))
    assert len(got) == len(want) == len(ref)
    for g, w, f in zip(got, want, ref):
        _close(g, w)
        _close(g, f, rtol=1e-3)  # the numpy ground truth (LAPACK on fp32)


@pytest.mark.parametrize("name", ["potrf", "trsm", "qr_leaf", "qr_combine", "qr_r", "lq_leaf",
                                  "small_qr_apply", "qr_factor2", "qr_apply2", "lq_factor2",
                                  "lq_apply2"])
def test_factor_ops_match_jax(name, rng):
    args = _kernel_args(name, rng)
    got = getattr(factor, name)(*[torch.from_numpy(a) for a in args])
    want = getattr(jfactor, name)(*[jnp.asarray(a) for a in args])
    got, want = ((x if isinstance(x, tuple) else (x,)) for x in (got, want))
    for g, w in zip(got, want):
        _close(g, w)


def test_factor_ops_batch_over_leading_axes(rng):
    top, bot = rng.standard_normal((2, 3, T, T)).astype(np.float32)
    outs = factor.qr_factor2(torch.from_numpy(top), torch.from_numpy(bot))
    for k in range(3):
        for got, want in zip(outs, jfactor.qr_factor2(top[k], bot[k])):
            _close(got[k], want)


def test_potrf_of_a_matrix_that_is_not_spd_gives_nans():
    """As lax.linalg.cholesky: NaNs in the lower triangle, not an error
    (the executors' contract)."""
    bad = -np.eye(T, dtype=np.float32)
    got = factor.potrf(torch.from_numpy(bad)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(np.asarray(jfactor.potrf(bad))))
    assert np.isnan(got[np.tril_indices(T)]).all()


# ---------------------------------------------------------------------------
# Whole programs through the three generic executors
# ---------------------------------------------------------------------------

EXECUTORS = [("jax", "hbm"), ("local", "host"), ("spill", "host")]


def _run_both(bind, executor, **kw):
    """(port outputs, JAX outputs) of one program bound by `bind(pkg,
    **storage kwargs)` and run on `executor` in both packages."""
    prog, out, meta = bind(npw, device="cpu")
    assert npw.run_program(prog, executor=executor, **kw) == PS.SUCCESS
    jprog, jout, jmeta = bind(jnpw)
    assert jnpw.run_program(jprog, executor=executor, **kw) == jexecutor.PS.SUCCESS
    assert prog.num_nodes == jprog.num_nodes
    return out, jout


@pytest.mark.parametrize("executor,storage", EXECUTORS)
def test_cholesky_matches_jax(executor, storage):
    a = random_spd(100, seed=3)  # 100 = 6 tiles of 16 and an edge tile: identity padding
    out, jout = _run_both(lambda pkg, **d: pkg.cholesky(a, tile=(T, T), storage=storage, **d),
                          executor)
    assert out.storage == jout.storage == storage
    l = out.numpy()
    np.testing.assert_allclose(l, jout.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(l, scipy.linalg.cholesky(a.astype(np.float64), lower=True),
                               rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("executor,storage", EXECUTORS)
def test_gemm_matches_jax(executor, storage, rng):
    a = rng.standard_normal((64, 80)).astype(np.float32)
    b = rng.standard_normal((80, 48)).astype(np.float32)
    out, jout = _run_both(lambda pkg, **d: pkg.gemm(a, b, tile=(T, T), storage=storage, **d),
                          executor)
    np.testing.assert_allclose(out.numpy(), jout.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(compute_q=True), dict(b_fac=3), dict(b_fac=4)])
@pytest.mark.parametrize("executor,storage", EXECUTORS)
def test_tsqr_matches_jax(executor, storage, kw, rng):
    x = rng.standard_normal((160, T)).astype(np.float32)  # 5 leaves: a ragged tree
    out, jout = _run_both(
        lambda pkg, **d: pkg.tsqr(x, tile_rows=32, storage=storage, **kw, **d), executor)
    r = _sign_fixed(npw.tsqr_r_factor(out))
    jr = _sign_fixed(np.asarray(jnpw.tsqr_r_factor(jout)))
    np.testing.assert_allclose(r, jr, rtol=1e-4, atol=1e-5 * np.abs(jr).max())
    if kw.get("compute_q"):
        q = out["Q"].numpy()
        np.testing.assert_allclose(q @ npw.tsqr_r_factor(out), x, atol=5e-5)
        np.testing.assert_allclose(q.T @ q, np.eye(T), atol=5e-5)


@pytest.mark.parametrize("executor,storage", EXECUTORS)
def test_bdfac_matches_jax(executor, storage, rng):
    x = rng.standard_normal((3 * T, 3 * T)).astype(np.float32)
    out, jout = _run_both(lambda pkg, **d: pkg.bdfac(x, tile=(T, T), storage=storage, **d),
                          executor)
    b = out.numpy()
    s = np.linalg.svd(b.astype(np.float64), compute_uv=False)
    js = np.linalg.svd(jout.numpy().astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, js, atol=2e-4 * js[0], rtol=0)
    np.testing.assert_allclose(s, np.linalg.svd(x.astype(np.float64), compute_uv=False),
                               atol=2e-4 * js[0], rtol=0)
    for i in range(3):
        for j in range(3):
            if j not in (i, i + 1):
                assert np.abs(b[i * T:(i + 1) * T, j * T:(j + 1) * T]).max() <= 1e-4


@pytest.mark.parametrize("policy", ["wavefront", "lookahead"])
@pytest.mark.parametrize("executor", ["jax", "spill"])
def test_schedule_policies_match_jax(executor, policy):
    a = random_spd(80, seed=5)
    storage = "hbm" if executor == "jax" else "host"
    out, jout = _run_both(lambda pkg, **d: pkg.cholesky(a, tile=(T, T), storage=storage, **d),
                          executor, schedule_policy=policy)
    np.testing.assert_allclose(out.numpy(), jout.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("trsm_inv", [True, False])
def test_torch_task_executor_trsm_inv_and_rerun(trsm_inv):
    """Both trsm forms match JAX's; a second run() reuses the plan."""
    a = random_spd(64, seed=6)
    prog, out, _ = npw.cholesky(a, tile=(T, T), device="cpu")
    ex = TorchTaskExecutor(prog, trsm_inv=trsm_inv)
    assert ex.run() == PS.SUCCESS
    plan = ex._plan
    jprog, jout, _ = jnpw.cholesky(a, tile=(T, T))
    jexecutor.JaxTaskExecutor(jprog, trsm_inv=trsm_inv).run()
    np.testing.assert_allclose(out.numpy(), jout.numpy(), rtol=1e-4, atol=1e-5)
    assert ex.groups_run == len(plan[1]) > 0
    assert npw.run_program(prog, executor="jax") == PS.SUCCESS  # an already-finished program
    assert ex._plan is plan


# ---------------------------------------------------------------------------
# LocalExecutor: faults, duplicates, priority, resume
# ---------------------------------------------------------------------------

def test_local_executor_with_faults_and_duplicates_matches_jax(rng):
    """tests/test_failures.py's programs with tasks killed mid-flight and
    messages delivered twice: the same result as JAX's executor."""
    a = random_spd(96, seed=7)
    x = rng.standard_normal((160, T)).astype(np.float32)
    b = rng.standard_normal((96, 96)).astype(np.float32)
    binds = [lambda pkg, **d: pkg.cholesky(a, tile=(32, 32), storage="host", **d),
             lambda pkg, **d: pkg.gemm(b, b, tile=(32, 32), storage="host", **d),
             lambda pkg, **d: pkg.tsqr(x, tile_rows=32, storage="host", **d)]
    for bind in binds:
        prog, out, _ = bind(npw, device="cpu")
        ex = LocalExecutor(prog, num_workers=4, fault_rate=0.2, duplicate_rate=0.3, seed=11)
        assert ex.run(timeout=60) == PS.SUCCESS
        assert sorted(ex.execution_order) == list(range(prog.num_nodes))
        jprog, jout, _ = bind(jnpw)
        jexecutor.LocalExecutor(jprog, num_workers=4).run(timeout=60)
        got = npw.tsqr_r_factor(out) if isinstance(out, dict) else out.numpy()
        want = (np.asarray(jnpw.tsqr_r_factor(jout)) if isinstance(jout, dict)
                else jout.numpy())
        if isinstance(out, dict):
            got, want = _sign_fixed(got), _sign_fixed(want)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prioritize", [True, False])
def test_local_executor_order_matches_jax(prioritize):
    """One worker: the priority queue (or FIFO) visits the nodes in the
    JAX package's order, and the priority queue hoists the next panel's
    potrf above the bulk trailing updates."""
    a = random_spd(128, seed=8)
    prog, out, _ = npw.cholesky(a, tile=(T, T), storage="host", device="cpu")
    ex = LocalExecutor(prog, num_workers=1, prioritize=prioritize)
    assert ex.run() == PS.SUCCESS
    jprog, _, _ = jnpw.cholesky(a, tile=(T, T), storage="host")
    jex = jexecutor.LocalExecutor(jprog, num_workers=1, prioritize=prioritize)
    jex.run()
    assert ex.execution_order == jex.execution_order
    nodes = prog.dag.nodes
    order = {nid: i for i, nid in enumerate(ex.execution_order)}
    potrf1 = next(order[n.node_id] for n in nodes if n.op == "potrf" and n.var_values[0] == 1)
    last_syrk0 = max(order[n.node_id] for n in nodes if n.op == "syrk" and n.var_values[0] == 0)
    assert (potrf1 < last_syrk0) == prioritize
    l = np.tril(out.numpy())
    assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-5


@pytest.mark.parametrize("executor,storage", [("local", "hbm"), ("spill", "host")])
def test_resume_from_a_half_run_program(executor, storage):
    """tests/test_aux.py's resume contract: a program run by hand through
    its first wavefront levels reports them done, and a resume runs only
    the frontier to the same factor as JAX's."""
    a = random_spd(96, seed=9)
    prog, out, _ = npw.cholesky(a, tile=(T, T), storage=storage, device="cpu")
    f0 = checkpoint.program_frontier(prog)
    assert f0["done"] == []
    for level in prog.levels[:2]:
        for nid in level:
            execute_node_numpy(prog, nid)
    f1 = checkpoint.program_frontier(prog)
    assert set(prog.levels[0]) | set(prog.levels[1]) <= set(f1["done"])
    jprog, jout, _ = jnpw.cholesky(a, tile=(T, T), storage=storage)
    for level in jprog.levels[:2]:
        for nid in level:
            jexecutor.execute_node_numpy(jprog, nid)
    assert f1 == jcheckpoint.program_frontier(jprog)
    assert npw.run_program(prog, executor=executor, resume=True) == PS.SUCCESS
    jnpw.run_program(jprog, executor=executor, resume=True)
    np.testing.assert_allclose(out.numpy(), jout.numpy(), rtol=1e-4, atol=1e-5)


def test_spill_prefetch_event_order():
    """tests/test_lookahead.py's invariants: prefetch_issue(g+1) precedes
    compute(g), and group 1's gather finishes in the prefetch thread while
    the main thread waits at compute(0)."""
    import threading

    a = random_spd(96, seed=10)
    prog, out, _ = npw.cholesky(a, tile=(T, T), storage="host", device="cpu")
    events, done1 = [], threading.Event()

    def hook(kind, g):
        events.append((kind, g))
        if kind == "prefetch_done" and g == 1:
            done1.set()
        if kind == "compute" and g == 0:
            assert done1.wait(timeout=60), "prefetch(1) never finished while compute(0) waited"

    assert SpillTaskExecutor(prog, pipeline_width=2, on_event=hook).run() == PS.SUCCESS
    idx = {}
    for i, e in enumerate(events):
        idx.setdefault(e, i)
    n_groups = max(g for (k, g) in events if k == "compute") + 1
    for g in range(n_groups - 1):
        assert idx[("prefetch_issue", g + 1)] < idx[("compute", g)]
        assert idx[("compute", g)] < idx[("scatter", g)] < idx[("compute", g + 1)]
    l = np.tril(out.numpy())
    assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-5


# ---------------------------------------------------------------------------
# binops, the host tier, "auto"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["host", "hbm"])
def test_binops_match_jax(storage, rng):
    a = rng.standard_normal((100, 70)).astype(np.float32)
    b = rng.standard_normal((70, 90)).astype(np.float32)
    at, bt = (shard_matrix(x, tile=(32, 32), storage=storage, device="cpu") for x in (a, b))
    jat, jbt = (jshard(x, tile=(32, 32), storage=storage) for x in (a, b))
    pwex = binops.default_executor(4)
    c = binops.gemm(pwex, at, bt, tasks_per_job=3)
    pwex.shutdown()
    jc = jbinops.gemm(None, jat, jbt, tasks_per_job=3)
    assert c.storage == jc.storage == storage
    assert c.key == binops.gemm(None, at, bt).key  # deterministic output naming
    np.testing.assert_allclose(c.numpy(), jc.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c.numpy(), a @ b, rtol=1e-4, atol=1e-4)
    s = binops.sub(None, binops.add(None, at, at), at)
    np.testing.assert_allclose(s.numpy(), jbinops.sub(None, jbinops.add(None, jat, jat),
                                                      jat).numpy(), rtol=1e-6)
    u = binops.elemwise_uop(None, at, np.abs, torch.abs, name="abs")
    np.testing.assert_allclose(u.numpy(), np.abs(a), rtol=1e-6)


def test_host_tier_blocks_match_jax(rng):
    """The host tier's sparse block semantics, its tier moves, the mirrored
    TiledSymmetricMatrix and convert.from_reference of both."""
    a = random_spd(80, seed=11)
    m = shard_matrix(a, tile=(32, 32), storage="host", device="cpu", symmetric=True)
    jm = jshard(a, tile=(32, 32), storage="host", symmetric=True)
    assert m.block_idxs_exist == jm.block_idxs_exist
    np.testing.assert_array_equal(m.numpy(), jm.numpy())
    np.testing.assert_array_equal(m.to_hbm().numpy(), jm.to_hbm().numpy())
    for obj in (jm, jm.to_hbm(), jshard(a, tile=(32, 48), storage="host")):
        got = convert.from_reference(obj, device="cpu")
        assert type(got).__name__ == type(obj).__name__ and got.storage == obj.storage
        assert got.block_idxs_exist == obj.block_idxs_exist
        np.testing.assert_array_equal(got.numpy(), obj.numpy())
    h = npw.TiledMatrix(shape=(64, 64), tile=(32, 32), storage="host", device="cpu")
    with pytest.raises(BlockNotFoundError):
        h.get_block(0, 0)
    h.put_block(np.ones((32, 32), np.float32), 1, 0)
    assert h.block_idxs_exist == [(1, 0)] and h.to_hbm().block_idxs_exist == [(1, 0)]
    assert h.to_hbm().to_host().block_idxs_exist == [(1, 0)]
    with pytest.raises(ValueError, match="hbm"):
        h.array


USER_PROGRAM = """
def sym_sq(A, C, D, N):
    for i in range(0, N):
        for j in range(0, N):
            C[i, j] = gemm_nt(A[i, j], A[j, i])
    for i in range(0, N):
        for j in range(0, N):
            D[i, j] = add(C[i, j], C[j, i])
"""


@pytest.mark.parametrize("executor", ["auto", "local", "spill"])
def test_user_program_matches_jax(executor, rng):
    """A user's own DSL program has no fused lowering: "auto" runs it on
    the generic executor, in both packages."""
    from numpywren_tpu.frontend import lpcompile as jlpcompile
    from numpywren_tpu.tiled import TiledMatrix as JTiledMatrix
    from numpywren_tpu_torch.frontend import lpcompile

    a = rng.standard_normal((3 * T, 3 * T)).astype(np.float32)
    storage = "hbm" if executor == "auto" else "host"

    def bind(compile_, shard, new, **d):
        at = shard(a, tile=(T, T), storage=storage, **d)
        c, dm = (new(shape=a.shape, tile=(T, T), storage=storage, **d) for _ in range(2))
        return compile_(USER_PROGRAM).bind(A=at, C=c, D=dm, N=3), dm

    prog, d = bind(lpcompile, shard_matrix, npw.TiledMatrix, device="cpu")
    assert npw.run_program(prog, executor=executor) == PS.SUCCESS
    jprog, jd = bind(jlpcompile, jshard, JTiledMatrix)
    jnpw.run_program(jprog, executor=executor)
    np.testing.assert_allclose(d.numpy(), jd.numpy(), rtol=1e-4, atol=1e-4)
    blk = [[a[i * T:(i + 1) * T, j * T:(j + 1) * T] for j in range(3)] for i in range(3)]
    c = [[blk[i][j] @ blk[j][i].T for j in range(3)] for i in range(3)]
    np.testing.assert_allclose(d.numpy(), np.block([[c[i][j] + c[j][i] for j in range(3)]
                                                    for i in range(3)]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("storage", ["host", "hbm"])
def test_checkpoint_files_are_shared_with_jax(storage, tmp_path, rng):
    """save_matrix / load_matrix write one format: either package reads the
    other's file back to the same blocks and the same existing set."""
    a = rng.standard_normal((80, 80)).astype(np.float32)
    m = npw.TiledMatrix(shape=a.shape, tile=(32, 32), storage=storage, fill=None, device="cpu")
    jm = jnpw.TiledMatrix(shape=a.shape, tile=(32, 32), storage=storage,
                          **({"fill": None} if storage == "hbm" else {}))
    for (i, j) in [(0, 0), (2, 1), (1, 2)]:
        blk = a[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32]
        m.put_block(blk, i, j)
        jm.put_block(blk, i, j)
    checkpoint.save_matrix(m, str(tmp_path / "port.npz"))
    jcheckpoint.save_matrix(jm, str(tmp_path / "jax.npz"))
    for got, want in ((checkpoint.load_matrix(str(tmp_path / "jax.npz"), device="cpu"), jm),
                      (jcheckpoint.load_matrix(str(tmp_path / "port.npz")), m)):
        assert got.storage == "host" and got.block_idxs_exist == want.block_idxs_exist
        for (i, j) in want.block_idxs_exist:
            np.testing.assert_array_equal(_np(got.get_block(i, j)), _np(want.get_block(i, j)))


@pytest.mark.parametrize("program", ["gemm", "tsqr"])
def test_auto_streams_host_operands_over_the_budget(program, rng, monkeypatch):
    """"auto" on host-tier operands too large for the device-memory budget
    runs the spill executor (lower._spill_if_over_budget), as the JAX
    package does, with the same result as within the budget."""
    from numpywren_tpu_torch.compiler import lower

    x = rng.standard_normal((96, T)).astype(np.float32)

    def run():
        if program == "gemm":
            prog, c, _ = npw.gemm(x, x.T, tile=(T, T), storage="host", device="cpu")
            npw.run_program(prog)
            return c.numpy()
        prog, out, _ = npw.tsqr(x, tile_rows=32, storage="host", device="cpu")
        npw.run_program(prog)
        return _sign_fixed(npw.tsqr_r_factor(out))

    want = run()
    spilled = []
    monkeypatch.setattr(npw.default_config(), "hbm_budget_bytes", 4096)
    monkeypatch.setattr(SpillTaskExecutor, "run",
                        lambda self, _run=SpillTaskExecutor.run, **kw: spilled.append(1)
                        or _run(self, **kw))
    np.testing.assert_allclose(run(), want, rtol=1e-4, atol=1e-4)
    assert spilled == [1] and lower._hbm_budget_bytes() < 4096


def test_auto_on_bdfac_names_the_queue_item(rng, monkeypatch):
    """"auto" and "fused" on bdfac run the fused lowering (its runner is
    called once, the generic executor never), B as the JAX package's fused
    B (rel Frobenius <= 1e-4); a program with no fused lowering still
    raises under "fused"."""
    from numpywren_tpu_torch.compiler import lower
    from numpywren_tpu_torch.frontend import lpcompile

    calls = []
    monkeypatch.setattr(lower, "_run_fused_bdfac",
                        lambda p, _run=lower._run_fused_bdfac: calls.append(1) or _run(p))
    monkeypatch.setattr(TorchTaskExecutor, "run", lambda self, **kw: pytest.fail("generic"))
    x = rng.standard_normal((3 * T, 3 * T)).astype(np.float32)
    jprog, jb, _ = jnpw.bdfac(x, tile=(T, T))
    jnpw.run_program(jprog, executor="fused")
    for executor in ("auto", "fused"):
        prog, b, _ = npw.bdfac(x, tile=(T, T), device="cpu")
        assert npw.run_program(prog, executor=executor) == PS.SUCCESS
        assert np.linalg.norm(b.numpy() - jb.numpy()) <= 1e-4 * np.linalg.norm(jb.numpy())
    assert calls == [1, 1]
    m = shard_matrix(x, tile=(T, T), device="cpu")
    c, d = (npw.TiledMatrix(shape=x.shape, tile=(T, T), device="cpu") for _ in range(2))
    prog = lpcompile(USER_PROGRAM).bind(A=m, C=c, D=d, N=3)
    with pytest.raises(ValueError, match="no fused lowering"):
        npw.run_program(prog, executor="fused")


@pytest.mark.parametrize("executor", ["jax", "spill"])
def test_executor_precision_matches_default(executor):
    """precision= (and donate= on "jax") reach the executors through
    run_program, as in the reference; the batched ops have no product it
    changes, so "highest" gives the default run's result exactly."""
    a = random_spd(64, seed=12)
    storage = "hbm" if executor == "jax" else "host"
    outs = []
    donate = {"donate": False} if executor == "jax" else {}
    for kw in ({}, {"precision": "highest", **donate}):
        prog, out, _ = npw.cholesky(a, tile=(T, T), storage=storage, device="cpu")
        assert npw.run_program(prog, executor=executor, **kw) == PS.SUCCESS
        outs.append(out.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    jprog, jout, _ = jnpw.cholesky(a, tile=(T, T), storage=storage)
    jnpw.run_program(jprog, executor=executor, precision="highest")
    np.testing.assert_allclose(outs[1], jout.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cls", [TorchTaskExecutor, SpillTaskExecutor])
def test_executor_rejects_an_invalid_precision(cls):
    prog, _, _ = npw.cholesky(random_spd(32, seed=13), tile=(T, T), device="cpu")
    with pytest.raises(ValueError, match="precision must be one of"):
        cls(prog, precision="bogus")
    ex = cls(prog, precision="default")
    assert ex.precision == "default"
