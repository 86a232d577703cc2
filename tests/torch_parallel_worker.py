"""Rank processes for the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_distributed.py), as
tests/distributed_worker.py is the JAX package's.

Each rank joins a gloo group through numpywren_tpu_torch.parallel.distributed
(NPW_COORDINATOR / NPW_NUM_PROCESSES / NPW_PROCESS_ID; NPW_MESH_SHAPE and
NPW_COMPENSATED configure the port) and imports only the port. "parallel"
runs the sharded entry points on <dir>/inputs.npz, at "high" and then under
NPW_COMPENSATED=1, and rank 0 writes what the ranks computed (full_tensor()
of each result, every rank's block geometry) to <dir>/out.npz. "fabric"
runs the block-cyclic Cholesky, the sharded CholeskyQR, the butterfly TSQR
and the out-of-core Cholesky on meshes of rank subsets, and rank 0 writes
what they computed to <dir>/out.npz. "distributed" runs the multi-process
helpers and checks them against numpy. All print "WORKER_OK <rank>" last.

`start` forks the ranks from a forkserver that has imported torch and the
port once (eight fresh interpreters would import them eight times), each
rank writing its output to <dir>/rank<r>.log; `finish` waits for them and
fails with every failing rank's output; `launch` does both. By hand, one
process a rank with the NPW_* variables set:

    python tests/torch_parallel_worker.py parallel|fabric|distributed <dir>
"""

import json
import multiprocessing
import os
import socket
import sys
import time

# what the forkserver imports once, before it forks the ranks
PRELOAD = ["torch", "torch.distributed.tensor", "numpywren_tpu_torch.parallel",
           "numpywren_tpu_torch.matrix_init", "torch_parallel_worker"]


def _rank(mode: str, workdir: str, env: dict, rank: int) -> None:
    """One rank, forked from the forkserver: its output to <dir>/rank<r>.log,
    its NPW_* variables from `env` (the port reads its config afresh)."""
    fd = os.open(os.path.join(workdir, f"rank{rank}.log"), os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    for k in [k for k in os.environ if k.startswith("NPW_")]:
        del os.environ[k]
    os.environ.update(env)
    import torch

    from numpywren_tpu_torch import config

    torch.set_num_threads(1)
    config._default = None
    run(mode, workdir)


def start(mode: str, ranks: int, workdir: str, env=None):
    """Start `ranks` processes of `mode` as one gloo group on a free
    localhost port; `finish` waits for them. The forkserver starts with
    OMP_NUM_THREADS=1, which its OpenMP runtime reads once, when torch
    loads: torch.set_num_threads(1) in a rank does not reach every
    OpenMP region (the ranks' small LAPACK calls then spin 8 threads a
    rank, the BDFAC cases 30x slower)."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = []
        for rank in range(ranks):
            e = dict(env or {}, NPW_COORDINATOR=f"127.0.0.1:{port}",
                     NPW_NUM_PROCESSES=str(ranks), NPW_PROCESS_ID=str(rank))
            procs.append(ctx.Process(target=_rank, args=(mode, workdir, e, rank)))
            procs[-1].start()
    finally:
        if saved is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    return workdir, procs


def finish(started, timeout: int = 240):
    """Wait for the ranks (killing any still running after `timeout`
    seconds); fail with every failing rank's output."""
    workdir, procs = started
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    outs = []
    for r in range(len(procs)):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            outs.append(f.read())
    bad = [f"rank {r} (exit {p.exitcode}):\n{out[-3000:]}"
           for r, (p, out) in enumerate(zip(procs, outs))
           if p.exitcode != 0 or f"WORKER_OK {r}" not in out]
    assert not bad, "\n".join(bad)
    return outs


def launch(mode: str, ranks: int, workdir: str, env=None, timeout: int = 240):
    """start, then finish."""
    return finish(start(mode, ranks, workdir, env), timeout)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _boxes(np, dt):
    """Every rank's (rank, row offset, rows, col offset, cols) of the
    DTensor `dt`'s local block, in mesh order, on every rank of its mesh."""
    import torch

    from numpywren_tpu_torch.parallel.mesh import NamedSharding, local_box, sum_over_mesh

    mesh = dt.device_mesh
    (r0, rs), (c0, cs) = local_box(dt.shape, NamedSharding(mesh, tuple(dt.placements)))
    assert tuple(dt.to_local().shape) == (rs, cs)
    p, q = mesh.get_coordinate()
    rows = torch.zeros((mesh.size(), 5), dtype=torch.int64)
    rows[p * mesh.shape[1] + q] = torch.tensor([int(mesh.mesh[p, q]), r0, rs, c0, cs])
    return sum_over_mesh(rows, mesh).numpy()


def run_parallel(workdir: str) -> None:
    import numpy as np

    from numpywren_tpu_torch import config
    from numpywren_tpu_torch.exceptions import ShapeError
    from numpywren_tpu_torch.parallel import (distributed, make_mesh, sharded_cholesky,
                                              sharded_gemm, sharded_tsqr, tile_sharding)
    from numpywren_tpu_torch.parallel.fabric import (bdfac_1d, bdfac_2d, cholesky_1d, cholesky_2d,
                                                     cholqr2_sharded, cholqr3s_sharded,
                                                     summa_gemm, summa_syrk, tsqr_butterfly)

    assert distributed.initialize(), "expected a multi-process run"
    rank = distributed.process_index()
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    out = {}
    mesh = make_mesh(device="cpu")  # NPW_MESH_SHAPE=2x4
    out["mesh_shape"] = np.array(mesh.shape)
    out["mesh_axes"] = np.array(mesh.mesh_dim_names)
    mesh4 = make_mesh(devices=[0, 1, 2, 3], shape=(2, 2), device="cpu")
    for mode in ("high", "compensated"):
        os.environ["NPW_COMPENSATED"] = "1" if mode == "compensated" else "0"
        config._default = None  # re-read the environment
        assert config.default_config().compensated == (mode == "compensated")
        l = sharded_cholesky(inp["spd"], tile=64, mesh=mesh)
        out[f"{mode}/chol"] = l.full_tensor().numpy()
        out[f"{mode}/chol_boxes"] = _boxes(np, l)
        lt = sharded_cholesky(inp["spd"], tile=64, mesh=mesh, truncate=2)
        out[f"{mode}/chol_truncate"] = lt.full_tensor().numpy()
        c = sharded_gemm(inp["gemm_a"], inp["gemm_b"], mesh=mesh)
        out[f"{mode}/gemm"] = c.full_tensor().numpy()
        out[f"{mode}/gemm_boxes"] = _boxes(np, c)
        for leaves in (8, 11):
            r = sharded_tsqr(inp[f"tsqr_{leaves}"], tile_rows=64, mesh=mesh)
            out[f"{mode}/tsqr_{leaves}"] = r.full_tensor().numpy()
        q, r = sharded_tsqr(inp["tsqr_q"], tile_rows=64, mesh=mesh, compute_q=True)
        out[f"{mode}/tsqr_q_q"] = q.full_tensor().numpy()
        out[f"{mode}/tsqr_q_r"] = r.full_tensor().numpy()
        out[f"{mode}/tsqr_q_boxes"] = _boxes(np, q)
        if rank < 4:  # the 2x2 mesh of ranks 0-3, as the reference's jax.devices()[:4]
            c = summa_gemm(inp["summa_a"], inp["summa_b"], mesh=mesh4)
            out[f"{mode}/summa"] = distributed.full_tensor(c).numpy()
            c2 = summa_gemm(inp["summa_sq"], inp["summa_sq"], mesh=mesh4)
            out[f"{mode}/summa_sq_boxes"] = _boxes(np, c2)
            out[f"{mode}/syrk"] = distributed.full_tensor(
                summa_syrk(inp["syrk_s"], inp["syrk_p"], mesh=mesh4)).numpy()
        try:
            summa_gemm(inp["summa_sq"], inp["summa_sq"], mesh=mesh)
            out[f"{mode}/summa_nonsquare_raised"] = np.array(False)
        except ShapeError:
            out[f"{mode}/summa_nonsquare_raised"] = np.array(True)
    # each fabric name of ROADMAP Queue 1 #6b-#6c, with an argument the
    # reference refuses: the exception's name
    for name, call in (
        ("bdfac_1d", lambda: bdfac_1d(np.ones((64, 32), np.float32), mesh=mesh)),
        ("bdfac_2d", lambda: bdfac_2d(inp["spd"], mesh=mesh, tile=96)),
        ("cholesky_1d", lambda: cholesky_1d(np.ones((64, 32), np.float32), mesh=mesh)),
        ("cholesky_2d", lambda: cholesky_2d(inp["spd"], mesh=mesh, panel=96)),
        ("cholqr2_sharded", lambda: cholqr2_sharded(np.ones((100, 8), np.float32), mesh=mesh)),
        ("cholqr3s_sharded", lambda: cholqr3s_sharded(np.ones((100, 8), np.float32), mesh=mesh)),
        ("tsqr_butterfly", lambda: tsqr_butterfly(inp["tsqr_8"], mesh=mesh, b_fac=1)),
    ):
        try:
            call()
            out[f"bad_args/{name}"] = np.array("none")
        except Exception as e:  # the test names the one expected
            out[f"bad_args/{name}"] = np.array(type(e).__name__)
    config._default = None
    os.environ["NPW_COMPENSATED"] = "0"
    _store_cases(np, inp, out, mesh, tile_sharding(mesh))
    # the configured mesh shape (tests/test_spill.py's mesh_shape case)
    cfg = config.default_config()
    cfg.mesh_shape = (1, 8)
    out["mesh_cfg_1x8"] = np.array(make_mesh(device="cpu").shape)
    cfg.mesh_shape = (3, 5)  # a shape for another rank count: the most-square one
    out["mesh_cfg_3x5"] = np.array(make_mesh(device="cpu").shape)
    try:  # an explicit shape for another rank count
        make_mesh(shape=(3, 3), device="cpu")
        out["mesh_bad_shape_raised"] = np.array(False)
    except ValueError:
        out["mesh_bad_shape_raised"] = np.array(True)
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m.split(".")[0] == "numpywren_tpu"]
    assert not bad, f"rank {rank} imported {bad[:5]}"
    distributed.sync()
    if rank == 0:
        np.savez(os.path.join(workdir, "out.npz"), **out)
    distributed.sync()


def _store_cases(np, inp, out, mesh, sh):
    """The store's sharding= arguments: shard_matrix (also symmetric),
    TiledMatrix(sharding=) with get_block/put_block, and to_hbm(sharding=)
    from the host tier, the unsharded device tier and the trapezoid tier,
    and from a sharded tier to its own layout (another one raises)."""
    import torch

    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.tiled import TiledMatrix
    from numpywren_tpu_torch.trapezoid import TiledTrapezoidMatrix, TrapezoidMatrix

    from numpywren_tpu_torch.parallel import distributed
    from numpywren_tpu_torch.parallel.mesh import replicated

    x = inp["store"]  # (200, 136): padded (224, 160), whose rank blocks split tiles
    m = shard_matrix(x, tile=(32, 32), sharding=sh)
    out["store/boxes"] = _boxes(np, m.array)
    out["store/numpy"] = m.numpy()
    out["store/blocks"] = np.stack([m.get_block(i, j).numpy() for (i, j) in m.block_idxs])
    m.put_block(inp["store_tile"], 3, 2)
    out["store/after_put"] = m.numpy()
    out["store/written"] = np.array(m.block_idxs_exist)
    s = shard_matrix(inp["spd"][:200, :200], tile=(32, 32), sharding=sh, symmetric=True)
    out["store/symmetric_full"] = distributed.full_tensor(s.array).numpy()
    t = TiledMatrix(shape=(200, 136), tile=(32, 32), sharding=sh)
    t.put_block(inp["store_tile"], 3, 2)
    t.put_block(inp["store_tile"][:8, :], 6, 0)  # an edge block, its true shape
    out["store/put_get"] = t.get_block(3, 2).numpy()
    out["store/put_edge"] = t.get_block(6, 0).numpy()
    out["store/put_numpy"] = t.numpy()
    host = shard_matrix(x, tile=(32, 32), storage="host", device="cpu")
    h = host.to_hbm(sharding=sh)
    out["store/to_hbm"] = h.numpy()
    out["store/to_hbm_boxes"] = _boxes(np, h.array)
    out["store/to_hbm_back"] = h.to_host().numpy()
    out["store/to_hbm_same"] = h.to_hbm().numpy()  # a sharded tier keeps its layout
    dev = shard_matrix(x, tile=(32, 32), device="cpu")  # the unsharded device tier
    hd = dev.to_hbm(sharding=sh)
    out["store/dev_to_hbm"] = hd.numpy()
    out["store/dev_to_hbm_boxes"] = _boxes(np, hd.array)
    try:  # another layout of a sharded tier would pass the whole array through each rank
        h.to_hbm(sharding=replicated(sh.mesh))
        out["store/relayout_raised"] = np.array(False)
    except ValueError:
        out["store/relayout_raised"] = np.array(True)
    trap = TiledTrapezoidMatrix(
        TrapezoidMatrix.from_array(torch.from_numpy(inp["spd"]), panel=64, device="cpu"),
        tile=32, symmetric=True)
    th = trap.to_hbm(sharding=sh)
    out["store/trap_to_hbm"] = distributed.full_tensor(th.array).numpy()
    out["store/trap_boxes"] = _boxes(np, th.array)


def run_distributed(workdir: str) -> None:
    """tests/distributed_worker.py's checks, on the port: host-0 data
    broadcast, the sharded Cholesky and GEMM over the mesh of every rank,
    each rank binding its own rows with host_local_array, gather_to_hosts
    of a per-rank array, and a final barrier."""
    import numpy as np

    from numpywren_tpu_torch.matrix_init import random_spd
    from numpywren_tpu_torch.parallel import (distributed, make_mesh, mesh_sharding,
                                              sharded_cholesky, sharded_gemm)
    from numpywren_tpu_torch.parallel.mesh import P

    assert distributed.initialize(), "expected a multi-process run"
    n_procs = int(os.environ["NPW_NUM_PROCESSES"])
    assert distributed.process_count() == n_procs and distributed.is_multi_host()
    assert distributed.initialize()  # idempotent
    rank = distributed.process_index()
    mesh = make_mesh(device="cpu")
    assert mesh.size() == n_procs

    # identical input everywhere (host-0 data broadcast, the S3-read analog)
    a_local = random_spd(512, seed=3) if rank == 0 else np.zeros((1,), np.float64)
    a = distributed.broadcast_from_host0(a_local)
    assert a.dtype == np.float32 and a.shape == (512, 512)
    np.testing.assert_array_equal(a, random_spd(512, seed=3))

    l = sharded_cholesky(a, tile=64, mesh=mesh)
    l_np = distributed.gather_to_hosts(l)
    res = np.linalg.norm(l_np @ l_np.T - a) / np.linalg.norm(a)
    assert res < 1e-4, f"cholesky residual {res}"

    c_np = distributed.gather_to_hosts(sharded_gemm(a, a, mesh=mesh))
    ref = a.astype(np.float64) @ a.astype(np.float64)
    err = np.abs(c_np - ref).max() / np.abs(ref).max()
    assert err < 1e-4, f"gemm error {err}"

    # each rank binds only its own rows: the mesh rows split them, the
    # mesh columns replicate them
    sh = mesh_sharding(mesh, P(mesh.mesh_dim_names[0], None))
    rows = 512 // mesh.shape[0]
    p = mesh.get_coordinate()[0]
    g = distributed.host_local_array(a[p * rows:(p + 1) * rows], (512, 512), sh)
    assert tuple(g.shape) == (512, 512) and tuple(g.to_local().shape) == (rows, 512)
    np.testing.assert_array_equal(distributed.gather_to_hosts(g), a)
    per_rank = np.full((2, 3), float(rank))
    np.testing.assert_array_equal(distributed.gather_to_hosts(per_rank),
                                  np.repeat(np.arange(n_procs, dtype=float), 2)[:, None]
                                  * np.ones((1, 3)))
    np.testing.assert_array_equal(distributed.gather_to_hosts(np.float64(rank)),
                                  np.arange(n_procs, dtype=float))
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m.split(".")[0] == "numpywren_tpu"]
    assert not bad, f"rank {rank} imported {bad[:5]}"
    distributed.sync("npw_test_done")


# the fabric cases' meshes, made on every rank in this order: (1, p) for the
# one-axis cases, then the 2-D shapes, each on ranks 0 .. r*c - 1
FABRIC_MESHES = [(1, 1), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (2, 2), (2, 3),
                 (2, 4), (4, 2)]


def run_fabric(workdir: str) -> None:
    """tests/test_fabric.py's block-cyclic Cholesky, sharded CholeskyQR,
    butterfly TSQR and distributed BDFAC cases, tests/test_spill.py's
    out-of-core Cholesky and BDFAC on a mesh, singular_values(mesh=) and
    the dry run, on the meshes of FABRIC_MESHES (each made collectively,
    every case run by the ranks of its mesh) with inputs from
    <dir>/inputs.npz. Rank 0 writes the results (whole factors, R, Q, B,
    sigma, logs) to out.npz."""
    import numpy as np
    import torch

    from numpywren_tpu_torch import config
    from numpywren_tpu_torch.compiler import lower
    from numpywren_tpu_torch.compiler.lower import fused_tsqr
    from numpywren_tpu_torch.exceptions import ShapeError
    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.parallel import distributed, make_mesh
    from numpywren_tpu_torch.parallel.distributed import full_tensor
    from numpywren_tpu_torch.parallel.fabric import (cholesky_1d, cholesky_2d, cholqr2_sharded,
                                                     cholqr3s_sharded, tsqr_butterfly)
    from numpywren_tpu_torch.parallel.mesh import sum_over_mesh
    from numpywren_tpu_torch.runtime import out_of_core_cholesky

    assert distributed.initialize(), "expected a multi-process run"
    rank = distributed.process_index()
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    meshes = {shape: make_mesh(devices=list(range(shape[0] * shape[1])), shape=shape,
                               device="cpu") for shape in FABRIC_MESHES}
    mesh8 = meshes[(2, 4)]
    out = {}

    def on(shape):
        return rank < shape[0] * shape[1]

    def chol(fn, key, a, shape, **kw):
        if on(shape):
            out[key] = fn(inp[a], mesh=meshes[shape], panel=kw.pop("panel", 16), **kw).numpy()

    # butterfly TSQR
    for p in (2, 4, 8):
        if on((1, p)):
            out[f"bf/{p}"] = tsqr_butterfly(inp[f"bf/{p}"], mesh=meshes[(1, p)]).to_local().numpy()
    for p, b_fac in ((6, 4), (5, 3), (6, 2), (8, 4), (8, 8), (7, 2)):
        if on((1, p)):
            out[f"bf_ragged/{p}_{b_fac}"] = tsqr_butterfly(
                inp[f"bf_ragged/{p}"], mesh=meshes[(1, p)], axis="cols", b_fac=b_fac
            ).to_local().numpy()
    if on((1, 6)):
        st = tsqr_butterfly(inp["bf_same"], mesh=meshes[(1, 6)], axis="cols", b_fac=4,
                            _return_stacked=True)
        out["bf_same"] = full_tensor(st).numpy()
        out["bf_same_shape"] = np.array(st.shape)
    if on((1, 4)):
        try:
            tsqr_butterfly(inp["bf_bad"], mesh=meshes[(1, 4)], axis="cols", b_fac=1)
            out["bf_bad_raised"] = np.array(False)
        except ShapeError:
            out["bf_bad_raised"] = np.array(True)
    out["bf_vs_fused"] = tsqr_butterfly(inp["bf_vs_fused"], mesh=meshes[(1, 8)]).to_local().numpy()
    out["bf_vs_fused/fused"] = fused_tsqr(torch.from_numpy(inp["bf_vs_fused"]), 32).numpy()
    out["bf_flat_2x4"] = tsqr_butterfly(inp["bf_vs_fused"], mesh=mesh8).to_local().numpy()

    # CholeskyQR over row shards
    for p in (4, 8):
        if on((1, p)):
            q, r = cholqr2_sharded(inp[f"cq2/{p}"], mesh=meshes[(1, p)], compute_q=True)
            out[f"cq2/{p}/q"], out[f"cq2/{p}/r"] = full_tensor(q).numpy(), r.to_local().numpy()
    out["cq2_r_only"] = cholqr2_sharded(inp["cq2_r_only"], mesh=mesh8).to_local().numpy()
    if on((1, 4)):
        lower.reset_chain_passes()
        q, r = cholqr3s_sharded(inp["cq3s_robust"], mesh=meshes[(1, 4)], compute_q=True)
        passes = torch.zeros((4, 2), dtype=torch.int64)
        passes[rank] = torch.tensor([lower.CHAIN_PASSES["chains"], lower.CHAIN_PASSES["extras"]])
        out["cq3s_robust/passes"] = sum_over_mesh(passes, meshes[(1, 4)]).numpy()
        out["cq3s_robust/q"], out["cq3s_robust/r"] = full_tensor(q).numpy(), r.to_local().numpy()
        q2 = cholqr2_sharded(inp["cq3s_robust"], mesh=meshes[(1, 4)], compute_q=True)[0]
        out["cq3s_robust/q2"] = full_tensor(q2).numpy()
    q, r = cholqr3s_sharded(inp["cq3s_wellcond"], mesh=meshes[(1, 8)], compute_q=True)
    out["cq3s_wellcond/q"], out["cq3s_wellcond/r"] = full_tensor(q).numpy(), r.to_local().numpy()

    # block-cyclic Cholesky
    for la in (False, True):
        for nb, p in ((8, 8), (8, 4), (10, 4), (3, 8)):
            chol(cholesky_1d, f"c1d/{nb}_{p}/{la}", f"c1d/{nb}_{p}", (1, p), lookahead=la)
        for (r, c), nb in (((2, 2), 6), ((2, 4), 8), ((2, 2), 5), ((1, 4), 7), ((4, 2), 4)):
            chol(cholesky_2d, f"c2d/{r}x{c}_{nb}/{la}", f"c2d/{r}x{c}_{nb}", (r, c), lookahead=la)
        if on((1, 4)):
            log = []
            out[f"c1d_order/{la}"] = cholesky_1d(inp["c1d_order"], mesh=meshes[(1, 4)], panel=16,
                                                 lookahead=la, schedule_log=log).numpy()
            out[f"c1d_order/{la}/log"] = np.array([repr(e) for e in log])
            log = []
            out[f"c2d_order/{la}"] = cholesky_2d(inp["c2d_order"], mesh=meshes[(2, 2)], panel=16,
                                                 lookahead=la, schedule_log=log).numpy()
            out[f"c2d_order/{la}/log"] = np.array([repr(e) for e in log])
    clog = []
    out["c2d_volume"] = cholesky_2d(inp["c2d_volume"], mesh=mesh8, panel=16,
                                    collective_log=clog).numpy()
    out["c2d_volume/clog"] = np.array([repr(e) for e in clog])
    if on((2, 2)):
        os.environ["NPW_COMPENSATED"] = "1"
        config._default = None
        try:
            assert config.default_config().compensated
            out["c2d_compensated"] = cholesky_2d(inp["c2d_compensated"], mesh=meshes[(2, 2)],
                                                 panel=32).numpy()
        finally:
            os.environ["NPW_COMPENSATED"] = "0"
            config._default = None
        for fn in (cholesky_1d, cholesky_2d):
            key = f"gather/{fn.__name__}"
            out[f"{key}/device"] = fn(inp["gather"], mesh=meshes[(2, 2)], panel=32).numpy()
            host = fn(inp["gather"], mesh=meshes[(2, 2)], panel=32, gather="host")
            out[f"{key}/is_ndarray"] = np.array(isinstance(host, np.ndarray))
            out[f"{key}/host"] = np.asarray(host)

    # the out-of-core Cholesky on the mesh of every rank
    at = shard_matrix(inp["ooc_mesh"], tile=(64, 64), storage="host", device="cpu")
    out["ooc_mesh"] = out_of_core_cholesky(at, panel_tiles=4, mesh=mesh8).numpy()
    ck = os.path.join(workdir, "ck")
    calls = {"n": 0}

    class Boom(Exception):
        pass

    def bomb(kind, s):
        if kind == "factor":
            calls["n"] += 1
            if calls["n"] == 2:
                raise Boom()

    try:
        out_of_core_cholesky(shard_matrix(inp["ooc_resume"], tile=(32, 32), storage="host",
                                          device="cpu"),
                             panel_tiles=4, mesh=mesh8, checkpoint_dir=ck, on_event=bomb)
        out["ooc_resume/bomb_fired"] = np.array(False)
    except Boom:
        out["ooc_resume/bomb_fired"] = np.array(True)
    distributed.sync()  # rank 0 has written its checkpoint
    with open(os.path.join(ck, "manifest.json")) as f:
        out["ooc_resume/panels_done"] = np.array(json.load(f)["panels_done"])
    at2 = shard_matrix(inp["ooc_resume"], tile=(32, 32), storage="host", device="cpu")
    l2 = out_of_core_cholesky(at2, panel_tiles=4, mesh=mesh8, checkpoint_dir=ck)
    out["ooc_resume"] = l2.numpy()
    out["ooc_resume/panels_run"] = np.array(l2.spill_stats["panels"])

    _bdfac_cases(np, inp, out, meshes, rank)

    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m.split(".")[0] == "numpywren_tpu"]
    assert not bad, f"rank {rank} imported {bad[:5]}"
    distributed.sync()
    if rank == 0:
        np.savez(os.path.join(workdir, "out.npz"), **out)
    distributed.sync()


def _same_on_ranks(np, x, mesh) -> bool:
    """Whether every rank of `mesh` holds the same bits of the array `x`
    (each rank's copy summed into its own slot). Collective over it."""
    import torch

    from numpywren_tpu_torch.parallel.mesh import flat_index, sum_over_mesh

    slots = torch.zeros((mesh.size(),) + np.shape(x), dtype=torch.float64)
    slots[flat_index(mesh)] = torch.as_tensor(np.ascontiguousarray(x, np.float64))
    sum_over_mesh(slots, mesh)
    return bool((slots == slots[0]).all())


def _bdfac_cases(np, inp, out, meshes, rank) -> None:
    """tests/test_fabric.py's distributed BDFAC cases, tests/test_models.py's
    singular_values(mesh=), tests/test_spill.py's out-of-core BDFAC on the
    mesh of every rank, singular_values on a mesh of rank 0 alone, and the
    dry run on the 2 x 4 mesh."""
    import torch

    from numpywren_tpu_torch import config
    from numpywren_tpu_torch.compiler.lower import fused_bdfac
    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.models import singular_values
    from numpywren_tpu_torch.parallel.dryrun import dryrun_multichip
    from numpywren_tpu_torch.parallel.fabric import bdfac_1d, bdfac_2d
    from numpywren_tpu_torch.runtime.spill import out_of_core_bdfac

    def on(shape):
        return rank < shape[0] * shape[1]

    def dense(fn, key, g, shape, tile=32, **kw):
        if on(shape):
            out[key] = fn(inp[g], mesh=meshes[shape], tile=tile, **kw).numpy()

    def logged(fn, key, g, shape, **kw):
        if on(shape):
            clog, slog = [], []
            dense(fn, key, g, shape, collective_log=clog, schedule_log=slog, **kw)
            out[f"{key}/clog"] = np.array([repr(e) for e in clog])
            out[f"{key}/slog"] = np.array([repr(e) for e in slog])

    def band(fn, key, g, shape):
        if on(shape):
            diags, sups = fn(inp[g], mesh=meshes[shape], tile=32, return_band=True)
            out[f"{key}/diags"], out[f"{key}/sups"] = np.stack(diags), np.stack(sups[:-1])
            out[f"{key}/last_sup_none"] = np.array(sups[-1] is None)
            out[f"{key}/same_on_ranks"] = np.array(
                _same_on_ranks(np, np.concatenate([np.stack(diags).ravel(),
                                                   np.stack(sups[:-1]).ravel()]), meshes[shape]))

    for p, tile in ((4, 32), (3, 32), (8, 16)):
        dense(bdfac_1d, f"bd1_sigma/{p}_{tile}", "g192", (1, p), tile=tile)
    dense(bdfac_1d, "bd1_band", "g192", (1, 4))
    if rank == 0:
        out["bd1_band/fused"] = fused_bdfac(torch.from_numpy(inp["g192"]), 32).numpy()
    logged(bdfac_1d, "bd1_volume", "g128", (1, 4))
    dense(bdfac_1d, "bd1_return_band", "g128", (1, 4))
    band(bdfac_1d, "bd1_return_band", "g128", (1, 4))
    for la in (False, True):
        logged(bdfac_1d, f"bd1_lookahead/{la}", "g160", (1, 4), lookahead=la)
    for shape in ((2, 2), (2, 4), (2, 3)):
        dense(bdfac_2d, f"bd2_sigma/{shape[0]}x{shape[1]}", "g192", shape)
    dense(bdfac_2d, "bd2_blocks", "g192", (2, 2))
    band(bdfac_2d, "bd2_blocks", "g192", (2, 2))
    logged(bdfac_2d, "bd2_volume", "g192", (2, 4))
    for la in (False, True):
        dense(bdfac_2d, f"bd2_lookahead/{la}", "g192", (2, 2), lookahead=la)
        logged(bdfac_2d, f"bd2_order/{la}", "g128", (2, 2), lookahead=la)
    if on((2, 2)):
        os.environ["NPW_COMPENSATED"] = "1"
        config._default = None
        try:
            assert config.default_config().compensated
            dense(bdfac_2d, "bd2_compensated", "g128", (2, 2))
        finally:
            os.environ["NPW_COMPENSATED"] = "0"
            config._default = None

    # singular_values(mesh=): 2-D and flat meshes, every rank the same sigma
    for shape in ((1, 4), (2, 2)):
        if on(shape):
            key = f"sv_mesh/{shape[0]}x{shape[1]}"
            out[key] = singular_values(inp["g192"], tile=32, mesh=meshes[shape])
            out[f"{key}/same_on_ranks"] = np.array(_same_on_ranks(np, out[key], meshes[shape]))
    if on((2, 2)):
        out["sv_mesh_jax_shape"] = singular_values(inp["g128"], tile=32, mesh=meshes[(2, 2)])
        for name, x in (("ragged", inp["g192"][:190, :190]), ("rect", inp["g192"][:, :96])):
            try:
                singular_values(x, tile=32, mesh=meshes[(2, 2)])
                out[f"sv_mesh/{name}_raised"] = np.array("none")
            except Exception as e:  # the test names the one expected
                out[f"sv_mesh/{name}_raised"] = np.array(type(e).__name__)
    # a mesh of rank 0 alone: the single-device path
    if rank == 0:
        try:
            out["sv_one_rank"] = singular_values(inp["g128"], tile=32, mesh=meshes[(1, 1)],
                                                 device="cpu")
            out["sv_one_rank/error"] = np.array("none")
        except Exception as e:
            out["sv_one_rank/error"] = np.array(f"{type(e).__name__}: {e}")
        out["sv_one_rank/single"] = singular_values(inp["g128"], tile=32, device="cpu")

    # the out-of-core BDFAC on the mesh of every rank
    mesh8 = meshes[(2, 4)]
    at = shard_matrix(inp["ooc_bdfac"], tile=(16, 16), storage="host", device="cpu")
    b = out_of_core_bdfac(at, panel_tiles=4, mesh=mesh8).numpy()
    out["ooc_bdfac_mesh"] = b
    out["ooc_bdfac_mesh/same_on_ranks"] = np.array(_same_on_ranks(np, b, mesh8))

    # the dry run's ten stages on the 2 x 4 mesh
    res = dryrun_multichip(mesh8)
    out["dryrun/stages"] = np.array(sorted(res))
    out["dryrun/values"] = np.array([res[k] for k in sorted(res)])


def run(mode: str, workdir: str) -> None:
    {"parallel": run_parallel, "distributed": run_distributed, "fabric": run_fabric}[mode](workdir)
    import torch.distributed as dist

    from numpywren_tpu_torch.parallel import distributed

    rank = distributed.process_index()
    dist.destroy_process_group()
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2])
