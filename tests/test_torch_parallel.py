"""The port's multi-device layer (numpywren_tpu_torch.parallel) against the
JAX package's (numpywren_tpu.parallel), on the CPU.

The JAX package runs on the 8 virtual CPU devices of tests/conftest.py, in
this process; the port runs in ONE gloo group of 8 ranks for the module
(tests/torch_parallel_worker.py, NPW_MESH_SHAPE=2x4), the 2x2 cases on the
mesh of ranks 0-3 as the reference takes jax.devices()[:4]. Both get the
same seeded numpy inputs, at "high" and compensated. Tolerances: the GEMMs
within 1e-5 relative Frobenius of JAX's; the Cholesky factor within rtol
1e-4, atol 1e-5 (tests/test_torch_entry.py's); the sign-fixed TSQR R and Q
within 1e-4 relative Frobenius; each case also holds the reference test's
own bars (tests/test_sharded.py, tests/test_fabric.py) against numpy or
scipy. Under compensated the GEMMs are held instead as
tests/test_torch_entry.py's compensated GEMM cases are, within 1e-5
relative Frobenius of the exact product: the port's CPU route is matmul3's
bf16x3 emulation where JAX's CPU path is plain fp32.
"""

import numpy as np
import pytest
import scipy.linalg

import jax

import numpywren_tpu.config as jconfig
from numpywren_tpu import parallel as jparallel
from numpywren_tpu.matrix_init import random_spd
from numpywren_tpu.parallel.fabric import summa_gemm as jsumma_gemm
from numpywren_tpu.parallel.fabric import summa_syrk as jsumma_syrk
from numpywren_tpu_torch import parallel
from torch_parallel_worker import finish, start

MODES = ("high", "compensated")
RTOL, ATOL = 1e-4, 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "spd": random_spd(256, seed=0),
        "gemm_a": rng.standard_normal((256, 128)).astype(f32),
        "gemm_b": rng.standard_normal((128, 192)).astype(f32),
        "tsqr_8": rng.standard_normal((8 * 64, 32)).astype(f32),
        "tsqr_11": rng.standard_normal((11 * 64, 32)).astype(f32),
        "tsqr_q": rng.standard_normal((8 * 64, 32)).astype(f32),
        "summa_a": rng.standard_normal((128, 64)).astype(f32),
        "summa_b": rng.standard_normal((64, 96)).astype(f32),
        "summa_sq": rng.standard_normal((64, 64)).astype(f32),
        "syrk_s": rng.standard_normal((128, 128)).astype(f32),
        "syrk_p": rng.standard_normal((128, 32)).astype(f32),
        "store": rng.standard_normal((200, 136)).astype(f32),
        "store_tile": rng.standard_normal((32, 32)).astype(f32),
    }


def _reference(inp):
    """The JAX package's results on the same inputs, per mode."""
    mesh = jparallel.make_mesh(jax.devices()[:8], shape=(2, 4))
    mesh4 = jparallel.make_mesh(jax.devices()[:4], shape=(2, 2))
    out = {}
    old = jconfig._default
    try:
        for mode in MODES:
            jconfig._default = jconfig.NpwConfig(compensated=mode == "compensated")
            out[f"{mode}/chol"] = np.asarray(
                jparallel.sharded_cholesky(inp["spd"].copy(), tile=64, mesh=mesh))
            out[f"{mode}/chol_truncate"] = np.asarray(
                jparallel.sharded_cholesky(inp["spd"].copy(), tile=64, mesh=mesh, truncate=2))
            out[f"{mode}/gemm"] = np.asarray(
                jparallel.sharded_gemm(inp["gemm_a"], inp["gemm_b"], mesh=mesh))
            for leaves in (8, 11):
                out[f"{mode}/tsqr_{leaves}"] = np.asarray(
                    jparallel.sharded_tsqr(inp[f"tsqr_{leaves}"], tile_rows=64, mesh=mesh))
            q, r = jparallel.sharded_tsqr(inp["tsqr_q"], tile_rows=64, mesh=mesh, compute_q=True)
            out[f"{mode}/tsqr_q_q"], out[f"{mode}/tsqr_q_r"] = np.asarray(q), np.asarray(r)
            out[f"{mode}/summa"] = np.asarray(
                jsumma_gemm(inp["summa_a"], inp["summa_b"], mesh=mesh4))
            out[f"{mode}/syrk"] = np.asarray(
                jsumma_syrk(inp["syrk_s"], inp["syrk_p"], mesh=mesh4))
    finally:
        jconfig._default = old
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the port's results from rank 0, the JAX package's results)."""
    d = tmp_path_factory.mktemp("torch_parallel")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    ranks = start("parallel", 8, str(d), env={"NPW_MESH_SHAPE": "2x4", "NPW_COMPENSATED": "0"})
    try:
        ref = _reference(inp)  # while the ranks run
    finally:
        finish(ranks)
    return inp, dict(np.load(d / "out.npz")), ref


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def _check_product(c, jax_c, a, b, mode):
    assert _rel(c, jax_c) <= 1e-5
    if mode == "high":
        np.testing.assert_allclose(c, a @ b, rtol=1e-4, atol=1e-4)
    else:
        assert _rel(c, a.astype(np.float64) @ b) <= 1e-5


def _sign_fixed(q, r):
    s = np.sign(np.diag(r))
    s[s == 0] = 1
    return q * s, r * s[:, None]


def test_mesh_shape(runs):
    _, got, _ = runs
    assert tuple(got["mesh_shape"]) == (2, 4)
    assert tuple(got["mesh_axes"]) == ("rows", "cols")


def test_config_mesh_shape_consumed(runs):
    """NpwConfig.mesh_shape is consumed; a configured shape for another
    rank count falls back to the most-square one (tests/test_spill.py's
    case); an explicit one raises ValueError."""
    _, got, _ = runs
    assert tuple(got["mesh_cfg_1x8"]) == (1, 8)
    assert tuple(got["mesh_cfg_3x5"]) == (2, 4)
    assert bool(got["mesh_bad_shape_raised"])


@pytest.mark.parametrize("mode", MODES)
def test_sharded_cholesky(runs, mode):
    inp, got, ref = runs
    a, l = inp["spd"], got[f"{mode}/chol"]
    np.testing.assert_allclose(l, ref[f"{mode}/chol"], rtol=RTOL, atol=ATOL)
    want = scipy.linalg.cholesky(a.astype(np.float64), lower=True)
    np.testing.assert_allclose(l, want, rtol=5e-3, atol=5e-4)
    assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-5
    assert np.all(np.triu(l, 1) == 0)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_cholesky_truncate(runs, mode):
    """A prefix run (truncate=2): the factored tile columns and the lower
    triangle of the Schur complement as the reference leaves them."""
    inp, got, ref = runs
    l, want = got[f"{mode}/chol_truncate"], ref[f"{mode}/chol_truncate"]
    np.testing.assert_allclose(np.tril(l), np.tril(want), rtol=RTOL, atol=ATOL)
    a = inp["spd"].astype(np.float64)
    l11 = np.linalg.cholesky(a[:128, :128])
    l21 = scipy.linalg.solve_triangular(l11, a[128:, :128].T, lower=True).T
    np.testing.assert_allclose(np.tril(l[:128, :128]), l11, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(l[128:, :128], l21, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.tril(l[128:, 128:]), np.tril(a[128:, 128:] - l21 @ l21.T),
                               rtol=5e-3, atol=5e-4)


def test_sharded_cholesky_is_actually_sharded(runs):
    """The factor lives on all 8 ranks, each holding its own 128 x 64 block
    of the 2 x 4 layout and nothing else."""
    _, got, _ = runs
    boxes = got["high/chol_boxes"]
    assert sorted(boxes[:, 0]) == list(range(8))
    assert {tuple(b[1:]) for b in boxes} == {
        (128 * p, 128, 64 * q, 64) for p in range(2) for q in range(4)}


@pytest.mark.parametrize("mode", MODES)
def test_sharded_gemm(runs, mode):
    inp, got, ref = runs
    a, b, c = inp["gemm_a"], inp["gemm_b"], got[f"{mode}/gemm"]
    _check_product(c, ref[f"{mode}/gemm"], a, b, mode)
    assert {tuple(b[1:]) for b in got[f"{mode}/gemm_boxes"]} == {
        (128 * p, 128, 48 * q, 48) for p in range(2) for q in range(4)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_leaves", [8, 11])
def test_sharded_tsqr(runs, mode, n_leaves):
    """8 leaves spread over the flattened mesh, 11 over its rows: R within
    1e-4 of JAX's with the signs fixed, RᵀR = AᵀA."""
    inp, got, ref = runs
    a, r = inp[f"tsqr_{n_leaves}"], got[f"{mode}/tsqr_{n_leaves}"]
    eye = np.eye(r.shape[0])
    assert _rel(_sign_fixed(eye, r)[1], _sign_fixed(eye, ref[f"{mode}/tsqr_{n_leaves}"])[1]) <= 1e-4
    np.testing.assert_allclose(r.T @ r, a.T @ a, rtol=1e-3, atol=1e-2)
    assert np.all(np.tril(r, -1) == 0)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_tsqr_q(runs, mode):
    inp, got, ref = runs
    a = inp["tsqr_q"]
    q, r = _sign_fixed(got[f"{mode}/tsqr_q_q"], got[f"{mode}/tsqr_q_r"])
    jq, jr = _sign_fixed(ref[f"{mode}/tsqr_q_q"], ref[f"{mode}/tsqr_q_r"])
    assert _rel(q, jq) <= 1e-4 and _rel(r, jr) <= 1e-4
    np.testing.assert_allclose(q @ r, a, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(q.T @ q, np.eye(32), atol=1e-4)
    # Q's rows over the flattened mesh: 64 on each rank
    assert sorted(tuple(b[1:]) for b in got[f"{mode}/tsqr_q_boxes"]) == [
        (64 * k, 64, 0, 32) for k in range(8)]


@pytest.mark.parametrize("mode", MODES)
def test_summa_matches_numpy(runs, mode):
    inp, got, ref = runs
    _check_product(got[f"{mode}/summa"], ref[f"{mode}/summa"], inp["summa_a"], inp["summa_b"],
                   mode)


def test_summa_result_sharded(runs):
    """The SUMMA product lives on the 4 ranks of the 2 x 2 mesh, a 32 x 32
    block each."""
    _, got, _ = runs
    boxes = got["high/summa_sq_boxes"]
    assert sorted(boxes[:, 0]) == [0, 1, 2, 3]
    assert {tuple(b[1:]) for b in boxes} == {
        (32 * p, 32, 32 * q, 32) for p in range(2) for q in range(2)}


def test_summa_rejects_nonsquare_mesh(runs):
    _, got, _ = runs
    assert bool(got["high/summa_nonsquare_raised"])
    assert bool(got["compensated/summa_nonsquare_raised"])


@pytest.mark.parametrize("mode", MODES)
def test_summa_syrk_matches_numpy(runs, mode):
    """S - P Pᵀ on the 2 x 2 mesh, the local update through `_sub_matmul`
    (matmul3's plain version under compensated here)."""
    inp, got, ref = runs
    s, p, out = inp["syrk_s"], inp["syrk_p"], got[f"{mode}/syrk"]
    assert _rel(out, ref[f"{mode}/syrk"]) <= 1e-5
    np.testing.assert_allclose(out, s - p @ p.T, rtol=1e-4, atol=1e-3)


def test_shard_matrix_sharded(runs):
    """shard_matrix(sharding=tile_sharding(mesh)): the padded (224, 160)
    array in 112 x 40 blocks, one a rank, whose edges cut 32 x 32 tiles;
    get_block gives every tile on every rank, put_block writes one, and a
    symmetric store keeps the identity on its padded diagonal."""
    inp, got, _ = runs
    x = inp["store"]
    assert {tuple(b[1:]) for b in got["store/boxes"]} == {
        (112 * p, 112, 40 * q, 40) for p in range(2) for q in range(4)}
    np.testing.assert_array_equal(got["store/numpy"], x)
    pad = np.zeros((224, 160), np.float32)
    pad[:200, :136] = x
    tiles = pad.reshape(7, 32, 5, 32).transpose(0, 2, 1, 3).reshape(35, 32, 32)
    np.testing.assert_array_equal(got["store/blocks"], tiles)
    want = x.copy()
    want[96:128, 64:96] = inp["store_tile"]
    np.testing.assert_array_equal(got["store/after_put"], want)
    assert [tuple(ij) for ij in got["store/written"]] == [
        (i, j) for i in range(7) for j in range(5)]
    sym = np.zeros((224, 224), np.float32)
    sym[:200, :200] = inp["spd"][:200, :200]
    sym[np.arange(200, 224), np.arange(200, 224)] = 1.0
    np.testing.assert_array_equal(got["store/symmetric_full"], sym)


def test_tiled_matrix_sharded_put_get(runs):
    """TiledMatrix(sharding=): fill 0, a full tile and an edge block's true
    shape written by put_block and read back by get_block and numpy()."""
    inp, got, _ = runs
    t = inp["store_tile"]
    np.testing.assert_array_equal(got["store/put_get"], t)
    edge = np.zeros((32, 32), np.float32)
    edge[:8] = t[:8]
    np.testing.assert_array_equal(got["store/put_edge"], edge)
    want = np.zeros((200, 136), np.float32)
    want[96:128, 64:96] = t
    want[192:200, 0:32] = t[:8]
    np.testing.assert_array_equal(got["store/put_numpy"], want)


def test_to_hbm_sharded(runs):
    """to_hbm(sharding=) from the host tier and from the trapezoid tier:
    the same values, each rank holding its block; back to the host tier."""
    inp, got, _ = runs
    x = inp["store"]
    np.testing.assert_array_equal(got["store/to_hbm"], x)
    np.testing.assert_array_equal(got["store/to_hbm_back"], x)
    assert {tuple(b[1:]) for b in got["store/to_hbm_boxes"]} == {
        (112 * p, 112, 40 * q, 40) for p in range(2) for q in range(4)}
    np.testing.assert_array_equal(got["store/trap_to_hbm"], inp["spd"])
    assert {tuple(b[1:]) for b in got["store/trap_boxes"]} == {
        (128 * p, 128, 64 * q, 64) for p in range(2) for q in range(4)}


def test_to_hbm_from_the_device_tier(runs):
    """to_hbm(sharding=) from the unsharded device tier: each rank keeps
    its own block. A sharded tier copies into its own layout, and refuses
    another one (ValueError) rather than gather the whole array."""
    inp, got, _ = runs
    x = inp["store"]
    np.testing.assert_array_equal(got["store/dev_to_hbm"], x)
    assert {tuple(b[1:]) for b in got["store/dev_to_hbm_boxes"]} == {
        (112 * p, 112, 40 * q, 40) for p in range(2) for q in range(4)}
    np.testing.assert_array_equal(got["store/to_hbm_same"], x)
    assert got["store/relayout_raised"]


def test_from_reference_sharded(tmp_path):
    """convert.from_reference(sharding=) of a JAX device-tier TiledMatrix:
    each rank keeps its block of the reference's values. One rank here (a
    1 x 1 mesh of a gloo group of its own, closed after)."""
    import socket

    import torch.distributed as dist

    from numpywren_tpu.matrix_init import shard_matrix as jshard
    from numpywren_tpu_torch import convert
    from numpywren_tpu_torch.parallel.mesh import tile_sharding

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    x = np.random.default_rng(5).standard_normal((96, 80)).astype(np.float32)
    jm = jshard(x, tile=(32, 32))
    parallel.distributed.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = parallel.make_mesh(device="cpu")
        m = convert.from_reference(jm, sharding=tile_sharding(mesh))
        assert m.sharding.placements == tile_sharding(mesh).placements
        assert tuple(m.array.to_local().shape) == (96, 96)
        np.testing.assert_array_equal(m.numpy(), x)
        assert m.block_idxs_exist == jm.block_idxs_exist
        with pytest.raises(ValueError, match="applies to a TiledMatrix"):
            convert.from_reference(jnpw_trapezoid(x), sharding=tile_sharding(mesh))
    finally:
        dist.destroy_process_group()
    assert parallel.distributed.process_count() == 1


def jnpw_trapezoid(x):
    import numpywren_tpu as jnpw

    a = x[:64, :64] @ x[:64, :64].T + 64 * np.eye(64, dtype=np.float32)
    return jnpw.TrapezoidMatrix.from_array(a, panel=32)


def test_make_mesh_needs_a_card_or_cpu(monkeypatch):
    """Without a card, make_mesh raises unless device="cpu" is given; with
    it and no process group, it says how to start one."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="distributed.initialize"):
        parallel.make_mesh(device="cpu")


def test_parallel_exports_the_reference_names():
    assert parallel.__all__ == jparallel.__all__
    assert len(parallel.__all__) == 15
    for name in parallel.__all__:
        assert getattr(parallel, name) is not None


@pytest.mark.parametrize("name,item", [
    ("cholesky_1d", "#6b"), ("cholesky_2d", "#6b"), ("cholqr2_sharded", "#6b"),
    ("cholqr3s_sharded", "#6b"), ("tsqr_butterfly", "#6b"),
    ("bdfac_1d", "#6c"), ("bdfac_2d", "#6c"),
])
def test_fabric_names_refuse_bad_args(name, item, request):
    """The fabric names of ROADMAP Queue 1 #6b and #6c, ported, raise the
    reference's ShapeError for an argument it refuses (a matrix that is not
    square, n not a multiple of panel or tile, rows that do not divide over
    the 8 ranks, b_fac 1), run on the 2 x 4 mesh of the module's ranks,
    before any collective."""
    _, got, _ = request.getfixturevalue("runs")
    assert str(got[f"bad_args/{name}"]) == "ShapeError"
