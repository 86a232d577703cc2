"""The port's block-cyclic Cholesky, sharded CholeskyQR, butterfly TSQR and
out-of-core Cholesky over a mesh (numpywren_tpu_torch.parallel.fabric,
runtime.spill) against the JAX package's, on the CPU.

The port runs in ONE gloo group of 8 ranks for the module
(tests/torch_parallel_worker.py's "fabric" mode), each case on a mesh of
ranks 0 .. p-1 as the reference takes jax.devices()[:p]; the reference's
one-axis ``Mesh(devices, ("d",))`` is a (1, p) mesh with axis="cols". The
JAX package runs on the 8 virtual CPU devices of tests/conftest.py, in this
process, while the ranks run. Both get the reference tests' inputs
(tests/test_fabric.py, tests/test_spill.py: the same seeds and draws).

Each case holds the reference test's own bars against numpy or scipy. On
one shape per entry and schedule the port is also held to the JAX
package's result: the Cholesky factor within rtol 1e-4, atol 1e-5
(tests/test_torch_entry.py's); R and Q, signs fixed, within 1e-4 relative
Frobenius; schedule_log and collective_log equal to the reference's lists.
"""

import numpy as np
import pytest
import scipy.linalg

import jax

import numpywren_tpu.config as jconfig
from numpywren_tpu.matrix_init import random_spd
from numpywren_tpu.matrix_init import shard_matrix as jshard
from numpywren_tpu.parallel import fabric as jfabric
from numpywren_tpu.parallel.mesh import make_mesh as jmake_mesh
from numpywren_tpu.runtime import spill as jspill
from torch_parallel_worker import finish, start

RTOL, ATOL = 1e-4, 1e-5
C1D = ((8, 8), (8, 4), (10, 4), (3, 8))
C2D = (((2, 2), 6), ((2, 4), 8), ((2, 2), 5), ((1, 4), 7), ((4, 2), 4))
RAGGED = ((6, 4), (5, 3), (6, 2), (8, 4), (8, 8), (7, 2))


def _rng():
    return np.random.default_rng(0)  # tests/conftest.py's rng fixture


def _inputs():
    f32 = np.float32
    inp = {}
    for p in (2, 4, 8):
        inp[f"bf/{p}"] = _rng().standard_normal((p * 32, 16)).astype(f32)
    for p in {p for p, _ in RAGGED}:
        inp[f"bf_ragged/{p}"] = _rng().standard_normal((p * 16, 8)).astype(f32)
    inp["bf_same"] = _rng().standard_normal((6 * 16, 8)).astype(f32)
    inp["bf_bad"] = _rng().standard_normal((4 * 16, 8)).astype(f32)
    inp["bf_vs_fused"] = _rng().standard_normal((8 * 32, 16)).astype(f32)
    for p in (4, 8):
        inp[f"cq2/{p}"] = _rng().standard_normal((p * 32, 16)).astype(f32)
    inp["cq2_r_only"] = _rng().standard_normal((8 * 32, 16)).astype(f32)
    rng = _rng()
    u, _ = np.linalg.qr(rng.standard_normal((2048, 64)))
    v, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    inp["cq3s_robust"] = ((u * np.logspace(0, -6, 64)) @ v.T).astype(f32)
    inp["cq3s_wellcond"] = _rng().standard_normal((1024, 32)).astype(f32)
    for nb, p in C1D:
        inp[f"c1d/{nb}_{p}"] = random_spd(nb * 16, seed=nb * 10 + p)
    for (r, c), nb in C2D:
        inp[f"c2d/{r}x{c}_{nb}"] = random_spd(nb * 16, seed=nb * 100 + r * 10 + c)
    inp["c1d_order"] = random_spd(8 * 16, seed=0)
    inp["c2d_order"] = random_spd(6 * 16, seed=1)
    inp["c2d_volume"] = random_spd(8 * 16, seed=3)
    inp["c2d_compensated"] = random_spd(4 * 32, seed=7)
    inp["gather"] = random_spd(4 * 32, seed=9)
    inp["ooc_mesh"] = random_spd(1024, seed=21)
    inp["ooc_resume"] = random_spd(512, seed=22)
    return inp


def _reference(inp):
    """The JAX package's results where the port is held to them."""
    from jax.sharding import Mesh

    devs = jax.devices()
    mesh14, mesh22 = jmake_mesh(devs[:4], shape=(1, 4)), jmake_mesh(devs[:4], shape=(2, 2))
    out = {}
    for la in (False, True):
        log = []
        out[f"c1d_order/{la}"] = np.asarray(jfabric.cholesky_1d(
            inp["c1d_order"], mesh=mesh14, panel=16, lookahead=la, schedule_log=log))
        out[f"c1d_order/{la}/log"] = [repr(e) for e in log]
        log = []
        out[f"c2d_order/{la}"] = np.asarray(jfabric.cholesky_2d(
            inp["c2d_order"], mesh=mesh22, panel=16, lookahead=la, schedule_log=log))
        out[f"c2d_order/{la}/log"] = [repr(e) for e in log]
    clog = []
    out["c2d_volume"] = np.asarray(jfabric.cholesky_2d(
        inp["c2d_volume"], mesh=jmake_mesh(devs[:8], shape=(2, 4)), panel=16,
        collective_log=clog))
    out["c2d_volume/clog"] = [repr(e) for e in clog]
    old = jconfig._default
    try:
        jconfig._default = jconfig.NpwConfig(compensated=True)
        out["c2d_compensated"] = np.asarray(jfabric.cholesky_2d(
            inp["c2d_compensated"], mesh=mesh22, panel=32, pallas=True))
    finally:
        jconfig._default = old
    out["bf/8"] = np.asarray(jfabric.tsqr_butterfly(
        inp["bf/8"], mesh=jmake_mesh(devs[:8], shape=(1, 8))))
    out["bf_ragged/6_4"] = np.asarray(jfabric.tsqr_butterfly(
        inp["bf_ragged/6"], mesh=Mesh(np.asarray(devs[:6]), ("d",)), axis="d", b_fac=4))
    q, r = jfabric.cholqr2_sharded(inp["cq2/4"], mesh=mesh14, compute_q=True)
    out["cq2/4/q"], out["cq2/4/r"] = np.asarray(q), np.asarray(r)
    q, r = jfabric.cholqr3s_sharded(inp["cq3s_wellcond"], mesh=jmake_mesh(devs[:8], shape=(1, 8)),
                                    compute_q=True)
    out["cq3s_wellcond/q"], out["cq3s_wellcond/r"] = np.asarray(q), np.asarray(r)
    at = jshard(inp["ooc_mesh"], tile=(64, 64), storage="host")
    out["ooc_mesh"] = np.tril(jspill.out_of_core_cholesky(
        at, panel_tiles=4, mesh=jmake_mesh(devs)).numpy())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the port's results from rank 0, the JAX package's results)."""
    d = tmp_path_factory.mktemp("torch_fabric")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    ranks = start("fabric", 8, str(d), env={"NPW_COMPENSATED": "0"})
    try:
        ref = _reference(inp)  # while the ranks run
    finally:
        finish(ranks)
    return inp, dict(np.load(d / "out.npz")), ref


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def _sign_fixed(q, r):
    s = np.sign(np.diag(r))
    s[s == 0] = 1
    return q * s, r * s[:, None]


def _r_matches(r, jr):
    eye = np.eye(r.shape[0])
    assert _rel(_sign_fixed(eye, r)[1], _sign_fixed(eye, jr)[1]) <= 1e-4


def _qr_matches(q, r, jq, jr):
    q, r = _sign_fixed(q, r)
    jq, jr = _sign_fixed(jq, jr)
    assert _rel(q, jq) <= 1e-4 and _rel(r, jr) <= 1e-4


def _check_factor(a, l):
    ref = scipy.linalg.cholesky(a.astype(np.float64), lower=True)
    np.testing.assert_allclose(l, ref, rtol=5e-3, atol=5e-4)
    assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-5
    assert np.all(np.triu(l, 1) == 0)


# ---------------------------------------------------------------------------
# butterfly TSQR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 4, 8])
def test_tsqr_butterfly(runs, p):
    inp, got, ref = runs
    a, r = inp[f"bf/{p}"], got[f"bf/{p}"]
    np.testing.assert_allclose(r.T @ r, a.T @ a, rtol=1e-3, atol=1e-3)
    if f"bf/{p}" in ref:
        _r_matches(r, ref[f"bf/{p}"])


@pytest.mark.parametrize("p,b_fac", RAGGED)
def test_tsqr_butterfly_kary_ragged(runs, p, b_fac):
    """k-ary butterfly on rank counts that are not a power of b_fac: ragged
    tail groups and the final broadcast; R as np.linalg.qr's up to signs."""
    inp, got, ref = runs
    a, r = inp[f"bf_ragged/{p}"], got[f"bf_ragged/{p}_{b_fac}"]
    np.testing.assert_allclose(np.abs(r), np.abs(np.linalg.qr(a, mode="r")), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(r.T @ r, a.T @ a, rtol=1e-3, atol=1e-3)
    if f"bf_ragged/{p}_{b_fac}" in ref:
        _r_matches(r, ref[f"bf_ragged/{p}_{b_fac}"])


def test_tsqr_butterfly_all_devices_same_r(runs):
    """Every rank's block of the stacked output holds the same R, bit for
    bit, on a rank count that is not a power of b_fac (the broadcast leg)."""
    _, got, _ = runs
    p, b = 6, 8
    stacked = got["bf_same"]
    assert tuple(got["bf_same_shape"]) == (p * b, b) and stacked.shape == (p * b, b)
    for d in range(1, p):
        np.testing.assert_array_equal(stacked[d * b:(d + 1) * b], stacked[:b])


def test_tsqr_butterfly_rejects_bad_bfac(runs):
    _, got, _ = runs
    assert bool(got["bf_bad_raised"])


def test_tsqr_butterfly_vs_fused(runs):
    """The butterfly's R against the port's single-device fused TSQR, up to
    row signs; the 2 x 4 mesh flattened gives it too."""
    _, got, _ = runs
    np.testing.assert_allclose(np.abs(got["bf_vs_fused"]), np.abs(got["bf_vs_fused/fused"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.abs(got["bf_flat_2x4"]), np.abs(got["bf_vs_fused/fused"]),
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# CholeskyQR over row shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [4, 8])
def test_cholqr2_sharded(runs, p):
    inp, got, ref = runs
    a, q, r = inp[f"cq2/{p}"], got[f"cq2/{p}/q"], got[f"cq2/{p}/r"]
    np.testing.assert_allclose(q @ r, a, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(q.T @ q, np.eye(16), atol=1e-4)
    if f"cq2/{p}/q" in ref:
        _qr_matches(q, r, ref[f"cq2/{p}/q"], ref[f"cq2/{p}/r"])


def test_cholqr2_sharded_r_only(runs):
    """compute_q=False returns R alone, the 2 x 4 mesh flattened."""
    inp, got, _ = runs
    a, r = inp["cq2_r_only"], got["cq2_r_only"]
    assert r.shape == (16, 16)
    np.testing.assert_allclose(r.T @ r, a.T @ a, rtol=1e-3, atol=1e-2)


def test_cholqr3s_sharded_robust(runs):
    """The adaptive chain across ranks: a kappa ~1e6 input (where plain
    CholeskyQR2's unshifted Gram breaks in fp32) factors cleanly; every
    rank ran the same chain (its chains and extras passes)."""
    inp, got, _ = runs
    a, q, r = inp["cq3s_robust"], got["cq3s_robust/q"], got["cq3s_robust/r"]
    b = a.shape[1]
    assert np.isfinite(q).all()
    np.testing.assert_allclose(q.T @ q, np.eye(b), atol=1e-3)
    np.testing.assert_allclose(q @ r, a, atol=1e-4 * np.abs(a).max() * b)
    q2 = got["cq3s_robust/q2"]
    assert not np.isfinite(q2).all() or np.max(np.abs(q2.T @ q2 - np.eye(b))) > 1e-2, \
        "expected plain CholeskyQR2 to break at kappa 1e6"
    passes = got["cq3s_robust/passes"]
    assert (passes == passes[0]).all() and passes[0, 0] == 1 and passes[0, 1] >= 1, passes


def test_cholqr3s_sharded_wellcond_matches(runs):
    inp, got, ref = runs
    a, q, r = inp["cq3s_wellcond"], got["cq3s_wellcond/q"], got["cq3s_wellcond/r"]
    np.testing.assert_allclose(q.T @ q, np.eye(a.shape[1]), atol=5e-5)
    np.testing.assert_allclose(q @ r, a, atol=1e-4 * np.abs(a).max())
    _qr_matches(q, r, ref["cq3s_wellcond/q"], ref["cq3s_wellcond/r"])


# ---------------------------------------------------------------------------
# block-cyclic Cholesky
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,p", C1D)
@pytest.mark.parametrize("lookahead", [False, True])
def test_cholesky_1d_blockcyclic(runs, nb, p, lookahead):
    """Block-cyclic panels, one broadcast a step, local updates: scipy's
    factor for ragged nb / p, with and without the lookahead order."""
    inp, got, _ = runs
    _check_factor(inp[f"c1d/{nb}_{p}"], got[f"c1d/{nb}_{p}/{lookahead}"])


def test_cholesky_1d_lookahead_schedule_order(runs):
    """Lookahead: panel k+1's broadcast runs after only its one column
    update, before the bulk updates of step k; one broadcast a panel either
    way. The logs are the reference's lists, the factors its factors."""
    inp, got, ref = runs
    log = [eval(e) for e in got["c1d_order/True/log"]]
    assert [e for e in log if e[0] == "bcast"] == [("bcast", k) for k in range(8)]
    idx = {e: i for i, e in enumerate(log)}
    for k in range(7):
        assert idx[("col_update", k + 1)] < idx[("bcast", k + 1)]
        assert idx[("bcast", k + 1)] < idx[("bulk", k, 0)]
    idx2 = {e: i for i, e in enumerate(eval(e) for e in got["c1d_order/False/log"])}
    for k in range(7):
        assert idx2[("bulk", k, 0)] < idx2[("bcast", k + 1)]
    for la in (False, True):
        assert list(got[f"c1d_order/{la}/log"]) == ref[f"c1d_order/{la}/log"]
        np.testing.assert_allclose(got[f"c1d_order/{la}"], ref[f"c1d_order/{la}"], rtol=RTOL,
                                   atol=ATOL)
        _check_factor(inp["c1d_order"], got[f"c1d_order/{la}"])


@pytest.mark.parametrize("shape,nb", C2D)
@pytest.mark.parametrize("lookahead", [False, True])
def test_cholesky_2d_blockcyclic(runs, shape, nb, lookahead):
    """2-D block-cyclic: scipy's factor across mesh shapes, ragged nb / mesh
    and both schedules."""
    inp, got, _ = runs
    key = f"c2d/{shape[0]}x{shape[1]}_{nb}"
    _check_factor(inp[key], got[f"{key}/{lookahead}"])


def test_cholesky_2d_collective_volume(runs):
    """Per step, akk is panel², the row pieces n_loc_r * panel and the
    column pieces n_loc_c * panel floats a rank (never the 1-D path's
    n * panel); the log is the reference's list."""
    inp, got, ref = runs
    r, c, nb, panel = 2, 4, 8, 16
    n = nb * panel
    clog = [eval(e) for e in got["c2d_volume/clog"]]
    n_loc_r, n_loc_c = -(-nb // r) * panel, -(-nb // c) * panel
    per_step = {}
    for kind, k, vol in clog:
        per_step.setdefault(k, {})[kind] = vol
    assert set(per_step) == set(range(nb))
    for kinds in per_step.values():
        assert kinds["akk"] == panel * panel
        assert kinds["bcast_rows"] == n_loc_r * panel
        assert kinds["bcast_cols"] == n_loc_c * panel
        assert kinds["bcast_rows"] < n * panel
    assert sum(v for _, _, v in clog) == nb * (panel * panel + (n_loc_r + n_loc_c) * panel)
    assert list(got["c2d_volume/clog"]) == ref["c2d_volume/clog"]
    np.testing.assert_allclose(got["c2d_volume"], ref["c2d_volume"], rtol=RTOL, atol=ATOL)
    _check_factor(inp["c2d_volume"], got["c2d_volume"])


def test_cholesky_2d_lookahead_schedule_order(runs):
    """Lookahead: panel k+1's collectives after only its column strip's
    update, step k's bulk update after them; serial otherwise. The logs
    are the reference's lists, the factors its factors."""
    inp, got, ref = runs
    nb = 6
    idx = {e: i for i, e in enumerate(eval(e) for e in got["c2d_order/True/log"])}
    for k in range(nb - 1):
        assert idx[("col_update", k + 1)] < idx[("bcast_rows", k + 1)]
        assert idx[("bcast_cols", k + 1)] < idx[("bulk", k)]
    idx2 = {e: i for i, e in enumerate(eval(e) for e in got["c2d_order/False/log"])}
    for k in range(nb - 1):
        assert idx2[("bulk", k)] < idx2[("bcast_rows", k + 1)]
    for la in (False, True):
        assert list(got[f"c2d_order/{la}/log"]) == ref[f"c2d_order/{la}/log"]
        np.testing.assert_allclose(got[f"c2d_order/{la}"], ref[f"c2d_order/{la}"], rtol=RTOL,
                                   atol=ATOL)
        _check_factor(inp["c2d_order"], got[f"c2d_order/{la}"])


def test_cholesky_2d_compensated_mode(runs):
    """NpwConfig.compensated through the 2-D path end to end: the local
    updates on matmul3 (its plain version here, an exact bf16x3 emulation
    where JAX's CPU path is plain fp32)."""
    inp, got, ref = runs
    l = got["c2d_compensated"]
    ref_l = scipy.linalg.cholesky(inp["c2d_compensated"].astype(np.float64), lower=True)
    np.testing.assert_allclose(l, ref_l, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(l, ref["c2d_compensated"], rtol=RTOL, atol=ATOL)


def test_cholesky_gather_host_matches_device(runs):
    """gather="host" (an ndarray assembled on the host) equals the device
    gather for both forms, bit for bit."""
    _, got, _ = runs
    for fn in ("cholesky_1d", "cholesky_2d"):
        assert bool(got[f"gather/{fn}/is_ndarray"])
        np.testing.assert_array_equal(got[f"gather/{fn}/device"], got[f"gather/{fn}/host"])


# ---------------------------------------------------------------------------
# the out-of-core Cholesky over a mesh
# ---------------------------------------------------------------------------

def test_ooc_cholesky_mesh_composition(runs):
    """The host-spill tier on the mesh of all 8 ranks: panels row-sharded,
    the updates local, the top summed whole for the redundant factor;
    scipy's factor and the JAX package's."""
    inp, got, ref = runs
    a, l = inp["ooc_mesh"], np.tril(got["ooc_mesh"])
    assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-5
    np.testing.assert_allclose(l, scipy.linalg.cholesky(a.astype(np.float64), lower=True),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(l, ref["ooc_mesh"], rtol=RTOL, atol=ATOL)


def test_ooc_cholesky_mesh_resume(runs):
    """mesh x spill x checkpoint: stopped at panel 1's factor (after the
    first rank committed panel 0), resumed on the mesh, the same factor."""
    inp, got, _ = runs
    assert bool(got["ooc_resume/bomb_fired"])
    assert int(got["ooc_resume/panels_done"]) == 1 and int(got["ooc_resume/panels_run"]) == 3
    ref = scipy.linalg.cholesky(inp["ooc_resume"].astype(np.float64), lower=True)
    np.testing.assert_allclose(np.tril(got["ooc_resume"]), ref, rtol=5e-3, atol=5e-4)
