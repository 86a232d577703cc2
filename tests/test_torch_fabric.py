"""The port's block-cyclic Cholesky, sharded CholeskyQR, butterfly TSQR,
distributed BDFAC, out-of-core Cholesky and BDFAC over a mesh,
singular_values(mesh=) and the multi-device dry run
(numpywren_tpu_torch.parallel.fabric, parallel.dryrun, runtime.spill,
models.svd) against the JAX package's, on the CPU.

The port runs in ONE gloo group of 8 ranks for the module
(tests/torch_parallel_worker.py's "fabric" mode), each case on a mesh of
ranks 0 .. p-1 as the reference takes jax.devices()[:p]; the reference's
one-axis ``Mesh(devices, ("d",))`` is a (1, p) mesh with axis="cols". The
JAX package runs on the 8 virtual CPU devices of tests/conftest.py, in this
process, while the ranks run. Both get the reference tests' inputs
(tests/test_fabric.py, tests/test_spill.py, tests/test_models.py: the same
seeds and draws).

Each case holds the reference test's own bars against numpy or scipy. On
one shape per entry and schedule the port is also held to the JAX
package's result: the Cholesky factor within rtol 1e-4, atol 1e-5
(tests/test_torch_entry.py's); R and Q, signs fixed, within 1e-4 relative
Frobenius; B (and sigma) within 1e-4 relative Frobenius, the JAX side at
nb = 4 only (its BDFAC unrolls the sweep inside jit); schedule_log and
collective_log equal to the reference's lists.
"""

import numpy as np
import pytest
import scipy.linalg

import jax

import numpywren_tpu.config as jconfig
from numpywren_tpu import models as jmodels
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
    for n in (128, 160, 192):  # the BDFAC cases' draws from the rng fixture
        inp[f"g{n}"] = _rng().standard_normal((n, n)).astype(f32)
    inp["ooc_bdfac"] = np.random.default_rng(9).standard_normal((256, 256)).astype(f32)
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
    # the BDFAC entries once each at nb = 4 (tile 32 / 16)
    for key, fn, mesh in (("bd1_volume", jfabric.bdfac_1d, mesh14),
                          ("bd2_order/True", jfabric.bdfac_2d, mesh22)):
        clog, slog = [], []
        out[key] = np.asarray(fn(inp["g128"], mesh=mesh, tile=32, collective_log=clog,
                                 schedule_log=slog))
        out[f"{key}/clog"], out[f"{key}/slog"] = [repr(e) for e in clog], [repr(e) for e in slog]
    out["sv_mesh_jax_shape"] = jmodels.singular_values(inp["g128"], tile=32, mesh=mesh22)
    at = jshard(inp["ooc_bdfac"], tile=(16, 16), storage="host")
    out["ooc_bdfac_mesh"] = jspill.out_of_core_bdfac(at, panel_tiles=4,
                                                     mesh=jmake_mesh(devs)).numpy()
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


# ---------------------------------------------------------------------------
# the distributed BDFAC
# ---------------------------------------------------------------------------

def _sigma_ok(a, b, rtol=2e-3):
    """tests/test_fabric.py's bar: sigma(B) against numpy's sigma(A)."""
    s = np.linalg.svd(np.asarray(b, np.float64), compute_uv=False)
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, s_ref, rtol=rtol, atol=rtol * s_ref[0])


def _band_ok(b, t):
    """Block upper bidiagonal: upper triangular, nothing past the 2t band."""
    n = b.shape[0]
    scale = np.abs(b).max()
    assert np.abs(np.tril(b, -1)).max() < 1e-4 * scale
    for i in range(n):
        assert np.abs(b[i, min(n, (i // t + 2) * t):]).max(initial=0.0) < 1e-4 * scale


def _blocks_match_dense(got, key, t):
    diags, sups, dense = got[f"{key}/diags"], got[f"{key}/sups"], got[key]
    nb = dense.shape[0] // t
    assert len(diags) == nb and len(sups) == nb - 1 and bool(got[f"{key}/last_sup_none"])
    for k in range(nb):
        np.testing.assert_array_equal(diags[k], dense[k * t:(k + 1) * t, k * t:(k + 1) * t])
        if k + 1 < nb:
            np.testing.assert_array_equal(sups[k],
                                          dense[k * t:(k + 1) * t, (k + 1) * t:(k + 2) * t])
    assert bool(got[f"{key}/same_on_ranks"]), "the band lists differ between ranks"


def _logs(got, key):
    return [eval(e) for e in got[f"{key}/slog"]], [eval(e) for e in got[f"{key}/clog"]]


@pytest.mark.parametrize("p,tile", [(4, 32), (3, 32), (8, 16)])
def test_bdfac_1d_sigma(runs, p, tile):
    """sigma(B) = sigma(A) on even and non-divisor rank counts."""
    inp, got, _ = runs
    _sigma_ok(inp["g192"], got[f"bd1_sigma/{p}_{tile}"])


def test_bdfac_1d_band_structure(runs):
    """Upper triangular, nothing past the 2t band; sigma as the port's
    single-device fused BDFAC's."""
    _, got, _ = runs
    b = got["bd1_band"]
    _band_ok(b, 32)
    s_multi = np.linalg.svd(b.astype(np.float64), compute_uv=False)
    s_single = np.linalg.svd(got["bd1_band/fused"].astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s_multi, s_single, rtol=1e-3, atol=1e-3)


def test_bdfac_1d_collective_volume(runs):
    """Per QR step one (t, t) Gram, one (t, t) Q1 and one (t, n - c1)
    contraction; per LQ step one (t, n - c1) broadcast; nothing bigger. The
    logs are the reference's lists, B the JAX package's."""
    inp, got, ref = runs
    n, t = 128, 32
    nb = n // t
    slog, clog = _logs(got, "bd1_volume")
    kinds = {}
    for kind, k, vol in clog:
        kinds.setdefault(kind, []).append((k, vol))
        assert vol <= t * n, (kind, k, vol)
    assert len(kinds["qr_gram"]) == nb and len(kinds["qr_w1"]) == nb - 1
    assert len(kinds["lq_rowpan"]) == nb - 2
    for k, vol in kinds["qr_w1"]:
        assert vol == t * (n - (k + 1) * t)
    assert [repr(e) for e in clog] == ref["bd1_volume/clog"]
    assert [repr(e) for e in slog] == ref["bd1_volume/slog"]
    assert _rel(got["bd1_volume"], ref["bd1_volume"]) <= 1e-4
    _sigma_ok(inp["g128"], got["bd1_volume"])


def test_bdfac_1d_return_band(runs):
    """return_band=True: the band blocks alone, equal to the dense B's bit
    for bit, the same lists on every rank."""
    _, got, _ = runs
    _blocks_match_dense(got, "bd1_return_band", 32)


@pytest.mark.parametrize("lookahead", [False, True])
def test_bdfac_1d_lookahead(runs, lookahead):
    """With lookahead the LQ row panel is broadcast before the deferred QR
    bulk update; without it, after."""
    inp, got, _ = runs
    _sigma_ok(inp["g160"], got[f"bd1_lookahead/{lookahead}"])
    slog, _ = _logs(got, f"bd1_lookahead/{lookahead}")
    for k in range(160 // 32 - 2):
        assert (slog.index(("lq_panel", k)) < slog.index(("qr_bulk", k))) == lookahead, slog


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (2, 3)])
def test_bdfac_2d_sigma(runs, shape):
    """2-D: sigma on square, non-square and non-divisor meshes."""
    inp, got, _ = runs
    _sigma_ok(inp["g192"], got[f"bd2_sigma/{shape[0]}x{shape[1]}"])


def test_bdfac_2d_band_structure_and_blocks(runs):
    _, got, _ = runs
    _band_ok(got["bd2_blocks"], 32)
    _blocks_match_dense(got, "bd2_blocks", 32)


def test_bdfac_2d_collective_volume(runs):
    """Every collective is (t, t) or O(t n / mesh dim); the W broadcast is
    n_loc_r t and the trailing contraction shrinks with progress (the
    conservative static slicing)."""
    inp, got, _ = runs
    n, t, r, c = 192, 32, 2, 4
    nb = n // t
    n_loc_r, n_loc_c = -(-nb // r) * t, -(-nb // c) * t
    _, clog = _logs(got, "bd2_volume")
    kinds = {}
    for kind, k, vol in clog:
        kinds.setdefault(kind, []).append((k, vol))
        assert vol <= max(n_loc_r, n_loc_c) * t, (kind, k, vol)
    assert len(kinds["qr_gram"]) == nb
    assert len(kinds["qr_wbcast"]) == nb - 1 and len(kinds["lq_wrbcast"]) == nb - 2
    assert all(v == n_loc_r * t for _, v in kinds["qr_wbcast"])
    for k, v in kinds["qr_w1"]:
        assert v == t * (n_loc_c - ((k + 1) // c) * t)
    _sigma_ok(inp["g192"], got["bd2_volume"])


def test_bdfac_2d_compensated_mode(runs):
    """NpwConfig.compensated through the 2-D path: the updates on matmul3
    (its plain version here)."""
    inp, got, _ = runs
    _sigma_ok(inp["g128"], got["bd2_compensated"])


@pytest.mark.parametrize("lookahead", [False, True])
def test_bdfac_2d_lookahead_sigma(runs, lookahead):
    inp, got, _ = runs
    _sigma_ok(inp["g192"], got[f"bd2_lookahead/{lookahead}"])


def test_bdfac_2d_lookahead_schedule_order(runs):
    """With lookahead the LQ panel (its Grams and the W_r broadcast) comes
    before the deferred QR bulk update; without it, after. With it, the
    logs are the reference's lists and B the JAX package's."""
    inp, got, ref = runs
    for look in (False, True):
        slog, _ = _logs(got, f"bd2_order/{look}")
        for k in range(128 // 32 - 2):
            i_pan, i_bulk = slog.index(("lq_panel", k)), slog.index(("qr_bulk", k))
            assert (i_pan < i_bulk) == look, (k, slog)
        _sigma_ok(inp["g128"], got[f"bd2_order/{look}"])
    assert list(got["bd2_order/True/slog"]) == ref["bd2_order/True/slog"]
    assert list(got["bd2_order/True/clog"]) == ref["bd2_order/True/clog"]
    assert _rel(got["bd2_order/True"], ref["bd2_order/True"]) <= 1e-4


def test_singular_values_mesh_distributed(runs):
    """mesh= routes stage 1 through bdfac_1d on a flat mesh and bdfac_2d on
    a 2-D one: sigma within the reference's bars, the same on every rank,
    and the JAX package's at n = 128; n not a multiple of tile and a
    rectangular input raise ValueError."""
    inp, got, ref = runs
    s_ref = np.linalg.svd(inp["g192"].astype(np.float64), compute_uv=False)
    for shape in ("1x4", "2x2"):
        np.testing.assert_allclose(got[f"sv_mesh/{shape}"], s_ref, rtol=2e-3, atol=2e-3 * s_ref[0])
        assert bool(got[f"sv_mesh/{shape}/same_on_ranks"])
    assert _rel(got["sv_mesh_jax_shape"], ref["sv_mesh_jax_shape"]) <= 1e-4
    assert str(got["sv_mesh/ragged_raised"]) == "ValueError"
    assert str(got["sv_mesh/rect_raised"]) == "ValueError"


def test_singular_values_one_rank_mesh(runs):
    """A DeviceMesh of one rank runs the single-device path, as the
    reference does for a one-device mesh: the same sigma, bit for bit."""
    _, got, _ = runs
    assert str(got["sv_one_rank/error"]) == "none", str(got["sv_one_rank/error"])
    np.testing.assert_array_equal(got["sv_one_rank"], got["sv_one_rank/single"])


def test_ooc_bdfac_mesh_composition(runs):
    """The out-of-core BDFAC on the mesh of all 8 ranks (QR side
    row-sharded, LQ side column-sharded): sigma within the reference's bar,
    B the same on every rank and the JAX package's."""
    inp, got, ref = runs
    a, b = inp["ooc_bdfac"], got["ooc_bdfac_mesh"]
    s = np.linalg.svd(b.astype(np.float64), compute_uv=False)
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, s_ref, rtol=2e-3, atol=1e-4 * s_ref[0])
    assert bool(got["ooc_bdfac_mesh/same_on_ranks"])
    assert _rel(b, ref["ooc_bdfac_mesh"]) <= 1e-4


def test_dryrun_multichip_2x4(runs):
    """The port's dry run passes its ten stages on the 2 x 4 mesh (each
    stage asserts its own bar on every rank; rank 0 ran them all)."""
    _, got, _ = runs
    stages = [str(k) for k in got["dryrun/stages"]]
    assert sorted({k.split("_")[0] for k in stages}, key=int) == [str(i) for i in range(1, 11)]
    assert len(stages) == 13 and np.isfinite(got["dryrun/values"]).all()
