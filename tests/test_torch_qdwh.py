"""The port's QDWH route (numpywren_tpu_torch/models/qdwh.py and the
entries of models/svd.py on it) against the JAX package's, on the CPU, from
the same numpy inputs: qdwh against jax._src.tpu.linalg.qdwh.qdwh, the SVD
routine against the JAX package's `models.svd._qdwh_svd` (which jits
jax._src.tpu.linalg.svd.svd), and `svd(method="qdwh")`,
`singular_values(finish="qdwh")` and `svd(uv_finish="device")` against the
JAX package's entries.

Bars, each stated where it is used: u and h within 1e-5 (relative
Frobenius) of JAX's, u within kappa·eps on the kappa = 1e4 input, with
the same iteration count and convergence flag;
singular values within 1e-5·σ_max of JAX's and of fp64, reconstruction
and max |UᵀU − I|, |VVᵀ − I| below 1e-5 (tests/test_models.py:476-524);
the device finish of the BDFAC's B at that test's 1e-4. Singular vectors
are compared through those quantities, not entry by entry: LAPACK and
torch may return eigenvectors of opposite signs. The JAX results are
computed once per input (module-scoped cache), so each JAX shape compiles
once.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.tpu.linalg import qdwh as jqdwh

from numpywren_tpu import models as jm
from numpywren_tpu_torch import models as pm
from numpywren_tpu_torch.matrix_init import shard_matrix
from numpywren_tpu_torch.models import qdwh as pq

# the modules: both packages export their function `svd` under the same name
jsvd = importlib.import_module("numpywren_tpu.models.svd")
psvd = importlib.import_module("numpywren_tpu_torch.models.svd")

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these sizes gain nothing from a pool, and a
    pool per test worker oversubscribes the cores the workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gaussian(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _kappa(n, kappa, seed=5):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((u * np.logspace(0, -np.log10(kappa), n)) @ v.T).astype(np.float32)


def _rank_deficient(n, r, seed=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, r)) @ rng.standard_normal((r, n))).astype(np.float32)


INPUTS = {
    "64x64": lambda: _gaussian((64, 64), 1),
    "96x48": lambda: _gaussian((96, 48), 2),
    "kappa1e4": lambda: _kappa(64, 1e4),
    "192x192": lambda: _gaussian((192, 192), 31),
    "256x128": lambda: _gaussian((256, 128), 32),
    "96x160": lambda: _gaussian((96, 160), 33),
    "110x100": lambda: _gaussian((110, 100), 34),
    "rank48": lambda: _rank_deficient(96, 48),
}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's result of `kind` ("qdwh", "svd", "sv") on INPUTS[name], memoized."""
    cache = {}

    def get(kind, name):
        key = (kind, name)
        if key not in cache:
            x = jnp.asarray(INPUTS[name]())
            if kind == "qdwh":
                out = jqdwh.qdwh(x)
            else:
                out = jsvd._qdwh_svd(x, compute_uv=kind == "svd")
            cache[key] = (tuple(np.asarray(a) for a in out) if isinstance(out, tuple)
                          else np.asarray(out))
        return cache[key]

    return get


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _svd_bars(x, u, s, vt):
    """(reconstruction, max |UᵀU − I|, max |VVᵀ − I|) in fp64."""
    u, s, vt = (np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float64)
                for a in (u, s, vt))
    x64 = x.astype(np.float64)
    k = s.shape[0]
    return (np.linalg.norm((u * s) @ vt - x64) / np.linalg.norm(x64),
            np.abs(u.T @ u - np.eye(k)).max(), np.abs(vt @ vt.T - np.eye(k)).max())


def _sigma64(x):
    return np.linalg.svd(x.astype(np.float64), compute_uv=False)


# ---------------------------------------------------------------------------
# qdwh: the polar decomposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["64x64", "96x48", "kappa1e4"])
def test_qdwh_matches_jax(jax_ref, name):
    """u and h within 1e-5 of JAX's (u within kappa·eps at kappa = 1e4: its
    sensitivity to roundoff grows with the condition number, h's does
    not), the same iteration count and convergence flag, u orthonormal and
    u h = x."""
    x = INPUTS[name]()
    u, h, num_iters, converged = pq.qdwh(torch.from_numpy(x))
    ju, jh, jn, jc = jax_ref("qdwh", name)
    assert _rel(u, ju) <= (1e4 * EPS32 if name == "kappa1e4" else 1e-5)
    assert _rel(h, jh) <= 1e-5
    assert num_iters == int(jn) and converged == bool(jc) and converged
    u64 = u.numpy().astype(np.float64)
    assert np.abs(u64.T @ u64 - np.eye(x.shape[1])).max() <= 1e-5
    assert _rel(u64 @ h.numpy(), x.astype(np.float64)) <= 1e-5


def test_qdwh_cholesky_failure_is_nan():
    """A Cholesky step whose x = c uᵀu + I is not positive definite (c < 0
    here) comes out NaN, as JAX's cholesky returns: cholesky_ex alone would
    leave a finite partial factor and a wrong u."""
    u = _gaussian((48, 32), 3)
    params = (1.0, -1.0, 0.5)
    got = pq._use_cholesky(torch.from_numpy(u), params).numpy()
    want = np.asarray(jqdwh._use_cholesky(jnp.asarray(u), 48, 32, params))
    assert np.isnan(want).all() and np.isnan(got).all()


def test_qdwh_argument_errors():
    with pytest.raises(ValueError, match="M >= N"):
        pq.qdwh(torch.zeros(4, 8))
    with pytest.raises(ValueError, match="full_matrices"):
        pq.svd(torch.zeros(8, 4), full_matrices=True)


# ---------------------------------------------------------------------------
# the SVD on the polar decomposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_uv", [True, False], ids=["uv", "s"])
@pytest.mark.parametrize("name", ["192x192", "256x128", "96x160", "110x100"])
def test_qdwh_svd_matches_jax(jax_ref, name, compute_uv):
    """_qdwh_svd against the JAX package's: 256x128 and 96x160 (flipped)
    take the QR pre-reduction (m > 1.15 n), 110x100 not. σ within 1e-5·σ_max
    of JAX's and of fp64; with vectors the reference test's bars
    (reconstruction, both orthogonalities < 1e-5), on JAX's too."""
    x = INPUTS[name]()
    out = psvd._qdwh_svd(torch.from_numpy(x), compute_uv=compute_uv)
    ref = jax_ref("svd" if compute_uv else "sv", name)
    s, js = (out[1], ref[1]) if compute_uv else (out, ref)
    s = s.numpy()
    s_ref = _sigma64(x)
    assert np.abs(s - js).max() <= 1e-5 * s_ref[0]
    assert np.abs(s - s_ref).max() <= 1e-5 * s_ref[0]
    assert np.all(np.diff(s) <= 0)
    if compute_uv:
        k = min(x.shape)
        assert out[0].shape == (x.shape[0], k) and out[2].shape == (k, x.shape[1])
        for factors in (out, ref):
            assert max(_svd_bars(x, *factors)) < 1e-5


def test_qdwh_svd_rank_deficient(jax_ref):
    """A rank-48 96² input (s[-1] <= n eps s[0]) takes the re-orthonormalization
    of u: U orthonormal within 1e-5 as JAX's is, σ within 1e-5·σ_max of
    JAX's, the reconstruction within 1e-5."""
    x = INPUTS["rank48"]()
    u, s, vt = psvd._qdwh_svd(torch.from_numpy(x))
    ju, js, jvt = jax_ref("svd", "rank48")
    assert s[-1] <= 96 * EPS32 * s[0]
    assert np.abs(s.numpy() - js).max() <= 1e-5 * js[0]
    for factors in ((u, s, vt), (ju, js, jvt)):
        recon, ortho_u, ortho_v = _svd_bars(x, *factors)
        assert recon < 1e-5 and ortho_u < 1e-5 and ortho_v < 1e-5


@pytest.mark.parametrize("compute_uv", [True, False], ids=["uv", "s"])
def test_qdwh_svd_non_finite_is_nan(compute_uv):
    """A NaN in the input gives NaN results, as JAX's do, and no error
    from eigh."""
    x = _gaussian((48, 48), 4)
    x[3, 4] = np.nan
    got = psvd._qdwh_svd(torch.from_numpy(x), compute_uv=compute_uv)
    want = jsvd._qdwh_svd(jnp.asarray(x), compute_uv=compute_uv)
    for g, w in (zip(got, want) if compute_uv else [(got, want)]):
        assert np.isnan(g.numpy()).all() and np.isnan(np.asarray(w)).all()


# ---------------------------------------------------------------------------
# the entries of models/svd.py on it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(192, 192), (256, 128), (96, 160)])
def test_svd_qdwh_method_matches_jax(shape):
    """svd(method="qdwh") at tests/test_models.py's sizes and bars
    (reconstruction, orthogonality, σ against fp64, all < 1e-5), σ within
    1e-5·σ_max of the JAX package's entry, dtypes and shapes as it gives."""
    x = np.random.default_rng(31).standard_normal(shape).astype(np.float32)
    u, s, vt = pm.svd(x, method="qdwh", device="cpu")
    ju, js, jvt = jm.svd(x, method="qdwh")
    k = min(shape)
    assert u.shape == ju.shape == (shape[0], k) and vt.shape == jvt.shape == (k, shape[1])
    assert u.dtype == s.dtype == vt.dtype == np.float32
    assert max(_svd_bars(x, u, s, vt)) < 1e-5
    s_ref = _sigma64(x)
    assert np.abs(s - s_ref).max() / s_ref[0] < 1e-5
    assert np.abs(s - js).max() / s_ref[0] < 1e-5


def test_singular_values_qdwh_matches_jax():
    """singular_values(finish="qdwh") at tests/test_models.py's 200²: fp64
    results, descending, within 1e-5·σ_max of fp64 and of the JAX package's."""
    x = np.random.default_rng(33).standard_normal((200, 200)).astype(np.float32)
    s = pm.singular_values(x, finish="qdwh", device="cpu")
    js = jm.singular_values(x, finish="qdwh")
    s_ref = _sigma64(x)
    assert s.dtype == np.float64 and s.shape == (200,)
    assert np.abs(s - s_ref).max() / s_ref[0] < 1e-5
    assert np.abs(s - js).max() / s_ref[0] < 1e-5


@pytest.mark.parametrize("n", [192, 200], ids=["tile_multiple", "padded"])
def test_svd_uv_finish_device(n):
    """svd(uv_finish="device"): the BDFAC's B by QDWH on the device, then
    U = P Ub, Vt = Vbᵀ Qᵀ; tests/test_models.py's bars (reconstruction,
    σ within 1e-4·σ_max of fp64), at 192 (tile 64) beside the JAX package's
    entry, and at 200 (padded to 256, Householder panels)."""
    x = np.random.default_rng(32).standard_normal((n, n)).astype(np.float32)
    u, s, vt = pm.svd(x, tile=64, uv_finish="device", device="cpu")
    s_ref = _sigma64(x)
    assert u.shape == vt.shape == (n, n) and s.shape == (n,)
    rec = (u.astype(np.float64) * s) @ vt
    assert np.linalg.norm(rec - x) / np.linalg.norm(x) < 1e-4
    assert np.abs(s - s_ref).max() / s_ref[0] < 1e-4
    if n == 192:
        _, js, _ = jm.svd(x, tile=64, uv_finish="device")
        assert np.abs(s - js).max() / s_ref[0] < 1e-4


def test_qdwh_entries_on_a_tiled_input(monkeypatch):
    """A tiled input: singular_values keeps the BDFAC route whatever the
    finish (the reference's check), svd materializes it and runs QDWH."""
    x = np.random.default_rng(35).standard_normal((96, 96)).astype(np.float32)
    m = shard_matrix(x, tile=(32, 32), storage="host", device="cpu")
    calls = []
    real = psvd._qdwh_svd
    monkeypatch.setattr(psvd, "_qdwh_svd", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    s_ref = _sigma64(x)
    s = pm.singular_values(m, finish="qdwh")
    assert not calls and np.abs(s - s_ref).max() / s_ref[0] < 1e-4
    u, s, vt = pm.svd(m, method="qdwh")
    assert calls == [{"compute_uv": True}] and max(_svd_bars(x, u, s, vt)) < 1e-5
