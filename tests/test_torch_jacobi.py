"""The port's block-Jacobi SVD (numpywren_tpu_torch/models/jacobi.py) against
the JAX package's, on the CPU, from the same numpy inputs.

Bars: the reference tests' `_check` (tests/test_jacobi.py: reconstruction
< 1e-4, both orthogonalities < 1e-5, sigma within rtol 2e-3 / atol
1e-4·s_max of fp64), held by both packages; the port's sigma within
1e-5·s_max of JAX's; on the kappa ladder the port's reconstruction within
2x JAX's + 1e-6; svd_refine's factors within 1e-5 (max abs) of JAX's; a
sweep over tied Gram diagonals within 1e-4 (max abs) of JAX's; a converged
sweep bit for bit the identity.
"""

import jax
import numpy as np
import pytest
import torch

from numpywren_tpu.models import jacobi as jjac
from numpywren_tpu_torch import models
from numpywren_tpu_torch.models import jacobi as jac


def _logspace_matrix(rng, m, n, kappa):
    k = min(m, n)
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = np.logspace(0, -np.log10(kappa), k)
    return ((u * s) @ v.T).astype(np.float32)


def _np(*arrs):
    return [np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float64)
            for a in arrs]


def _recon(x, u, s, vt):
    x64, u, s, vt = _np(x, u, s, vt)
    return np.linalg.norm(u * s @ vt - x64) / max(np.linalg.norm(x64), 1e-30)


def _check(x, u, s, vt, recon_tol=1e-4, ortho_tol=1e-5, s_atol=1e-4):
    """tests/test_jacobi.py's _check."""
    x64, u, s, vt = _np(x, u, s, vt)
    m, n = x.shape
    k = min(m, n)
    assert u.shape == (m, k) and s.shape == (k,) and vt.shape == (k, n)
    assert np.all(np.diff(s) <= 1e-6 * s[0])
    assert _recon(x, u, s, vt) < recon_tol
    assert np.linalg.norm(u.T @ u - np.eye(k)) / np.sqrt(k) < ortho_tol
    assert np.linalg.norm(vt @ vt.T - np.eye(k)) / np.sqrt(k) < ortho_tol
    s_ref = np.linalg.svd(x64, compute_uv=False)
    np.testing.assert_allclose(s, s_ref, rtol=2e-3, atol=s_atol * s_ref[0])


def _both(x, **kw):
    port = jac.svd_jacobi(x, device="cpu", **kw)
    ref = jjac.svd_jacobi(x, **kw)
    return port, ref


@pytest.mark.parametrize("g", [2, 4, 6, 8, 10])
def test_roundrobin_schedule_matches_jax(g):
    np.testing.assert_array_equal(jac.roundrobin_schedule(g), jjac.roundrobin_schedule(g))


@pytest.mark.parametrize("g", [0, 5])
def test_roundrobin_schedule_odd_raises(g):
    with pytest.raises(ValueError, match="even g"):
        jac.roundrobin_schedule(g)


def _blocks(w, g, b):
    return torch.from_numpy(np.ascontiguousarray(w.T.reshape(g, b, -1).transpose(0, 2, 1)))


def test_converged_sweep_is_bitexact(rng):
    """Orthogonal column blocks pass a thresholded sweep bit for bit: every
    pair takes the exact identity (tests/test_jacobi.py's case)."""
    n, b = 128, 16
    g = n // b
    q, _ = np.linalg.qr(rng.standard_normal((n, n)).astype(np.float32))
    w0 = (q * np.linspace(2.0, 1.0, n, dtype=np.float32)).astype(np.float32)
    w, v = _blocks(w0, g, b), _blocks(np.eye(n, dtype=np.float32), g, b)
    perms = torch.from_numpy(jac.roundrobin_schedule(g)).long()
    w1, v1 = jac._sweep(w, v, perms, g=g, b=b, skip_rel=1e-5)
    assert torch.equal(w1, w) and torch.equal(v1, v)


def test_tied_diagonal_sweep_matches_jax(rng):
    """Every column has the same squared norm, exactly (entries in {-1, 0, 1},
    six nonzeros a column): all Gram diagonals tie, so the rank reorder is
    the stable sort's index order. One sweep (three rounds) equals JAX's
    (stable argsort) within 1e-4, max abs: the entries are O(1), and
    eigenvectors of the integer Grams' close eigenvalues carry ~1e-5 of
    roundoff, where another tie order would move whole columns."""
    m, n, b = 64, 32, 8
    g = n // b
    w0 = np.zeros((m, n), np.float32)
    for j in range(n):
        rows = rng.choice(m, 6, replace=False)
        w0[rows, j] = rng.choice([-1.0, 1.0], 6)
    w, v = _blocks(w0, g, b), _blocks(np.eye(n, dtype=np.float32), g, b)
    perms = jac.roundrobin_schedule(g)
    gram = w0.T @ w0
    assert np.all(np.diag(gram) == 6.0)
    w1, v1 = jac._sweep(w, v, torch.from_numpy(perms).long(), g=g, b=b)
    jw1, jv1 = jjac._sweep(jax.numpy.asarray(w.numpy()), jax.numpy.asarray(v.numpy()),
                           jax.numpy.asarray(perms), g=g, b=b,
                           prec=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(w1.numpy(), np.asarray(jw1), atol=1e-4)
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv1), atol=1e-4)


@pytest.mark.parametrize("n,block", [(96, 16), (128, 32), (256, 64)])
def test_square_matches_jax(rng, n, block):
    x = rng.standard_normal((n, n)).astype(np.float32)
    (u, s, vt), (ju, js, jvt) = _both(x, block=block)
    assert all(t.device.type == "cpu" for t in (u, s, vt))
    _check(x, u, s, vt)
    _check(x, ju, js, jvt)
    s, js = _np(s, js)
    assert np.max(np.abs(s - js)) <= 1e-5 * js[0]


@pytest.mark.parametrize("shape,block", [((150, 150), 32), ((256, 96), 32), ((96, 256), 32)])
def test_ragged_and_rectangular_match_jax(rng, shape, block):
    x = rng.standard_normal(shape).astype(np.float32)
    (u, s, vt), (ju, js, jvt) = _both(x, block=block)
    _check(x, u, s, vt)
    _check(x, ju, js, jvt)
    s, js = _np(s, js)
    assert np.max(np.abs(s - js)) <= 1e-5 * js[0]


@pytest.mark.parametrize("kappa", [1e2, 1e4, 1e6])
def test_kappa_ladder_recon_against_jax(rng, kappa):
    """The graded polish and refinement on a logspace spectrum: the port's
    reconstruction within 2x JAX's + 1e-6, both orthogonalities at working
    precision."""
    x = _logspace_matrix(rng, 128, 128, kappa)
    (u, s, vt), (ju, js, jvt) = _both(x, block=32)
    assert _recon(x, u, s, vt) <= 2.0 * _recon(x, ju, js, jvt) + 1e-6
    _check(x, u, s, vt, recon_tol=5e-6, s_atol=2e-5)


def test_rank_deficient_zero_columns(rng):
    """Exact rank 40 of 96: trailing sigmas ~0, their U columns exact zeros,
    the reconstruction holds; sigma within 1e-5·s_max of JAX's."""
    r = 40
    x = (rng.standard_normal((96, r)) @ rng.standard_normal((r, 96))).astype(np.float32)
    (u, s, vt), (_, js, _) = _both(x, block=32)
    u, s, js = _np(u, s, js)
    assert np.all(s[r:] < 1e-3 * s[0])
    assert _recon(x, u, s, vt) < 1e-4
    assert np.linalg.norm(u[:, :r].T @ u[:, :r] - np.eye(r)) < 1e-4
    assert np.max(np.abs(s - js)) <= 1e-5 * js[0]


@pytest.mark.parametrize("shape", [(64, 64), (40, 80)])
def test_rank_completion(rng, shape):
    """rank_tol > 0 completes U to an orthonormal basis (for a wide input,
    U, not Vt); the completion's noise is the port's own generator, so only
    orthonormality and the leading columns are compared."""
    m, n = shape
    r = 20
    x = (rng.standard_normal((m, r)) @ rng.standard_normal((r, n))).astype(np.float32)
    u, s, vt = jac.svd_jacobi(x, block=16, rank_tol=1e-5, device="cpu")
    u0 = jac.svd_jacobi(x, block=16, device="cpu")[0]
    u, u0, s = _np(u, u0, s)
    k = min(m, n)
    assert np.linalg.norm(u.T @ u - np.eye(k)) / np.sqrt(k) < 1e-5
    assert _recon(x, u, s, vt) < 1e-4
    np.testing.assert_allclose(u[:, :r], u0[:, :r], atol=1e-5)


def test_sigma_only_matches_jax(rng):
    x = rng.standard_normal((128, 128)).astype(np.float32)
    s, js = _both(x, block=32, compute_uv=False)
    s, js = _np(s, js)
    np.testing.assert_allclose(s, np.linalg.svd(x.astype(np.float64), compute_uv=False),
                               rtol=1e-3, atol=1e-4)
    assert np.max(np.abs(s - js)) <= 1e-5 * js[0]


def test_tiny_host_path(rng):
    """n <= 8: one host LAPACK call, the factors on the input's device."""
    x = rng.standard_normal((5, 3)).astype(np.float32)
    (u, s, vt), (_, js, _) = _both(x)
    assert isinstance(u, torch.Tensor) and u.device.type == "cpu"
    _check(x, u, s, vt, recon_tol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


def test_nonconvergence_warns(rng):
    x = rng.standard_normal((96, 96)).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="did not converge"):
        jac.svd_jacobi(x, block=16, max_sweeps=1, tol=1e-12, device="cpu")


def test_sweep_trace_matches_jax(rng):
    """One host read of the off-norm a sweep: the same number of sweeps as
    JAX's, each off-norm within 1e-5 + 10% of JAX's."""
    x = rng.standard_normal((192, 192)).astype(np.float32)
    tr, jtr = [], []
    jac.svd_jacobi(x, block=32, _sweep_trace=tr, compute_uv=False, device="cpu")
    jjac.svd_jacobi(x, block=32, _sweep_trace=jtr, compute_uv=False)
    assert len(tr) == len(jtr)
    np.testing.assert_allclose(tr, jtr, rtol=0.1, atol=1e-5)


def test_svd_refine_matches_jax(rng):
    """The same factors perturbed at 1e-4 refine to within 1e-5 of JAX's in two
    steps; the caller's tensors are not written."""
    n = 192
    s_true = np.logspace(0, -3, n)
    qu, _ = np.linalg.qr(rng.standard_normal((n, n)))
    qv, _ = np.linalg.qr(rng.standard_normal((n, n)))
    x = ((qu * s_true) @ qv.T).astype(np.float32)
    u0 = (qu + 1e-4 * rng.standard_normal((n, n))).astype(np.float32)
    vt0 = (qv + 1e-4 * rng.standard_normal((n, n))).astype(np.float32).T.copy()
    s0 = s_true.astype(np.float32)
    u_in, vt_in = torch.from_numpy(u0.copy()), torch.from_numpy(vt0.copy())
    u1, s1, vt1 = models.svd_refine(x, u_in, s0, vt_in, steps=2, device="cpu")
    ju, js, jvt = jjac.svd_refine(x, u0, s0, vt0, steps=2)
    assert torch.equal(u_in, torch.from_numpy(u0)) and torch.equal(vt_in, torch.from_numpy(vt0))
    assert _recon(x, u1, s1, vt1) < 5e-6
    for got, want in ((u1, ju), (s1, js), (vt1, jvt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_precision_is_checked(rng):
    x = rng.standard_normal((16, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="precision"):
        jac.svd_jacobi(x, precision="HIGHEST", device="cpu")
