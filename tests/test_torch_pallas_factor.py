"""The plain versions of the port's factorization kernels
(numpywren_tpu_torch/ops/pallas_factor.py) against the JAX package's Pallas
kernels run in interpret mode, on the CPU, from the same numpy inputs.

Tolerances are tests/test_pallas_factor.py's: potrf rtol 1e-4 with atol
1e-4·max|L|, trtri and L·W = I atol 5e-5 / 1e-4, strict upper triangles
exactly 0; the chain's q within 3e-6·max(κ, 10) (its agreement bar between
two routes of the same math: roundoff grows with κ), total within
1e-6·max(κ, 10) relative, dev2 rel 1e-4 (two summation orders of the same
products) and conv equal at κ = 10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numpywren_tpu.matrix_init import random_spd
from numpywren_tpu.ops import pallas_factor as jpf
from numpywren_tpu_torch.ops import pallas_factor as pf


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [128, 256])
def test_potrf_ref_matches_jax(n):
    a = random_spd(n, seed=3)
    want = np.asarray(jpf.potrf_pallas(jnp.asarray(a), interpret=True))
    got = pf.potrf_pallas(_t(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got, pf.potrf_ref(_t(a)).numpy(), rtol=0, atol=0)
    assert np.abs(np.triu(got, 1)).max() == 0.0


def _spd_kappa(n, kappa, seed):
    """An (n, n) SPD fp32 matrix with eigenvalues logspaced from 1 to 1/κ."""
    r = np.random.default_rng(seed)
    q, _ = np.linalg.qr(r.standard_normal((n, n)))
    return ((q * np.logspace(0, -np.log10(kappa), n)) @ q.T).astype(np.float32)


@pytest.mark.parametrize("kappa", [10.0, 1e4])
def test_factor_block_rec_ref_matches_jax(kappa):
    """The potrf kernel's diagonal step (32-wide recursion) against the
    reference's 128-step column loop on the same block."""
    d = _spd_kappa(128, kappa, seed=7)
    jl, jw = jpf._factor_block_with_inverse(jnp.asarray(d))
    jl, jw = np.asarray(jl), np.asarray(jw)
    l, w = pf._factor_block_rec_ref(_t(d))
    l, w = l.numpy(), w.numpy()
    np.testing.assert_allclose(l, jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())
    np.testing.assert_allclose(w, jw, rtol=1e-4, atol=1e-4 * np.abs(jw).max())
    np.testing.assert_allclose(l @ w, np.eye(128), atol=1e-4)
    assert np.abs(np.triu(l, 1)).max() == 0.0
    assert np.abs(np.triu(w, 1)).max() == 0.0
    gl, gw = pf.potrf_diag_block(_t(d))  # the CPU route of its wrapper
    assert torch.equal(gl, torch.from_numpy(l)) and torch.equal(gw, torch.from_numpy(w))


@pytest.mark.parametrize("n", [128, 256, 384])
def test_potrf_inv_ref_matches_jax(n):
    a = random_spd(n, seed=11)
    jl, jw = jpf.potrf_inv_pallas(jnp.asarray(a), interpret=True)
    l, w = pf.potrf_inv_pallas(_t(a))
    l, w = l.numpy(), w.numpy()
    np.testing.assert_allclose(l, np.asarray(jl), rtol=1e-4, atol=1e-4 * np.abs(l).max())
    np.testing.assert_allclose(w, np.asarray(jw), rtol=1e-4, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(l @ w, np.eye(n), atol=1e-4)
    assert np.abs(np.triu(l, 1)).max() == 0.0
    assert np.abs(np.triu(w, 1)).max() == 0.0


@pytest.mark.parametrize("n", [128, 256, 384])
def test_trtri_and_trsm_refs_match_jax(n, rng):
    a = random_spd(n, seed=4)
    l = np.linalg.cholesky(a.astype(np.float64)).astype(np.float32)
    want = np.asarray(jpf.trtri_pallas(jnp.asarray(l), interpret=True))
    got = pf.trtri_pallas(_t(l)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5 * np.abs(want).max())
    np.testing.assert_allclose(l @ got, np.eye(n), atol=5e-5)
    assert np.abs(np.triu(got, 1)).max() == 0.0
    x = rng.standard_normal((n, n)).astype(np.float32)
    s = pf.trsm_pallas(_t(x), _t(l)).numpy()
    ref = np.asarray(jpf.trsm_pallas(jnp.asarray(x), jnp.asarray(l)))
    np.testing.assert_allclose(s, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("kappa", [10.0, 1e4])
@pytest.mark.parametrize("n", [128, 384, 640, 1024])
def test_inverse_levels_ref_matches_fp64(n, kappa):
    """trtri_ref (32-wide leaves, doubling from h = 32) and potrf_inv_ref's
    W (128-wide W11s, doubling from h = 128) against fp64 solve_triangular
    on the factor of an SPD matrix: relative Frobenius error <= 5e-6 (fp32
    inverses reach ~1e-6 at κ(A) = 1e4), the ragged pairs of n = 384 and 640
    included; strict upper triangles exactly 0. The launch counts of the
    card's sequences, as the kernels' sources state them."""
    a = _t(_spd_kappa(n, kappa, seed=13))
    l, w = pf.potrf_inv_ref(a)
    want = torch.linalg.solve_triangular(l.double(), torch.eye(n, dtype=torch.float64),
                                         upper=False)
    for got in (pf.trtri_ref(l), w):
        err = torch.linalg.norm(got.double() - want) / torch.linalg.norm(want)
        assert float(err) <= 5e-6
        assert torch.count_nonzero(torch.triu(got, 1)) == 0
    sizes = (128, 384, 512, 640, 1024)
    assert [pf.device_launches("trtri", m) for m in sizes] == [1, 5, 5, 7, 7]
    assert [pf.device_launches("potrf_inv", m) for m in sizes] == [1, 13, 17, 23, 35]


def test_envelope_fallback_n96():
    """Outside the envelope every wrapper takes torch.linalg, as the
    reference takes lax.linalg, and agrees with it."""
    a = random_spd(96, seed=6)
    l = pf.potrf_pallas(_t(a)).numpy()
    np.testing.assert_allclose(l, np.asarray(jpf.potrf_pallas(jnp.asarray(a))),
                               rtol=1e-4, atol=1e-4)
    l2, w = pf.potrf_inv_pallas(_t(a))
    np.testing.assert_allclose(l2.numpy() @ w.numpy(), np.eye(96), atol=1e-4)
    np.testing.assert_allclose(pf.trtri_pallas(l2).numpy(), w.numpy(), rtol=0, atol=0)
    assert not pf._supported(96, torch.float32)
    assert not pf._supported(128, torch.float64)
    assert not pf._supported(1152, torch.float32)


def _panel(rng, m, b, kappa):
    u_, _ = np.linalg.qr(rng.standard_normal((m, b)))
    v_, _ = np.linalg.qr(rng.standard_normal((b, b)))
    return ((u_ * np.logspace(0, -np.log10(kappa), b)) @ v_.T).astype(np.float32)


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("kappa", [10.0, 1e4])
def test_cholqr2_chain_ref_matches_jax(rng, rows, kappa):
    m, b = 1024, 256
    p = _panel(rng, m, b, kappa)
    if rows:
        p = p.T.copy()
    g = p @ p.T if rows else p.T @ p
    kw = dict(rows=rows, shift_c=4.0 * float(np.finfo(np.float32).eps) * (m * b) ** 0.5,
              conv_gate=0.02)
    jq, jtot, jconv, jdev2 = jpf.cholqr2_chain_pallas(jnp.asarray(g), jnp.asarray(p),
                                                      interpret=True, **kw)
    q, tot, conv, dev2 = pf.cholqr2_chain_pallas(_t(g), _t(p), **kw)
    assert np.max(np.abs(q.numpy() - np.asarray(jq))) < 3e-6 * max(kappa, 10.0)
    assert (np.linalg.norm(tot.numpy() - np.asarray(jtot))
            <= 1e-6 * max(kappa, 10.0) * np.linalg.norm(np.asarray(jtot)))
    assert abs(float(dev2) - float(jdev2)) <= 1e-4 * abs(float(jdev2))
    if kappa == 10.0:
        assert bool(conv) == bool(jconv)
    # p = q total (columns) or total q (rows), to working precision
    rec = tot.numpy() @ q.numpy() if rows else q.numpy() @ tot.numpy()
    assert np.linalg.norm(rec - p) / np.linalg.norm(p) < 5e-6


def test_chain_envelope_raises():
    g = torch.eye(96)
    with pytest.raises(ValueError):
        pf.cholqr2_chain_pallas(g, torch.ones(1024, 96), rows=False, shift_c=1e-3,
                                conv_gate=0.02)
    with pytest.raises(ValueError):  # b = 512 is past the chain's envelope
        pf.cholqr2_chain_pallas(torch.eye(512), torch.ones(1024, 512), rows=False,
                                shift_c=1e-3, conv_gate=0.02)
    assert pf.chain_supported(1024, 256, torch.float32)
    assert not pf.chain_supported(1000, 256, torch.float32)
