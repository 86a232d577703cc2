"""The plain versions of the port's factorization kernels
(numpywren_tpu_torch/ops/pallas_factor.py) against the JAX package's Pallas
kernels run in interpret mode, on the CPU, from the same numpy inputs.

Tolerances are tests/test_pallas_factor.py's: potrf rtol 1e-4 with atol
1e-4·max|L|, trtri and L·W = I atol 5e-5 / 1e-4, strict upper triangles
exactly 0; the chain's q within 3e-6·max(κ, 10) (its agreement bar between
two routes of the same math: roundoff grows with κ), total within
1e-6·max(κ, 10) relative, dev2 rel 1e-4 (two summation orders of the same
products) and conv equal at κ = 10. The chain's launch sequence in plain
PyTorch (_cholqr2_chain_steps_ref: its blocked factor and doubling
inverse, its product order, the apply through three bf16 planes) holds the
same bars against the JAX kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numpywren_tpu.matrix_init import random_spd
from numpywren_tpu.ops import pallas_factor as jpf
from numpywren_tpu_torch.ops import pallas_factor as pf
from numpywren_tpu_torch.ops.gemm import _planes_of


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


def _chain_inputs(seed, m, b, kappa, rows):
    p = _panel(np.random.default_rng(seed), m, b, kappa)
    if rows:
        p = p.T.copy()
    g = p @ p.T if rows else p.T @ p
    return g, p


def _chain_kw(m, b, rows):
    return dict(rows=rows, shift_c=4.0 * float(np.finfo(np.float32).eps) * (m * b) ** 0.5,
                conv_gate=0.02)


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("kappa", [10.0, 1e4])
@pytest.mark.parametrize("b", [128, 256])
def test_chain_steps_ref_matches_jax(b, kappa, rows):
    """The launch sequence's arithmetic (the kernel's plain version on the
    card) against the JAX kernel: the bars of the chain's CPU route."""
    m = 1024
    g, p = _chain_inputs(17, m, b, kappa, rows)
    kw = _chain_kw(m, b, rows)
    jq, jtot, jconv, jdev2 = jpf.cholqr2_chain_pallas(jnp.asarray(g), jnp.asarray(p),
                                                      interpret=True, **kw)
    q, tot, conv, dev2 = pf._cholqr2_chain_steps_ref(_t(g), _t(p), **kw)
    assert np.max(np.abs(q.numpy() - np.asarray(jq))) < 3e-6 * max(kappa, 10.0)
    assert (np.linalg.norm(tot.numpy() - np.asarray(jtot))
            <= 1e-6 * max(kappa, 10.0) * np.linalg.norm(np.asarray(jtot)))
    assert abs(float(dev2) - float(jdev2)) <= 1e-4 * abs(float(jdev2))
    if kappa == 10.0:
        assert bool(conv) == bool(jconv)
    rec = tot.numpy() @ q.numpy() if rows else q.numpy() @ tot.numpy()
    assert np.linalg.norm(rec - p) / np.linalg.norm(p) < 5e-6


@pytest.mark.parametrize("rows", [False, True])
def test_chain_identity_branch_matches_jax(rows):
    """A shift so large that dev2 >= 0.1: the fold is the identity (R = L1,
    linv = W1), conv is False, every output finite, in both plain versions
    as in the JAX kernel."""
    m, b = 1024, 128
    g, p = _chain_inputs(5, m, b, 10.0, rows)
    kw = dict(rows=rows, shift_c=1.0, conv_gate=0.02)
    jq, jtot, jconv, jdev2 = jpf.cholqr2_chain_pallas(jnp.asarray(g), jnp.asarray(p),
                                                      interpret=True, **kw)
    assert float(jdev2) >= 0.1 and not bool(jconv)
    for fn in (pf.cholqr2_chain_ref, pf._cholqr2_chain_steps_ref):
        q, tot, conv, dev2 = fn(_t(g), _t(p), **kw)
        assert float(dev2) >= 0.1 and not bool(conv)
        for x in (q, tot, dev2):
            assert bool(torch.isfinite(x).all())
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0,
                                   atol=3e-6 * np.abs(np.asarray(jq)).max())
        np.testing.assert_allclose(tot.numpy(), np.asarray(jtot), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jtot)).max())
        assert abs(float(dev2) - float(jdev2)) <= 1e-4 * abs(float(jdev2))
        floor = kw["shift_c"] * torch.max(torch.sum(torch.abs(_t(g)), dim=1))
        l1, _ = pf.potrf_inv_ref(_t(g) + floor * torch.eye(b))
        assert torch.equal(tot, l1 if rows else l1.T)  # R = L1: the fold is I


@pytest.mark.parametrize("rows", [False, True])
def test_chain_failed_factor_takes_the_identity_fold(rows):
    """g with its last diagonal entry negated: the shifted factor's last
    pivot is negative, so L1, W1 and E2 hold NaN. dev2 is NaN (the max
    carries it) and conv False, as in the JAX kernel; the plain versions
    then take the identity fold (dev2 < 0.1 does not hold), so R = L1 and
    only its failed row (rows) or column (columns) is NaN: the Neumann
    fold would spread the NaN over all of R."""
    m, b = 1024, 128
    g, p = _chain_inputs(5, m, b, 10.0, rows)
    g[-1, -1] = -g[-1, -1]
    kw = _chain_kw(m, b, rows)
    _, _, jconv, jdev2 = jpf.cholqr2_chain_pallas(jnp.asarray(g), jnp.asarray(p),
                                                  interpret=True, **kw)
    assert np.isnan(float(jdev2)) and not bool(jconv)
    floor = kw["shift_c"] * torch.max(torch.sum(torch.abs(_t(g)), dim=1))
    l1, _ = pf.potrf_inv_ref(_t(g) + floor * torch.eye(b))
    want = l1 if rows else l1.T
    failed = torch.zeros(b, b, dtype=torch.bool)
    if rows:
        failed[-1] = True
    else:
        failed[:, -1] = True
    for fn in (pf.cholqr2_chain_ref, pf._cholqr2_chain_steps_ref):
        _, tot, conv, dev2 = fn(_t(g), _t(p), **kw)
        assert torch.isnan(dev2) and not bool(conv)
        assert torch.equal(torch.isnan(tot), failed)
        assert torch.equal(tot[~failed], want[~failed])


@pytest.mark.parametrize("b", [128, 256])
def test_chain_device_launches(b):
    """One chain call's device launches, from the sequence's structure
    (csrc/cholqr_chain.cu): the row sums and the shift, npw_potrf_inv's
    sequence, P, the fold's preparation, four Neumann products and one
    "+ I", the select, linv and R, two packs and one mainloop."""
    potrf_inv = (4 * b // 128 - 3) + 2 * int(np.ceil(np.log2(b // 128)))
    want = 2 + potrf_inv + 1 + 1 + 5 + 1 + 2 + 3
    assert pf.device_launches("cholqr2_chain", b) == want == {128: 16, 256: 22}[b]
    assert pf.device_launches("potrf_inv", b) == potrf_inv


@pytest.mark.parametrize("precision", [None, "high", "highest", "default", "bogus"])
def test_chain_apply_precision(precision):
    """precision= is checked and routes nothing apart: None and "high" are
    the reference's "highest", and every string runs the apply at three
    bf16 planes on the card, as ops.gemm.matmul runs "highest" and
    "default" for fp32 operands; on the CPU the call is cholqr2_chain_ref
    bit for bit. An unknown string raises, on the CPU route too."""
    g, p = _chain_inputs(3, 256, 128, 10.0, False)
    kw = _chain_kw(256, 128, False)
    if precision == "bogus":
        with pytest.raises(ValueError):
            pf.cholqr2_chain_pallas(_t(g), _t(p), precision=precision, **kw)
        return
    assert _planes_of(torch.float32) == 3
    got = pf.cholqr2_chain_pallas(_t(g), _t(p), precision=precision, **kw)
    for x, y in zip(got, pf.cholqr2_chain_ref(_t(g), _t(p), **kw)):
        assert torch.equal(x, y)
