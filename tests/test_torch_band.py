"""The port's banded finish (models/band.py, the host LAPACK dgbbrd + dbdsdc
through ctypes, and models/band_reduce.py, the bulge chase in eager torch)
against the JAX package's, on the CPU, from the same numpy inputs.

Bars: band.py's sigma equal to the JAX package's copy to the last bit (the
same host code on the same LAPACK) and within rtol 1e-10 of fp64 gesdd
(tests/test_models.py's bar); band_reduce's reduced matrix within the band
2w - 1 (leak < 1e-4 of max|A|, tests/test_band_reduce.py), its sigma within
2e-5·σ_max of fp64 (the reference test's bar), and its magnitudes within
1e-4·max|A| of JAX's (the complete QRs' signs may differ between the
packages' LAPACK calls where a block is at roundoff level, so entries are
compared up to sign); the packed band equal to packing the full reduced
matrix (atol 1e-6, the reference test's).
"""

import numpy as np
import pytest
import torch

from numpywren_tpu.models import band as jband
from numpywren_tpu.models import band_reduce as jbr

from numpywren_tpu_torch.models import band, band_reduce as br


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these sizes gain nothing from a pool, and a
    pool per test worker oversubscribes the cores the workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _needs_lapack():
    if not jband.lapack_available():
        pytest.skip("no LAPACK shared library on this host")


def _band_mat(n, d, seed=0):
    rng = np.random.default_rng(seed)
    a = np.triu(rng.standard_normal((n, n)).astype(np.float32))
    return a - np.triu(a, d + 1)


def test_lapack_probe_matches_jax():
    """The same library choice and LP64 verdict as the JAX package's copy."""
    assert band.lapack_available() == jband.lapack_available()
    if band.lapack_available():
        assert band._is_lp64(band._lapack()) and jband._is_lp64(jband._lapack())


@pytest.mark.parametrize("n,ku", [(200, 17), (96, 40)])
def test_band_sigma_lapack_matches_jax(rng, n, ku):
    _needs_lapack()
    a = np.triu(rng.standard_normal((n, n)))
    a = a - np.triu(a, ku + 1)
    s = band.band_sigma_lapack(a, ku=ku)
    np.testing.assert_array_equal(s, jband.band_sigma_lapack(a, ku=ku))
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False), rtol=1e-10, atol=1e-12)


def test_band_sigma_packed_matches_jax(rng):
    _needs_lapack()
    n, ku = 150, 9
    a = np.triu(rng.standard_normal((n, n)))
    a = a - np.triu(a, ku + 1)
    ab = band._pack_band(a, 0, ku)
    np.testing.assert_array_equal(ab, jband._pack_band(a, 0, ku))
    # dgbbrd overwrites its band argument in place (in both packages)
    s = band.band_sigma_packed(ab.copy(order="F"), n, n, 0, ku)
    np.testing.assert_array_equal(s, jband.band_sigma_packed(ab.copy(order="F"), n, n, 0, ku))
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False), rtol=1e-10, atol=1e-12)


def _reduced_checks(red, ku2, a, want):
    n = a.shape[0]
    scale = np.abs(red).max()
    assert np.abs(np.tril(red, -1)).max() < 1e-4 * scale
    assert np.abs(np.triu(red, ku2 + 1)).max() < 1e-4 * scale
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    s = np.sort(np.linalg.svd(red.astype(np.float64), compute_uv=False))[::-1][:n]
    np.testing.assert_allclose(s, s_ref, atol=2e-5 * s_ref[0], rtol=0)
    assert red.shape == want.shape
    assert np.abs(np.abs(red) - np.abs(want)).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("n,d,w", [(256, 64, 32), (512, 128, 32), (384, 96, 32),
                                   (250, 33, 16)])
def test_band_reduce_matches_jax(n, d, w):
    """The reference test's (n, d, w), and n not a multiple of w with d
    just above 2w - 1 (D = 3)."""
    a = _band_mat(n, d)
    red, ku2 = br.band_reduce(a, ku=d, w=w, device="cpu")
    jred, jku2 = jbr.band_reduce(a, ku=d, w=w)
    assert ku2 == jku2 == 2 * w - 1
    _reduced_checks(red, ku2, a, jred)


def test_band_reduce_tensor_input_stays_on_its_device():
    """A tensor is chased where it lies (here the CPU) with no device=."""
    a = _band_mat(128, 40, seed=2)
    red, ku2 = br.band_reduce(torch.from_numpy(a), ku=40, w=16)
    _reduced_checks(red, ku2, a, jbr.band_reduce(a, ku=40, w=16)[0])


def test_band_reduce_packed_matches_jax():
    """The packed band equals packing the full reduced matrix, its
    magnitudes match JAX's packed band, and its dgbbrd finish matches fp64
    sigma (rtol/atol 1e-4, the reference test's)."""
    n, d, w = 256, 64, 16
    a = _band_mat(n, d, seed=3)
    red, ku2 = br.band_reduce(a, ku=d, w=w, device="cpu")
    ab, ku2p, m = br.band_reduce_packed(a, ku=d, w=w, device="cpu")
    jab, jku2, jm = jbr.band_reduce_packed(a, ku=d, w=w)
    assert ku2p == ku2 == jku2 and m == red.shape[0] == jm
    ref = np.zeros((ku2 + 1, m), dtype=red.dtype)
    for r in range(ku2 + 1):
        off = ku2 - r
        ref[r, off:] = np.diagonal(red, offset=off)
    np.testing.assert_allclose(ab, ref, rtol=0, atol=1e-6)
    assert np.abs(np.abs(ab) - np.abs(jab)).max() <= 1e-4 * np.abs(jab).max()
    if band.lapack_available():
        s = band.band_sigma_packed(ab.astype(np.float64), m, m, 0, ku2)[:n]
        s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
        np.testing.assert_allclose(s, s_ref, rtol=1e-4, atol=1e-4)


def test_band_reduce_narrow_is_a_no_op():
    """ku <= 2w - 1: band_reduce hands the input back and the packed form
    packs it unchanged, as the JAX package's do."""
    a = _band_mat(128, 30)
    red, ku2 = br.band_reduce(a, ku=30, w=32)
    assert red is a and ku2 == 30
    a = _band_mat(128, 16, seed=4)
    ab, ku2, m = br.band_reduce_packed(a, ku=16, w=16)
    jab, _, _ = jbr.band_reduce_packed(a, ku=16, w=16)
    assert ku2 == 16 and m == 128
    np.testing.assert_array_equal(ab, jab)


def test_band_reduce_errors_and_guard():
    with pytest.raises(ValueError, match="square"):
        br.band_reduce(np.zeros((4, 8), np.float32), ku=3)
    a = _band_mat(256, 64, seed=3)
    red, ku2, n = br.band_reduce_sigma_prep(a, 64, w=16, device="cpu")
    assert ku2 == 31 and n == 256 and red.shape == jbr.band_reduce_sigma_prep(a, 64, w=16)[0].shape


def test_chase_windows_stay_in_bounds():
    """With the padding band_reduce adds, no hop's window or slab start
    needs JAX's clamp (so the clamp only matters on a shorter operand, the
    next test); chase_hops counts the hops."""
    for w in (2, 4, 16):
        for n in range(6, 130, 7):
            for ku in range(2 * w, min(n, 6 * w)):
                D, p0, nr, m, hmax = br._geometry(n, ku, w)
                win = (D + 2) * w
                hops = list(br._hops(D, p0, nr, hmax))
                assert br.chase_hops(n, ku, w) == len(hops)
                for rho, pi in hops:
                    r0, c0 = (pi - 1 - D) * w, (pi - 1) * w
                    assert 0 <= r0 <= m - win and 0 <= c0 <= m - win
                    assert 0 <= rho * w - r0 <= win - w


def test_chase_clamped_windows_match_jax():
    """On an operand with four blocks of trailing padding in place of
    band_reduce's eight, the last windows of n = 20, w = 8, ku = 16 (n not
    a multiple of w, ku just above 2w - 1) run past its end: both packages
    clamp their starts the same way, so the chased operands agree
    (magnitudes within 1e-5·max|A|; a longer clamped chase mixes garbage
    blocks and amplifies roundoff, so this is the short one)."""
    n, ku, w = 20, 16, 8
    D, p0, nr, _, hmax = br._geometry(n, ku, w)
    m = (p0 + nr + 4) * w
    win = (D + 2) * w
    clamped = sum((pi - 1) * w > m - win for _, pi in br._hops(D, p0, nr, hmax))
    assert clamped == 3
    a = np.zeros((m, m), np.float32)
    a[p0 * w:p0 * w + n, p0 * w:p0 * w + n] = _band_mat(n, ku, seed=9)
    got = torch.from_numpy(a.copy())
    br._chase(got, w, D, p0, nr, hmax)
    want = np.asarray(jbr._chase_fn(w, D, p0, nr, hmax)(a))
    assert np.abs(np.abs(got.numpy()) - np.abs(want)).max() <= 1e-5 * np.abs(want).max()
