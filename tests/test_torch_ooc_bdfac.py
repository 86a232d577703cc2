"""The port's out-of-core BDFAC (numpywren_tpu_torch/runtime/spill.py:
out_of_core_bdfac, out_of_core_singular_values) against the JAX package's
(numpywren_tpu/runtime/spill.py), on the CPU, from the same numpy inputs at
the reference tests' sizes (tests/test_spill.py:406-477).

Bars, each stated where it is used: B within 1e-4 of JAX's B (relative
Frobenius: the same sweeps in fp32, another summation order; compensated
mode's plain bf16x3 version against JAX's fp32); σ(B) and the singular
values at the reference tests' bars against fp64 (rtol 2e-3, atol
1e-4·σ_max); B's band structure: below the diagonal and past 2W − 1
under 1e-5. The JAX package's results are computed once per input
(module-scoped cache), so each JAX shape compiles once.
"""

import numpy as np
import pytest
import torch

from numpywren_tpu import config as jconfig
from numpywren_tpu.matrix_init import shard_matrix as jshard
from numpywren_tpu.runtime import spill as jspill
from numpywren_tpu_torch import config as pconfig
from numpywren_tpu_torch.compiler import lower as pl
from numpywren_tpu_torch.exceptions import ShapeError
from numpywren_tpu_torch.matrix_init import shard_matrix
from numpywren_tpu_torch.models import band
from numpywren_tpu_torch.ops import pallas_factor as pf
from numpywren_tpu_torch.runtime import spill
from numpywren_tpu_torch.tiled import TiledMatrix

# (n, tile, panel_tiles): tests/test_spill.py's stream (W = 64, three LQ
# steps), its prefix and band-finish size (W = 32), and W = 128 for the
# chain's and potrf_inv's envelope
STREAM, SMALL, W128 = (192, 16, 4), (128, 16, 2), (384, 128, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these sizes gain nothing from a pool, and a
    pool per test worker oversubscribes the cores the workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=[False, True], ids=["high", "compensated"])
def compensated(request, monkeypatch):  # each package has its own config: set both
    monkeypatch.setattr(jconfig, "_default", jconfig.NpwConfig(compensated=request.param))
    monkeypatch.setattr(pconfig, "_default", pconfig.NpwConfig(compensated=request.param))
    return request.param


def _gaussian(n):
    return np.random.default_rng(n).standard_normal((n, n)).astype(np.float32)


def _host(a, tile):
    return shard_matrix(a, tile=(tile, tile), storage="host", device="cpu")


@pytest.fixture(scope="module")
def jax_ooc():
    """The JAX package's out_of_core_bdfac(...).numpy() (or, with sv=True,
    out_of_core_singular_values) on _gaussian(n), memoized by its
    arguments."""
    cache = {}

    def get(n, tile, panel_tiles, shape_mode="pow2", stop_panels=None, sv=False):
        key = (n, tile, panel_tiles, shape_mode, stop_panels, sv)
        if key not in cache:
            at = jshard(_gaussian(n), tile=(tile, tile), storage="host")
            if sv:
                cache[key] = jspill.out_of_core_singular_values(at, panel_tiles=panel_tiles)
            else:
                cache[key] = jspill.out_of_core_bdfac(
                    at, panel_tiles=panel_tiles, shape_mode=shape_mode,
                    stop_panels=stop_panels).numpy()
        return cache[key]

    return get


def _rel(got, want):
    return float(np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want))


def _check_b(b, a, w):
    """σ(B) at the reference test's bars and B's band structure."""
    assert np.abs(np.tril(b, -1)).max() < 1e-5
    assert np.abs(np.triu(b, 2 * w)).max() < 1e-5
    s = np.linalg.svd(b.astype(np.float64), compute_uv=False)
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, s_ref, rtol=2e-3, atol=1e-4 * s_ref[0])


@pytest.mark.parametrize("shape_mode", ["exact", "pow2", "full"])
def test_matches_jax(jax_ooc, compensated, shape_mode):
    """B within 1e-4 of JAX's for each shape_mode, with and without the
    compensated products; B on the host tier, the input untouched."""
    n, tile, pt = STREAM
    a = _gaussian(n)
    at = _host(a, tile)
    b = spill.out_of_core_bdfac(at, panel_tiles=pt, shape_mode=shape_mode)
    assert b.storage == "host" and b.shape == (n, n)
    np.testing.assert_array_equal(at.numpy(), a)
    got = b.numpy()
    assert _rel(got, jax_ooc(n, tile, pt, shape_mode)) <= 1e-4
    _check_b(got, a, pt * tile)


def test_highest_matches_jax(jax_ooc):
    """precision="highest" (the matmul kernel's plain fp32 version here)."""
    n, tile, pt = STREAM
    a = _gaussian(n)
    got = spill.out_of_core_bdfac(_host(a, tile), panel_tiles=pt, precision="highest").numpy()
    assert _rel(got, jax_ooc(n, tile, pt)) <= 1e-4
    _check_b(got, a, pt * tile)


def test_padding_is_invariant():
    """Zero padding changes only the summation order: pow2 and full buckets
    give exact's B within 1e-5 (the padded rows and columns stay zero
    through the applies; stale padding would move B by O(1))."""
    n, tile, pt = STREAM
    a = _gaussian(n)
    exact = spill.out_of_core_bdfac(_host(a, tile), panel_tiles=pt, shape_mode="exact").numpy()
    for mode in ("pow2", "full"):
        got = spill.out_of_core_bdfac(_host(a, tile), panel_tiles=pt, shape_mode=mode).numpy()
        assert _rel(got, exact) <= 1e-5


def test_stop_panels_matches_jax(jax_ooc):
    """stop_panels=2: the first two panel steps' B blocks land (within 1e-4
    of JAX's prefix run), the rest stays zero."""
    n, tile, pt = SMALL
    got = spill.out_of_core_bdfac(_host(_gaussian(n), tile), panel_tiles=pt,
                                  stop_panels=2).numpy()
    w = pt * tile
    assert np.abs(got[:2 * w]).max() > 0
    assert np.abs(got[2 * w:]).max() == 0
    assert _rel(got, jax_ooc(n, tile, pt, stop_panels=2)) <= 1e-4


def test_out_receives_b():
    """out= is written and returned: the same B as a run without it."""
    n, tile, pt = SMALL
    a = _gaussian(n)
    out = TiledMatrix(shape=(n, n), tile=(tile, tile), storage="host", device="cpu",
                      parent_fn=lambda m, i, j: torch.zeros(m.tile))
    b = spill.out_of_core_bdfac(_host(a, tile), panel_tiles=pt, out=out)
    assert b is out
    np.testing.assert_array_equal(
        out.numpy(), spill.out_of_core_bdfac(_host(a, tile), panel_tiles=pt).numpy())


@pytest.mark.parametrize("flag,wrapper", [
    ("NPW_PALLAS_CHAIN", "cholqr2_chain_pallas"),
    ("NPW_PALLAS_FACTOR", "potrf_inv_pallas"),
    ("NPW_GEMM_INV", "_ns_inv"),
])
def test_opt_ins_match_jax(jax_ooc, monkeypatch, flag, wrapper):
    """Each opt-in reaches its wrapper at W = 128 (the chain's envelope), in
    the QR and the LQ panels: the kernels' wrappers take their plain
    versions on CPU tensors, with no launch; B within 1e-4 of JAX's default
    B."""
    n, tile, pt = W128
    calls = []
    real = getattr(pl, wrapper)
    monkeypatch.setattr(pl, wrapper, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setenv(flag, "1")
    pf.reset_launches()
    a = _gaussian(n)
    got = spill.out_of_core_bdfac(_host(a, tile), panel_tiles=pt).numpy()
    assert len(calls) >= 2 and pf.LAUNCHES == dict.fromkeys(pf.LAUNCHES, 0)
    assert _rel(got, jax_ooc(n, tile, pt)) <= 1e-4
    _check_b(got, a, pt * tile)


def test_argument_errors():
    """The reference's ShapeErrors (a rectangular matrix, a grid that is not
    a multiple of panel_tiles), an unknown shape_mode, and a mesh= that is
    not a DeviceMesh (TypeError, as out_of_core_cholesky's; the mesh runs
    are in tests/test_torch_fabric.py)."""
    rect = shard_matrix(np.zeros((64, 32), np.float32), tile=(16, 16), storage="host",
                        device="cpu")
    with pytest.raises(ShapeError, match="square"):
        spill.out_of_core_bdfac(rect)
    sq = _host(np.zeros((48, 48), np.float32), 16)
    with pytest.raises(ShapeError, match="not a multiple of panel_tiles"):
        spill.out_of_core_bdfac(sq, panel_tiles=2)
    with pytest.raises(ValueError, match="unknown shape_mode"):
        spill.out_of_core_bdfac(sq, panel_tiles=1, shape_mode="pad")
    with pytest.raises(TypeError, match="mesh must be a DeviceMesh"):
        spill.out_of_core_bdfac(sq, panel_tiles=1, mesh=object())


def test_singular_values_match_jax(jax_ooc):
    """out_of_core_singular_values: the packed band's LAPACK finish, within
    the reference test's bars of fp64 and 1e-5·σ_max of JAX's."""
    n, tile, pt = SMALL
    a = _gaussian(n)
    s = spill.out_of_core_singular_values(_host(a, tile), panel_tiles=pt)
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    assert s.dtype == np.float64 and s.shape == (n,)
    np.testing.assert_allclose(s, s_ref, rtol=2e-3, atol=1e-4 * s_ref[0])
    assert np.abs(s - jax_ooc(n, tile, pt, sv=True)).max() <= 1e-5 * s_ref[0]


def test_singular_values_without_lapack_raise(monkeypatch):
    """Where no LAPACK library is found the finish raises RuntimeError, as
    the reference's does: there is no dense fallback here."""
    monkeypatch.setattr(band, "_lapack", lambda: None)
    with pytest.raises(RuntimeError, match="no LAPACK"):
        spill.out_of_core_singular_values(_host(_gaussian(64), 16), panel_tiles=2)
