"""The port's fused BDFAC (compiler/lower.py: fused_bdfac and its panel
helpers) against the JAX package's, on the CPU, from the same numpy inputs.

Bars, each stated where it is used: B within 1e-4 of JAX's B (relative
Frobenius: the same sweeps in fp32, another summation order); the singular
values of B within 1e-4·σ_max of fp64 svdvals of the input (PERF.md §2's
BDFAC bar); with accumulate=True, ‖P B Qᵀ − A‖_F/‖A‖_F within 2x of JAX's
(floor 1e-6) and PᵀP, QᵀQ within 1e-5 of I; the panel helpers' outputs
within 1e-4 (relative Frobenius) of JAX's; the Newton-Schulz inverse
within 5e-5 of I as the reference test (tests/test_bdfac.py:126-157).
The JAX package's results are computed once per input (module-scoped
cache), so each JAX shape compiles once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import numpywren_tpu as jnpw
from numpywren_tpu import config as jconfig
from numpywren_tpu.compiler import lower as jl

import numpywren_tpu_torch as npw
from numpywren_tpu_torch import config as pconfig
from numpywren_tpu_torch.compiler import lower as pl
from numpywren_tpu_torch.matrix_init import shard_matrix
from numpywren_tpu_torch.ops import pallas_factor as pf
from numpywren_tpu_torch.runtime.program import PS

HI = jax.lax.Precision.HIGHEST
SIZES = [(64, 16), (96, 32), (128, 32)]


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


def _gaussian(n, seed=None):
    return np.random.default_rng(n if seed is None else seed).standard_normal(
        (n, n)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_bdfac():
    """fused_bdfac of the JAX package, memoized by (n, tile, panel_method,
    accumulate) on the input _gaussian(n)."""
    cache = {}

    def get(n, tile, panel_method="cholqr", accumulate=False):
        key = (n, tile, panel_method, accumulate)
        if key not in cache:
            out = jl.fused_bdfac(jnp.asarray(_gaussian(n)), tile, panel_method=panel_method,
                                 accumulate=accumulate)
            cache[key] = tuple(map(np.asarray, out)) if accumulate else np.asarray(out)
        return cache[key]

    return get


def _rel(got, want):
    got, want = (np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float64)
                 for a in (got, want))
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _sigma_err(b, x):
    """max |σ(B) − σ(X)| / σ_max(X), fp64."""
    s = np.linalg.svd(np.asarray(b, np.float64), compute_uv=False)
    s_ref = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    return np.abs(s - s_ref).max() / s_ref[0]


def _off_bidiagonal(b, t):
    g = b.shape[0] // t
    blocks = np.abs(b).reshape(g, t, g, t).max(axis=(1, 3))
    keep = np.eye(g, dtype=bool) | np.eye(g, k=1, dtype=bool)
    return blocks[~keep].max(initial=0.0)


@pytest.mark.parametrize("panel_method", ["cholqr", "house"])
@pytest.mark.parametrize("n,tile", SIZES)
def test_fused_bdfac_matches_jax(compensated, jax_bdfac, n, tile, panel_method):
    """B within 1e-4 of JAX's (compensated: matmul3's plain bf16x3 version
    against JAX's fp32), σ(B) within 1e-4·σ_max of fp64, the blocks off the
    diagonal and superdiagonal exactly 0; the input tensor is untouched
    (donate=False)."""
    x = _gaussian(n)
    xt = torch.from_numpy(x.copy())
    b = pl.fused_bdfac(xt, tile, panel_method=panel_method).numpy()
    np.testing.assert_array_equal(xt.numpy(), x)
    assert _rel(b, jax_bdfac(n, tile, panel_method)) <= 1e-4
    assert _sigma_err(b, x) <= 1e-4
    assert _off_bidiagonal(b, tile) == 0.0


@pytest.mark.parametrize("panel_method", ["cholqr", "house"])
@pytest.mark.parametrize("n,tile", SIZES[:2])
def test_fused_bdfac_accumulate_matches_jax(jax_bdfac, n, tile, panel_method):
    """A = P B Qᵀ: the reconstruction within 2x of JAX's (floor 1e-6), P
    and Q orthogonal within 1e-5, B within 1e-4 of JAX's."""
    x = _gaussian(n)
    b, p, q = (t.numpy().astype(np.float64) for t in pl.fused_bdfac(
        torch.from_numpy(x), tile, panel_method=panel_method, accumulate=True))
    jb, jp, jq = (a.astype(np.float64) for a in jax_bdfac(n, tile, panel_method, True))
    x64 = x.astype(np.float64)
    recon = np.linalg.norm(p @ b @ q.T - x64) / np.linalg.norm(x64)
    jrecon = np.linalg.norm(jp @ jb @ jq.T - x64) / np.linalg.norm(x64)
    assert recon <= max(2 * jrecon, 1e-6)
    for u in (p, q):
        assert np.abs(u.T @ u - np.eye(n)).max() <= 1e-5
    assert _rel(b, jb) <= 1e-4


@pytest.mark.parametrize("flag,wrapper", [
    ("NPW_GEMM_INV", "_ns_inv"),
    ("NPW_PALLAS_CHAIN", "cholqr2_chain_pallas"),
    ("NPW_PALLAS_FACTOR", "potrf_inv_pallas"),
])
def test_fused_bdfac_opt_ins(jax_bdfac, monkeypatch, flag, wrapper):
    """Each opt-in reaches its route (the Newton-Schulz S, the chain's and
    potrf_inv's wrappers, which take their plain versions on CPU tensors:
    no launch), in the QR and the LQ panels at tile 128 (the chain's
    envelope); B within 1e-4 of JAX's default B, σ within 1e-4·σ_max."""
    n, tile = 384, 128
    calls = []
    real = getattr(pl, wrapper)
    monkeypatch.setattr(pl, wrapper, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setenv(flag, "1")
    pf.reset_launches()
    b = pl.fused_bdfac(torch.from_numpy(_gaussian(n)), tile).numpy()
    assert calls and pf.LAUNCHES == dict.fromkeys(pf.LAUNCHES, 0)
    assert _rel(b, jax_bdfac(n, tile)) <= 1e-4
    assert _sigma_err(b, _gaussian(n)) <= 1e-4


def test_fused_bdfac_arguments():
    x = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="not a multiple of tile"):
        pl.fused_bdfac(x, 24)
    with pytest.raises(ValueError, match="unknown bdfac panel_method"):
        pl.fused_bdfac(x, 16, panel_method="givens")
    with pytest.raises(ValueError, match="precision must be one of"):
        pl.fused_bdfac(x, 16, precision="low")


def test_fused_bdfac_donate():
    """donate=True sweeps in the caller's tensor (the reference donates
    its buffer); the result is the same B."""
    x = _gaussian(64)
    xt = torch.from_numpy(x.copy())
    b = pl.fused_bdfac(xt, 16, donate=True)
    assert not np.array_equal(xt.numpy(), x)
    np.testing.assert_array_equal(b.numpy(), pl.fused_bdfac(torch.from_numpy(x), 16).numpy())


# ---------------------------------------------------------------------------
# the panel helpers
# ---------------------------------------------------------------------------

def _cond_matrix(rng, b, s):
    u, _ = np.linalg.qr(rng.standard_normal((b, b)))
    v, _ = np.linalg.qr(rng.standard_normal((b, b)))
    return ((u * s) @ v.T).astype(np.float32)


def test_ns_inv_matches_jax(rng):
    """cond 25 at b = 96 (the W1 regime): ‖X A − I‖_max < 5e-5, and X
    within 1e-4 of JAX's."""
    a = _cond_matrix(rng, 96, np.geomspace(2.0, 2.0 / 25.0, 96))
    x = pl._ns_inv(torch.from_numpy(a)).numpy()
    assert np.abs(x @ a - np.eye(96)).max() < 5e-5
    assert _rel(x, np.asarray(jl._ns_inv(jnp.asarray(a), HI))) <= 1e-4


def _yamamoto_w1(rng, m=96, b=32):
    """The leading block W1 = Q1 Sigma - I of a tall panel's Yamamoto W."""
    q, _ = np.linalg.qr(rng.standard_normal((m, b)))
    q1 = q[:b]
    sigma = -np.where(np.diagonal(q1) >= 0, 1.0, -1.0)
    return (q1 * sigma - np.eye(b)).astype(np.float32)


@pytest.mark.parametrize("gemm_inv", [False, True])
def test_small_inv_t_matches_jax(rng, gemm_inv):
    """Sᵀ = -W1⁻¹ by the normal equations or Newton-Schulz: Sᵀ W1 = -I
    within 5e-5, Sᵀ within 1e-4 of JAX's."""
    w1 = _yamamoto_w1(rng)
    st = pl._small_inv_t(torch.from_numpy(w1), gemm_inv=gemm_inv).numpy()
    assert np.abs(st @ w1 + np.eye(32)).max() < 5e-5
    assert _rel(st, np.asarray(jl._small_inv_t(jnp.asarray(w1), HI, gemm_inv=gemm_inv))) <= 1e-4


def _panel_case(rng, rows=96, b=32, c=64):
    return (rng.standard_normal((rows, b)).astype(np.float32),
            rng.standard_normal((rows, c)).astype(np.float32))


@pytest.mark.parametrize("fast_s", [False, True])
def test_panel_qr_update_cholqr_matches_jax(rng, fast_s):
    """(Sigma R, Hᵀ trailing) within 1e-4 of JAX's; the trailing view is
    updated in place; Hᵀ panel = [Sigma R; 0] (the reflector's W and S⁻¹
    within 1e-4 of JAX's too)."""
    panel, trailing = _panel_case(rng)
    buf = torch.from_numpy(np.hstack([panel, trailing]))
    r, tr, refl = pl._panel_qr_update_cholqr(buf[:, :32], buf[:, 32:], "high", True,
                                             conv_tol=1e-5, fast_s=fast_s)
    assert tr.data_ptr() == buf[:, 32:].data_ptr()
    jr, jtr, jrefl = jl._panel_qr_update_cholqr(jnp.asarray(panel), jnp.asarray(trailing), HI,
                                                True, conv_tol=1e-5, fast_s=fast_s)
    assert _rel(r, jr) <= 1e-4 and _rel(buf[:, 32:], jtr) <= 1e-4
    assert refl[0] == jrefl[0] == "yam"
    for a, ja in zip(refl[1:], jrefl[1:]):
        assert _rel(a, ja) <= 1e-4


@pytest.mark.parametrize("fast_s", [False, True])
def test_panel_lq_update_cholqr_matches_jax(rng, fast_s):
    """The row-form mirror: (l Sigma, body H) within 1e-4 of JAX's, body
    updated in place, ("yam_t", Wr, S⁻¹) within 1e-4 of JAX's."""
    panel, body = (a.T.copy() for a in _panel_case(rng, rows=128, b=32, c=48))
    buf = torch.from_numpy(np.vstack([panel, body]))
    lb, bd, refl = pl._panel_lq_update_cholqr(buf[:32], buf[32:], "high", True,
                                              conv_tol=1e-5, fast_s=fast_s)
    assert bd.data_ptr() == buf[32:].data_ptr()
    jl_, jbd, jrefl = jl._panel_lq_update_cholqr(jnp.asarray(panel), jnp.asarray(body), HI,
                                                 True, conv_tol=1e-5, fast_s=fast_s)
    assert _rel(lb, jl_) <= 1e-4 and _rel(buf[32:], jbd) <= 1e-4
    assert refl[0] == jrefl[0] == "yam_t"
    for a, ja in zip(refl[1:], jrefl[1:]):
        assert _rel(a, ja) <= 1e-4


@pytest.mark.parametrize("transposed", [False, True])
def test_panel_qr_update_house_matches_jax(rng, transposed):
    """geqrf + compact-WY: (R, Hᵀ trailing, V, T) within 1e-4 of JAX's; a
    transposed trailing view (the Householder LQ's bodyᵀ) is updated in
    place through its row-major transpose."""
    panel, trailing = _panel_case(rng)
    t_buf = torch.from_numpy(trailing.T.copy()).T if transposed else torch.from_numpy(
        trailing.copy())
    r, tr, refl = pl._panel_qr_update(torch.from_numpy(panel), t_buf, "high", True)
    assert tr is t_buf
    jr, jtr, jrefl = jl._panel_qr_update(jnp.asarray(panel), jnp.asarray(trailing), HI, True)
    assert _rel(r, jr) <= 1e-4 and _rel(t_buf, jtr) <= 1e-4
    for a, ja in zip(refl[1:], jrefl[1:]):
        assert _rel(a, ja) <= 1e-4


@pytest.mark.parametrize("kind", ["wy", "yam", "yam_t", "dense"])
def test_apply_reflector_right_matches_jax(rng, kind):
    """x[:, c0:] @ H in place, each reflector form, within 1e-4 of JAX's."""
    panel, _ = _panel_case(rng, rows=96 if kind != "dense" else 32)
    p = torch.from_numpy(panel)
    if kind == "wy":
        _, _, refl = pl._panel_qr_update(p, None, "high", True)
        _, _, jrefl = jl._panel_qr_update(jnp.asarray(panel), None, HI, True)
    elif kind == "yam_t":
        _, _, refl = pl._panel_lq_update_cholqr(p.T, None, "high", True)
        _, _, jrefl = jl._panel_lq_update_cholqr(jnp.asarray(panel.T), None, HI, True)
    else:
        _, _, refl = pl._panel_qr_update_cholqr(p, None, "high", True)
        _, _, jrefl = jl._panel_qr_update_cholqr(jnp.asarray(panel), None, HI, True)
    assert refl[0] == jrefl[0] == kind
    c0 = 8
    acc = rng.standard_normal((40, c0 + panel.shape[0])).astype(np.float32)
    got = pl._apply_reflector_right(torch.from_numpy(acc.copy()), refl, c0, "high")
    want = np.asarray(jl._apply_reflector_right(jnp.asarray(acc), jrefl, c0, HI))
    np.testing.assert_array_equal(got[:, :c0].numpy(), acc[:, :c0])
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("rows", [False, True])
def test_cholqr_adaptive_conv_tol_matches_jax(rng, rows):
    """conv_tol=1e-5 (BDFAC's; gate 6.3e-3) on a kappa 1e3 panel: q and R
    within 1e-4 of JAX's, orthogonality within 1e-5; the default
    (conv_tol 1e-4, gate 0.02) is unchanged: the port's q equals a run
    with conv_tol=1e-4 passed explicitly, bit for bit."""
    m, b = 512, 32
    u, _ = np.linalg.qr(rng.standard_normal((m, b)))
    v, _ = np.linalg.qr(rng.standard_normal((b, b)))
    a = ((u * np.logspace(0, -3, b)) @ v.T).astype(np.float32)
    a = a.T.copy() if rows else a
    q, r = pl._cholqr_adaptive(torch.from_numpy(a), rows=rows, conv_tol=1e-5)
    jq, jr = jl._cholqr_adaptive(jnp.asarray(a), HI, rows=rows, conv_tol=1e-5)
    assert _rel(q, jq) <= 1e-4 and _rel(r, jr) <= 1e-4
    qn = q.numpy().astype(np.float64)
    g = qn @ qn.T if rows else qn.T @ qn
    assert np.abs(g - np.eye(b)).max() <= 1e-5
    q0, _ = pl._cholqr_adaptive(torch.from_numpy(a), rows=rows)
    q1, _ = pl._cholqr_adaptive(torch.from_numpy(a), rows=rows, conv_tol=1e-4)
    np.testing.assert_array_equal(q0.numpy(), q1.numpy())


def test_chain_passes_counted(rng):
    """CHAIN_PASSES counts each chain and each extras pass where it runs: a
    kappa 1e6 panel needs extras passes past CholeskyQR2 (none when
    max_passes=2 allows none); a CholeskyQR sweep of g = 3 panels runs
    2g - 2 = 4 chains, a Householder sweep none."""
    m, b = 512, 32
    u, _ = np.linalg.qr(rng.standard_normal((m, b)))
    a = torch.from_numpy((u * np.logspace(0, -6, b)).astype(np.float32))
    pl.reset_chain_passes()
    pl._cholqr_adaptive(a, conv_tol=1e-5, max_passes=2)
    assert pl.CHAIN_PASSES == {"chains": 1, "extras": 0}
    pl._cholqr_adaptive(a, conv_tol=1e-5)
    assert pl.CHAIN_PASSES["chains"] == 2 and 1 <= pl.CHAIN_PASSES["extras"] <= 14
    for method, chains in (("cholqr", 4), ("house", 0)):
        pl.reset_chain_passes()
        pl.fused_bdfac(torch.from_numpy(_gaussian(96)), 32, panel_method=method)
        assert pl.CHAIN_PASSES["chains"] == chains


def test_failed_factor_is_nan():
    """A library factor that fails comes out as JAX's cholesky's does (a
    lower triangle of NaN), not cholesky_ex's finite partial factor."""
    a = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    got = pl._cholesky_nan(a).numpy()
    assert np.isnan(got[np.tril_indices(2)]).all()
    np.testing.assert_array_equal(got, np.asarray(jax.lax.linalg.cholesky(jnp.asarray(a.numpy()))))
    spd = torch.tensor([[4.0, 2.0], [2.0, 3.0]])
    torch.testing.assert_close(pl._cholesky_nan(spd), torch.linalg.cholesky(spd),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# run_program on bdfac programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["hbm", "host"])
@pytest.mark.parametrize("executor", ["auto", "fused"])
def test_run_program_bdfac_fused(executor, storage):
    """bdfac + run_program on both tiers runs the fused lowering: B within
    1e-4 of the JAX package's fused B, written to the caller's B on its
    tier; σ within 1e-4·σ_max of fp64. The JAX side runs on its device
    tier: its host tier's promotion drops the blocks S's parent_fn stages
    (ROADMAP Queue 3, reference-side facts), so its fused B there holds
    NaNs."""
    n, t = 96, 32
    x = _gaussian(n, seed=5)
    prog, b, _ = npw.bdfac(shard_matrix(x, tile=(t, t), storage=storage, device="cpu"),
                           storage=storage)
    assert npw.run_program(prog, executor=executor) == PS.SUCCESS
    assert b.storage == storage
    jprog, jb, _ = jnpw.bdfac(x, tile=(t, t))
    jnpw.run_program(jprog, executor="fused")
    assert _rel(b.numpy(), jb.numpy()) <= 1e-4
    assert _sigma_err(b.numpy(), x) <= 1e-4


def test_run_program_bdfac_over_budget_spills(monkeypatch):
    """A host-tier bdfac past the device budget streams through the spill
    executor (`_spill_if_over_budget`), as the JAX package's runner does:
    σ within 1e-4·σ_max of fp64 (the generic sweeps' B differs from the
    fused one by the panel algorithm)."""
    from numpywren_tpu_torch.runtime.executor import SpillTaskExecutor

    monkeypatch.setattr(npw.default_config(), "hbm_budget_bytes", 1024)
    ran = []
    monkeypatch.setattr(SpillTaskExecutor, "run",
                        lambda self, _run=SpillTaskExecutor.run, **kw: ran.append(1)
                        or _run(self, **kw))
    x = _gaussian(64, seed=6)
    prog, b, _ = npw.bdfac(shard_matrix(x, tile=(16, 16), storage="host", device="cpu"),
                           storage="host")
    assert npw.run_program(prog) == PS.SUCCESS
    assert ran == [1]
    assert _sigma_err(b.numpy(), x) <= 1e-4
