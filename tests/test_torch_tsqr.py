"""The port's TSQR path against the JAX package's, on the CPU, from the same
numpy inputs: the adaptive CholeskyQR chain (`_cholqr_adaptive`, the
library route and the opt-in kernel routes, which run their plain versions
here), `fused_tsqr` for each method, and `npw.tsqr` + `run_program` +
`tsqr_r_factor`.

Tolerances: tests/test_tsqr.py's (R rtol 5e-3, atol 5e-4 after fixing the
row signs by diag(R); Q R = X rtol/atol 5e-3; QᵀQ = I atol 5e-4), and for
the chain tests/test_pallas_factor.py's grades (orthogonality
‖QᵀQ - I‖_F/√b < 2e-5, residual ‖QR - X‖/‖X‖ < 5e-6, Q within
3e-6·max(κ, 10) of the other route's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import numpywren_tpu as jnpw
from numpywren_tpu.compiler import lower as jlower
from numpywren_tpu_torch import alg_wrappers as aw
from numpywren_tpu_torch.compiler import lower
from numpywren_tpu_torch.ops import pallas_factor as pf
from numpywren_tpu_torch.runtime.program import PS

FLAGS = ("NPW_PALLAS_FACTOR", "NPW_PALLAS_CHAIN")


def _sign_fixed(r):
    s = np.sign(np.diag(r))
    s[s == 0] = 1.0
    return s[:, None] * r


def _assert_r_close(r, r_ref):
    np.testing.assert_allclose(_sign_fixed(r), _sign_fixed(r_ref), rtol=5e-3, atol=5e-4)


def _panel(rng, m, b, kappa):
    u_, _ = np.linalg.qr(rng.standard_normal((m, b)))
    v_, _ = np.linalg.qr(rng.standard_normal((b, b)))
    return ((u_ * np.logspace(0, -np.log10(kappa), b)) @ v_.T).astype(np.float32)


@pytest.mark.parametrize("flags", ["off", "on"])
@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("kappa", [10.0, 1e4, 1e6])
def test_cholqr_adaptive_matches_jax(rng, monkeypatch, flags, rows, kappa):
    m, b = 1024, 256
    p = _panel(rng, m, b, kappa)
    if rows:
        p = p.T.copy()
    for name in FLAGS:
        monkeypatch.setenv(name, "1" if flags == "on" else "0")
    jq, jr = jax.jit(lambda x: jlower._cholqr_adaptive(
        x, lax.Precision.HIGHEST, rows=rows))(jnp.asarray(p))
    pf.reset_launches()
    q, r = lower._cholqr_adaptive(torch.from_numpy(p), rows=rows)
    assert pf.LAUNCHES == dict.fromkeys(pf.LAUNCHES, 0)  # CPU: plain versions only
    q, r, jq, jr = q.numpy(), r.numpy(), np.asarray(jq), np.asarray(jr)
    if rows:  # p = l q: compare as the transposed QR
        q, r, jq, jr, p = q.T, r.T, jq.T, jr.T, p.T
    assert np.linalg.norm(q.T @ q - np.eye(b)) / np.sqrt(b) < 2e-5
    assert np.linalg.norm(q @ r - p) / np.linalg.norm(p) < 5e-6
    _assert_r_close(r, jr)
    np.testing.assert_allclose(q @ r, jq @ jr, rtol=5e-3, atol=5e-3)
    # the same math in two frameworks: Q agrees to roundoff grown by κ
    assert np.max(np.abs(q - jq)) < 3e-6 * max(kappa, 10.0)


def test_cholqr_adaptive_gemm_inv(rng, monkeypatch):
    """NPW_GEMM_INV=1: the GEMM-only triangular inverse in the library route."""
    monkeypatch.setenv("NPW_GEMM_INV", "1")
    p = _panel(rng, 512, 128, 1e4)
    jq, jr = jax.jit(lambda x: jlower._cholqr_adaptive(
        x, lax.Precision.HIGHEST))(jnp.asarray(p))
    q, r = lower._cholqr_adaptive(torch.from_numpy(p))
    _assert_r_close(r.numpy(), np.asarray(jr))
    assert np.linalg.norm(q.numpy().T @ q.numpy() - np.eye(128)) / np.sqrt(128) < 2e-5
    l = torch.linalg.cholesky(torch.from_numpy(p.T @ p).double()).float()
    np.testing.assert_allclose((l @ lower._trtri_gemm(l)).numpy(), np.eye(128), atol=1e-4)


@pytest.mark.parametrize("method", ["tree", "cholqr2", "cholqr3s"])
@pytest.mark.parametrize("compute_q", [False, True])
def test_fused_tsqr_matches_jax(rng, method, compute_q):
    x = rng.standard_normal((320, 32)).astype(np.float32)  # 5 leaves: a ragged tree
    want = jlower.fused_tsqr(jnp.asarray(x), 64, compute_q=compute_q, method=method)
    got = lower.fused_tsqr(torch.from_numpy(x), 64, compute_q=compute_q, method=method)
    if not compute_q:
        _assert_r_close(got.numpy(), np.asarray(want))
        return
    q, r = (t.numpy() for t in got)
    _assert_r_close(r, np.asarray(want[1]))
    np.testing.assert_allclose(q @ r, x, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(q.T @ q, np.eye(32), atol=5e-4)


@pytest.mark.parametrize("b_fac,compute_q", [(2, False), (2, True), (3, False)])
@pytest.mark.parametrize("method", ["tree", "cholqr3s"])
def test_tsqr_entry_matches_jax(rng, b_fac, compute_q, method):
    x = rng.standard_normal((576, 32)).astype(np.float32)  # 9 leaves
    kw = dict(tile_rows=64, compute_q=compute_q, method=method, b_fac=b_fac)
    prog, out, meta = aw.tsqr(x, device="cpu", **kw)
    jprog, jout, jmeta = jnpw.tsqr(x, **kw)
    assert meta == jmeta
    assert aw.run_program(prog) == PS.SUCCESS
    jnpw.run_program(jprog)
    r = aw.tsqr_r_factor(out)
    _assert_r_close(r, jnpw.tsqr_r_factor(jout))
    _assert_r_close(r, np.linalg.qr(x.astype(np.float64), mode="r"))
    if compute_q:
        q = out["Q"].numpy()
        np.testing.assert_allclose(q @ r, x, rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(q.T @ q, np.eye(32), atol=5e-4)


def test_tsqr_entry_checks():
    x = np.ones((256, 32), np.float32)
    with pytest.raises(ValueError):
        aw.tsqr(x, tile_rows=64, b_fac=1, device="cpu")
    with pytest.raises(Exception, match="compute_q requires b_fac=2"):
        aw.tsqr(x, tile_rows=64, b_fac=3, compute_q=True, device="cpu")
    with pytest.raises(ValueError, match="unknown tsqr method"):
        lower.fused_tsqr(torch.from_numpy(x), 64, method="bogus")
    prog, out, _ = aw.tsqr(x, tile_rows=64, storage="host", device="cpu")
    assert out["R"].storage == "host" and out["R"].block_idxs_exist == []
    with pytest.raises(ValueError, match="unknown storage tier"):
        aw.tsqr(x, tile_rows=64, storage="bogus", device="cpu")


@pytest.mark.parametrize("method", ["tree", "cholqr2", "cholqr3s"])
def test_fused_tsqr_precision_matches_default(rng, method):
    """fused_tsqr(..., precision=) as the reference takes it: "highest" is
    true FP32 on every route, the default's products, so the same (Q, R)."""
    x = rng.standard_normal((256, 32)).astype(np.float32)
    q0, r0 = lower.fused_tsqr(torch.from_numpy(x), 64, compute_q=True, method=method)
    q1, r1 = lower.fused_tsqr(torch.from_numpy(x), 64, compute_q=True, method=method,
                              precision="highest")
    assert torch.equal(q0, q1) and torch.equal(r0, r1)
    jq, jr = jlower.fused_tsqr(jnp.asarray(x), 64, compute_q=True, method=method,
                               precision=lax.Precision.HIGHEST)
    _assert_r_close(r1.numpy(), np.asarray(jr))
    np.testing.assert_allclose(q1.numpy() @ r1.numpy(), x, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("build", [
    lambda: lower.fused_tsqr(torch.ones((128, 8)), 64, precision="bogus"),
    lambda: lower.fused_tsqr_fn(2, 64, 8, precision="HIGHEST"),
    lambda: lower.fused_cholqr2_fn(precision="fp32"),
    lambda: lower.fused_cholqr3s_fn(precision=""),
], ids=["fused_tsqr", "tree", "cholqr2", "cholqr3s"])
def test_tsqr_rejects_an_invalid_precision(build):
    with pytest.raises(ValueError, match="precision must be one of"):
        build()


@pytest.mark.parametrize("compensated", [False, True])
def test_tsqr_apply_routes(rng, monkeypatch, compensated):
    """The applies' routes: "high" is the bf16x3 product (its plain version
    here) in compensated mode, true FP32 otherwise; "highest" is always
    true FP32. cholqr2 at "high" stays within the JAX package's bars."""
    from numpywren_tpu_torch import config as pconfig
    from numpywren_tpu_torch.ops.gemm3 import matmul3_ref

    monkeypatch.setattr(pconfig, "_default", pconfig.NpwConfig(compensated=compensated))
    x = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
    got = lower._tsqr_matmul(x, w, tb=True, precision="high")
    want = matmul3_ref(x, w, tb=True) if compensated else x @ w.T
    assert torch.equal(got, want)
    assert torch.equal(lower._tsqr_matmul(x, w, tb=True, precision="highest"), x @ w.T)
    q, r = lower.fused_tsqr(x, 64, compute_q=True, method="cholqr2", precision="high")
    _assert_r_close(r.numpy(), np.linalg.qr(x.numpy().astype(np.float64), mode="r"))
    np.testing.assert_allclose(q.numpy().T @ q.numpy(), np.eye(32), atol=5e-4)
