"""The port's fused Cholesky on a flat padded tensor
(numpywren_tpu_torch/compiler/lower.py) against the JAX package's, on the
CPU: chol_cols (truncate == 0, column views of one buffer) and chol_flat
(truncate > 0, the recursive lower-only trailing syrk), in the default and
compensated configurations. Tolerance rtol 1e-4, atol 1e-5, as
tests/test_trapezoid.py holds the JAX tiers to each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numpywren_tpu import config
from numpywren_tpu.compiler import lower as jlower
from numpywren_tpu.matrix_init import random_spd
from numpywren_tpu_torch import config as pconfig
from numpywren_tpu_torch.compiler import lower
from numpywren_tpu_torch.ops.common import cdiv
from numpywren_tpu_torch.ops.gemm3 import matmul3_ref
from numpywren_tpu_torch.trapezoid import TrapezoidMatrix, cholesky_trapezoid
from test_torch_trapezoid import count_panel_route

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(params=[False, True], ids=["high", "compensated"])
def compensated(request, monkeypatch):  # each package has its own config: set both
    monkeypatch.setattr(config, "_default", config.NpwConfig(compensated=request.param))
    monkeypatch.setattr(pconfig, "_default", pconfig.NpwConfig(compensated=request.param))
    return request.param


@pytest.mark.parametrize("n,tile,kw", [
    (256, 32, {}),                       # one 256-wide super-panel per 8 tiles
    (384, 32, {}),                       # ragged last column block (128 of 256)
    (256, 32, {"panel_tiles": 2, "inv_panel": False}),  # trsm leaves solve
])
def test_chol_cols_matches_jax(compensated, n, tile, kw):
    a = random_spd(n, seed=n + tile)
    want = np.asarray(jlower.fused_cholesky(jnp.asarray(a), tile, **kw))
    buf = torch.from_numpy(a.copy())
    got = lower.fused_cholesky(buf, tile, **kw)
    assert got.data_ptr() == buf.data_ptr()  # in place: JAX's donation
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ln = got.numpy()
    assert np.linalg.norm(a - ln @ ln.T) / np.linalg.norm(a) < 1e-5


@pytest.mark.parametrize("truncate,leaf_rows", [(3, 4096), (3, 32), (5, 64)])
def test_chol_flat_truncate_matches_jax(compensated, truncate, leaf_rows):
    """Prefix runs: factored panels plus the Schur complement, and the
    untouched upper region, all as JAX leaves them. leaf_rows below the
    trailing size drives _syrk_tril's recursion."""
    n, tile = 256, 32
    a = random_spd(n, seed=31)
    kw = dict(truncate=truncate, leaf_rows=leaf_rows, panel_tiles=2)
    want = np.asarray(jlower.fused_cholesky(jnp.asarray(a), tile, **kw))
    got = lower.fused_cholesky(torch.from_numpy(a.copy()), tile, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sub_matmul_routes(compensated):
    """c - a·bᵀ in place through each route the lowering takes on the CPU."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((48, 32)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    for prec in ("high", "highest"):
        # compensated "high" is the bf16x3 route: its plain version exactly
        want = (matmul3_ref(a, b, c, tb=True) if compensated and prec == "high"
                else c - a @ b.T)
        out = c.clone()
        assert lower._sub_matmul(out, a, b, tb=True, precision=prec, out=out) is out
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert lower._use_compensated(a, "high") is compensated
    assert not lower._use_compensated(a, "highest")
    assert not lower._use_compensated(a.double(), "high")


@pytest.mark.parametrize("n,panel_tiles", [(224, 2), (416, 3)])
def test_chol_cols_panel_route_matches_jax(monkeypatch, n, panel_tiles):
    """Compensated chol_cols on strided views of one buffer: each column
    block's panel packed once, a ragged last column block, the result
    JAX's."""
    monkeypatch.setattr(config, "_default", config.NpwConfig(compensated=True))
    monkeypatch.setattr(pconfig, "_default", pconfig.NpwConfig(compensated=True))
    calls = count_panel_route(monkeypatch)
    tile = 32
    a = random_spd(n, seed=n)
    want = np.asarray(jlower.fused_cholesky(jnp.asarray(a), tile, panel_tiles=panel_tiles))
    got = lower.fused_cholesky(torch.from_numpy(a.copy()), tile, panel_tiles=panel_tiles)
    nb = cdiv(n, panel_tiles * tile)
    assert calls == {"packs": nb - 1, "updates": nb * (nb - 1) // 2}
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _factor(tier, a, precision):
    if tier == "flat":
        return lower.fused_cholesky(torch.from_numpy(a.copy()), 32, panel_tiles=2,
                                    precision=precision)
    return cholesky_trapezoid(TrapezoidMatrix.from_array(a, panel=64, device="cpu"),
                              precision=precision)


@pytest.mark.parametrize("tier", ["flat", "trapezoid"])
def test_panel_route_counts_as_the_per_call_route(monkeypatch, tier):
    """What gemm3.LAUNCHES counts on the card for one compensated
    factorization (matmul3 calls and panel updates) equals the product
    calls of the per-call route, which "highest" still takes (one matmul
    call a product); one pack a panel with updates."""
    def counted(fn, calls):
        def call(*args, **kw):
            calls.append(1)
            return fn(*args, **kw)
        return call

    a = random_spd(352, seed=3)
    per_call, matmul3_calls = [], []
    monkeypatch.setattr(lower, "kernel_matmul", counted(lower.kernel_matmul, per_call))
    _factor(tier, a, "highest")
    monkeypatch.setattr(lower, "matmul3", counted(lower.matmul3, matmul3_calls))
    monkeypatch.setattr(pconfig, "_default", pconfig.NpwConfig(compensated=True))
    calls = count_panel_route(monkeypatch)
    _factor(tier, a, None)
    nb = cdiv(352, 64)
    assert calls["packs"] == nb - 1 and calls["updates"] == nb * (nb - 1) // 2
    assert len(matmul3_calls) + calls["updates"] == len(per_call) > 0
