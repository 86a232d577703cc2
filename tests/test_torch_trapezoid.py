"""The port's trapezoid tier and its in-place factorization
(numpywren_tpu_torch/trapezoid.py) against the JAX package's, on the CPU.

Configurations: the default ("high": torch.matmul / XLA's dot), compensated
(NpwConfig.compensated: the port runs matmul3_ref, the exact bf16x3
emulation, where JAX on the CPU runs plain fp32) and "highest" (the port's
matmul_ref; JAX's plain HIGHEST dot). Tolerance rtol 1e-4, atol 1e-5 on the
factor, as tests/test_trapezoid.py holds the JAX tier to, and residual
||A - L Lᵀ|| / ||A|| < 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from numpywren_tpu import config
from numpywren_tpu import trapezoid as jtrap
from numpywren_tpu.matrix_init import random_spd
from numpywren_tpu_torch import config as pconfig
from numpywren_tpu_torch import convert
from numpywren_tpu_torch.ops import gemm3
from numpywren_tpu_torch.ops.common import cdiv
from numpywren_tpu_torch.trapezoid import TrapezoidMatrix, cholesky_trapezoid

RTOL, ATOL = 1e-4, 1e-5

CONFIGS = {  # name -> (compensated, port precision, JAX precision)
    "high": (False, None, None),
    "compensated": (True, None, None),
    "highest": (False, "highest", jax.lax.Precision.HIGHEST),
}


@pytest.fixture
def set_config(monkeypatch):
    def apply(compensated):  # each package has its own config: set both
        monkeypatch.setattr(config, "_default", config.NpwConfig(compensated=compensated))
        monkeypatch.setattr(pconfig, "_default", pconfig.NpwConfig(compensated=compensated))
    return apply


def _resid(a, l):
    return np.linalg.norm(a - l @ l.T) / np.linalg.norm(a)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("n,panel", [(256, 64), (160, 64), (192, 192), (96, 128)])
def test_cholesky_trapezoid_matches_jax(set_config, n, panel, cfg):
    compensated, prec, jprec = CONFIGS[cfg]
    set_config(compensated)
    a = random_spd(n, seed=n)
    want = jtrap.cholesky_trapezoid(jtrap.TrapezoidMatrix.from_array(a, panel=panel),
                                    precision=jprec).numpy()
    t = TrapezoidMatrix.from_array(a, panel=panel, device="cpu")
    got = cholesky_trapezoid(t, precision=prec).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _resid(a, got) < 1e-5


def count_panel_route(monkeypatch):
    """Count the gemm3.Panel packs and updates the run makes."""
    calls = {"packs": 0, "updates": 0}
    init, sub_update = gemm3.Panel.__init__, gemm3.Panel.sub_update

    def counted_init(self, b):
        calls["packs"] += 1
        init(self, b)

    def counted_sub_update(self, *args, **kw):
        calls["updates"] += 1
        return sub_update(self, *args, **kw)

    monkeypatch.setattr(gemm3.Panel, "__init__", counted_init)
    monkeypatch.setattr(gemm3.Panel, "sub_update", counted_sub_update)
    return calls


@pytest.mark.parametrize("n,panel", [(352, 64), (200, 64)])
def test_compensated_panel_route_matches_jax(set_config, monkeypatch, n, panel):
    """Compensated, each panel is packed once and every trailing update,
    the ragged last panel's included, runs through it: the factor is
    JAX's."""
    set_config(True)
    calls = count_panel_route(monkeypatch)
    a = random_spd(n, seed=n + 1)
    want = jtrap.cholesky_trapezoid(jtrap.TrapezoidMatrix.from_array(a, panel=panel)).numpy()
    got = cholesky_trapezoid(TrapezoidMatrix.from_array(a, panel=panel, device="cpu")).numpy()
    nb = cdiv(n, panel)
    assert calls == {"packs": nb - 1, "updates": nb * (nb - 1) // 2}
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _resid(a, got) < 1e-5


@pytest.mark.parametrize("cfg", ["high", "compensated"])
def test_stop_panels_schur_complement_matches_jax(set_config, cfg):
    """A prefix run leaves the factored panels and the updated Schur
    complement in the buffers: the whole state matches JAX's."""
    set_config(CONFIGS[cfg][0])
    n, panel, stop = 256, 64, 2
    a = random_spd(n, seed=21)
    want = jtrap.cholesky_trapezoid(jtrap.TrapezoidMatrix.from_array(a, panel=panel),
                                    stop_panels=stop)
    got = cholesky_trapezoid(TrapezoidMatrix.from_array(a, panel=panel, device="cpu"),
                             stop_panels=stop)
    for gc, wc in zip(got.cols, want.cols):
        np.testing.assert_allclose(np.tril(gc.numpy()), np.tril(np.asarray(wc)),
                                   rtol=RTOL, atol=ATOL)
    # trailing panels: A22 - L21 L21ᵀ
    n_done = stop * panel
    l21 = got.numpy()[n_done:, :n_done]
    schur = a[n_done:, n_done:] - l21 @ l21.T
    np.testing.assert_allclose(np.tril(got.numpy()[n_done:, n_done:]), np.tril(schur),
                               rtol=RTOL, atol=1e-4)


def test_stale_upper_in_diagonal_blocks_is_ignored():
    """The diagonal blocks' strict upper is dead storage: garbage there
    changes nothing, in either package (the potrf reads the lower
    triangle, symmetrize_input=False in JAX)."""
    n, panel = 192, 64
    a = random_spd(n, seed=22)
    clean = jtrap.TrapezoidMatrix.from_array(a, panel=panel)
    dirty_cols = []
    for c in clean.cols:
        c = np.array(c)
        w = c.shape[1]
        c[:w][np.triu_indices(w, 1)] = 7.0
        dirty_cols.append(c)
    dirty = jtrap.TrapezoidMatrix(dirty_cols, n, panel)
    got_dirty = cholesky_trapezoid(convert.from_reference(dirty, device="cpu")).numpy()
    got_clean = cholesky_trapezoid(convert.from_reference(clean, device="cpu")).numpy()
    want = jtrap.cholesky_trapezoid(dirty).numpy()  # consumes `dirty`: last
    np.testing.assert_array_equal(got_dirty, got_clean)
    np.testing.assert_allclose(got_dirty, want, rtol=RTOL, atol=ATOL)


def test_input_is_consumed():
    a = random_spd(128, seed=4)
    t = TrapezoidMatrix.from_array(a, panel=64, device="cpu")
    l = cholesky_trapezoid(t)
    assert all(c is None for c in t.cols)  # the buffers now belong to l
    assert l.cols[0] is not None
    with pytest.raises(ValueError, match="consumed"):
        cholesky_trapezoid(t)


def test_builders_match_jax():
    """from_array (padded), from_block_fn and nbytes agree with JAX's."""
    n, panel = 200, 64
    a = random_spd(n, seed=6)
    want = jtrap.TrapezoidMatrix.from_array(a, panel=panel)
    t = TrapezoidMatrix.from_array(a, panel=panel, device="cpu")
    np.testing.assert_array_equal(t.numpy(), want.numpy())
    assert t.nbytes == want.nbytes
    for tc, wc in zip(t.cols, want.cols):  # identity on the padded diagonal too
        np.testing.assert_array_equal(tc.numpy(), np.asarray(wc))
    b = random_spd(192, seed=7)
    t2 = TrapezoidMatrix.from_block_fn(
        lambda i, c: b[i * panel:(i + 1) * panel, c * panel:(c + 1) * panel], 192,
        panel=panel, device="cpu")
    np.testing.assert_array_equal(t2.numpy(), np.tril(b))


def test_non_spd_raises():
    a = random_spd(128, seed=8)
    a[100, 100] = -50.0
    with pytest.raises(torch.linalg.LinAlgError, match="panel 1"):
        cholesky_trapezoid(TrapezoidMatrix.from_array(a, panel=64, device="cpu"))
