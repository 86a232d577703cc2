"""The plain versions of the port's blocked-Householder QR kernel
(numpywren_tpu_torch/ops/pallas_factor.py: qr_ref, reached through
qr_pallas on a CPU tensor, and _qr_rowsplit_ref, the kernel's row-split
arithmetic order) against the JAX package's qr_pallas run in interpret
mode, on the CPU, from the same numpy inputs; at the larger shapes the
row split against qr_ref; the envelope routing and the NPW_PALLAS_QR hook
of ops.qr_leaf.

Tolerances: both sides take LAPACK geqrf signs, so Q and R agree
elementwise (rtol 1e-4, atol 1e-5·max|x|: fp32 sums in another order). The
zero-column and κ = 1e7 cases are held, as tests/test_pallas_factor.py
holds them, by orthogonality and reconstruction: at κ = 1e7 Q's last
columns are determined only to eps·κ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numpywren_tpu import ops as jops
from numpywren_tpu.ops import pallas_factor as jpf
from numpywren_tpu_torch import ops
from numpywren_tpu_torch.ops import pallas_factor as pf


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(128, 128), (256, 128), (512, 128)])
def test_qr_ref_matches_jax(shape, rng):
    a = rng.standard_normal(shape).astype(np.float32)
    jq, jr = jpf.qr_pallas(jnp.asarray(a), interpret=True)
    q, r = pf.qr_pallas(torch.from_numpy(a))
    _close(q.numpy(), np.asarray(jq))
    _close(r.numpy(), np.asarray(jr))
    assert torch.equal(torch.triu(r), r)  # exactly upper triangular
    np.testing.assert_allclose(q.numpy().T @ q.numpy(), np.eye(shape[1]), atol=2e-5)
    qp, rp = pf.qr_ref(torch.from_numpy(a))
    assert torch.equal(q, qp) and torch.equal(r, rp)  # the CPU route is the plain version


def test_qr_ref_zero_column(rng):
    """A zero column (tau = 1, v = 0) leaves the compact-WY T finite."""
    a = rng.standard_normal((256, 128)).astype(np.float32)
    a[:, 5] = 0.0
    q, r = (t.numpy() for t in pf.qr_pallas(torch.from_numpy(a)))
    assert np.isfinite(q).all() and np.isfinite(r).all()
    np.testing.assert_allclose(q @ r, a, atol=2e-5 * np.abs(a).max() * 128 ** 0.5)
    np.testing.assert_allclose(q.T @ q, np.eye(128), atol=2e-5)


def test_qr_ref_ill_conditioned(rng):
    """Householder grade at κ = 1e7, where every CholeskyQR variant fails."""
    m, n = 512, 128
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = ((u * np.logspace(0, -7, n)) @ v.T).astype(np.float32)
    q, r = (t.numpy() for t in pf.qr_pallas(torch.from_numpy(a)))
    np.testing.assert_allclose(q.T @ q, np.eye(n), atol=5e-5)
    np.testing.assert_allclose(q @ r, a, atol=1e-5 * np.abs(a).max())


@pytest.mark.parametrize("shape,dtype", [((100, 60), np.float32),   # not 128-aligned
                                         ((128, 256), np.float32),  # wide
                                         ((128, 128), np.float64)])  # not fp32
def test_qr_off_envelope_routes_to_the_library(shape, dtype, rng):
    a = rng.standard_normal(shape).astype(dtype)
    before = dict(pf.LAUNCHES)
    q, r = pf.qr_pallas(torch.from_numpy(a))
    assert pf.LAUNCHES == before
    lq, lr = torch.linalg.qr(torch.from_numpy(a), mode="reduced")
    assert torch.equal(q, lq) and torch.equal(r, lr)


@pytest.mark.parametrize("flag", ["0", "1"])
def test_qr_leaf_hook_matches_jax(flag, rng, monkeypatch):
    """ops.qr_leaf reads NPW_PALLAS_QR at each call, in both packages: "1"
    takes the kernel's route (qr_ref on the CPU, the interpreted Pallas
    kernel in JAX), "0" the library."""
    monkeypatch.setenv("NPW_PALLAS_QR", flag)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    q, r = ops.qr_leaf(torch.from_numpy(a))
    jq, jr = jops.qr_leaf(jnp.asarray(a))
    _close(q.numpy(), np.asarray(jq))
    _close(r.numpy(), np.asarray(jr))
    want = pf.qr_ref if flag == "1" else (lambda x: torch.linalg.qr(x, mode="reduced"))
    wq, wr = want(torch.from_numpy(a))
    assert torch.equal(q, wq) and torch.equal(r, wr)


def _rowsplit(a):
    m = a.shape[0]
    return pf._qr_rowsplit_ref(torch.from_numpy(a), pf._qr_parts(m))


@pytest.mark.parametrize("shape", [(128, 128), (256, 128), (512, 128)])
def test_qr_rowsplit_ref_matches_jax(shape, rng):
    """The kernel's order (P = 4, 8, 16 row blocks here) against the
    interpreted Pallas kernel, at test_qr_ref_matches_jax's shapes."""
    a = rng.standard_normal(shape).astype(np.float32)
    jq, jr = jpf.qr_pallas(jnp.asarray(a), interpret=True)
    q, r = _rowsplit(a)
    _close(q.numpy(), np.asarray(jq))
    _close(r.numpy(), np.asarray(jr))
    assert torch.equal(torch.triu(r), r)
    np.testing.assert_allclose(q.numpy().T @ q.numpy(), np.eye(shape[1]), atol=2e-5)


@pytest.mark.parametrize("shape", [(512, 512), (1024, 256), (2048, 128)])
def test_qr_rowsplit_ref_matches_qr_ref(shape, rng):
    """Several panels (trailing updates, a rebuild of four steps) and row
    blocks of 32 to 128 rows, against the plain blocked version."""
    a = rng.standard_normal(shape).astype(np.float32)
    q, r = _rowsplit(a)
    qp, rp = pf.qr_ref(torch.from_numpy(a))
    _close(q.numpy(), qp.numpy())
    _close(r.numpy(), rp.numpy())
    assert torch.equal(torch.triu(r), r)
    np.testing.assert_allclose(q.numpy().T @ q.numpy(), np.eye(shape[1]), atol=2e-5)


def test_qr_rowsplit_ref_zero_column_and_kappa(rng):
    """A zero column (tau = 1, v = 0: the fused dot product takes the
    zero-column branch) and kappa = 1e7, held as the qr_ref tests hold them."""
    a = rng.standard_normal((512, 128)).astype(np.float32)
    a[:, 5] = 0.0
    q, r = (t.numpy() for t in _rowsplit(a))
    assert np.isfinite(q).all() and np.isfinite(r).all()
    np.testing.assert_allclose(q @ r, a, atol=2e-5 * np.abs(a).max() * 128 ** 0.5)
    np.testing.assert_allclose(q.T @ q, np.eye(128), atol=2e-5)
    u, _ = np.linalg.qr(rng.standard_normal((512, 128)))
    v, _ = np.linalg.qr(rng.standard_normal((128, 128)))
    a = ((u * np.logspace(0, -7, 128)) @ v.T).astype(np.float32)
    q, r = (t.numpy() for t in _rowsplit(a))
    np.testing.assert_allclose(q.T @ q, np.eye(128), atol=5e-5)
    np.testing.assert_allclose(q @ r, a, atol=1e-5 * np.abs(a).max())


def test_qr_parts():
    """P = min(16, m / 32): every envelope shape gives 32 <= m / P <= 128
    rows a CTA and (m / P) n <= 2^14 floats of its rows in shared memory."""
    for m in range(128, 2049, 128):
        for n in range(128, min(m, 512) + 1, 128):
            if not pf._qr_supported(m, n, torch.float32):
                continue
            p = pf._qr_parts(m)
            assert m % p == 0 and 32 <= m // p <= 128 and (m // p) * n <= 1 << 14
