"""The port's matmul family (numpywren_tpu_torch/ops/gemm.py) against the JAX
Pallas kernel run in interpret mode, on the CPU.

On the CPU the port's wrapper takes matmul_ref, the plain PyTorch version
of the CUDA kernel csrc/gemm.cu (which runs only on the card: chip_smoke.py
holds it against matmul_ref there). Both sides compute fp32 products and
fp32 sums in different orders: rtol 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the module: the package exports its function `gemm` under the same name
gemm = importlib.import_module("numpywren_tpu_torch.ops.gemm")

# the module: numpywren_tpu.ops re-exports a function of the same name
jgemm = importlib.import_module("numpywren_tpu.ops.gemm")

M, N, K = 256, 384, 128
RTOL, ATOL = 1e-5, 1e-5
PALLAS = dict(precision=jax.lax.Precision.HIGHEST, interpret=True, bm=128, bn=128, bk=128)


def _operands(rng, ta, tb, with_c, dtype=np.float32):
    a = rng.standard_normal((K, M) if ta else (M, K)).astype(dtype)
    b = rng.standard_normal((N, K) if tb else (K, N)).astype(dtype)
    c = rng.standard_normal((M, N)).astype(np.float32) if with_c else None
    return a, b, c


@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("tb", [False, True])
@pytest.mark.parametrize("ta", [False, True])
def test_matmul_ref_matches_pallas(rng, ta, tb, with_c):
    a, b, c = _operands(rng, ta, tb, with_c)
    ab = dict(alpha=0.5, beta=-2.0) if with_c else {}
    want = np.asarray(jgemm.matmul(jnp.asarray(a), jnp.asarray(b),
                                   None if c is None else jnp.asarray(c),
                                   ta=ta, tb=tb, **ab, **PALLAS))
    tc = None if c is None else torch.from_numpy(c)
    got = gemm.matmul_ref(torch.from_numpy(a), torch.from_numpy(b), tc, ta=ta, tb=tb, **ab)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the public wrapper takes the plain version for a CPU tensor
    got = gemm.matmul(torch.from_numpy(a), torch.from_numpy(b), tc, ta=ta, tb=tb,
                      precision="highest", **ab)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["gemm", "gemm_nt", "gemm_tn", "gemm_acc", "syrk_update"])
def test_registry_entry_points(rng, name):
    """Each registry name against its JAX counterpart, same arguments."""
    x = rng.standard_normal((M, K)).astype(np.float32)
    y = rng.standard_normal((N, K)).astype(np.float32)
    s = rng.standard_normal((M, N)).astype(np.float32)
    args = {
        "gemm": (x, y.T.copy()),
        "gemm_nt": (x, y),
        "gemm_tn": (x.T.copy(), y.T.copy()),
        "gemm_acc": (s, x, y.T.copy()),
        "syrk_update": (s, x, y),
    }[name]
    want = np.asarray(getattr(jgemm, name)(*map(jnp.asarray, args), **PALLAS))
    got = getattr(gemm, name)(*map(torch.from_numpy, args), precision="highest")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_bf16_inputs_accumulate_in_fp32(rng):
    """bf16 in, fp32 sums and out (the "default" precision's kernel route):
    bf16 products are exact in fp32, so only the summation order differs."""
    a, b, _ = _operands(rng, False, True, False)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(jgemm.matmul(ja, jb, tb=True, out_dtype=jnp.float32,
                                   precision=jax.lax.Precision.DEFAULT, interpret=True,
                                   bm=128, bn=128, bk=128))
    ta_, tb_ = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16) for x in (ja, jb))
    got = gemm.matmul(ta_, tb_, tb=True, out_dtype=torch.float32, precision="default")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_out_in_place_on_strided_views(rng):
    """The trailing update's form: column slices of one buffer (row-strided
    views) as operands, and the result written into c itself."""
    buf = torch.from_numpy(rng.standard_normal((M, 3 * K)).astype(np.float32))
    a, b = buf[:, :K], buf[:N // 3, K:2 * K]
    c = buf[:, 2 * K:2 * K + N // 3]
    want, a0, b0 = c - a @ b.T, a.clone(), b.clone()
    out = gemm.syrk_update(c, a, b, precision="highest", out=c)
    assert out.data_ptr() == c.data_ptr()
    torch.testing.assert_close(buf[:, 2 * K:2 * K + N // 3], want, rtol=RTOL, atol=ATOL)
    assert torch.equal(a, a0) and torch.equal(b, b0)  # operands untouched


def test_shape_and_precision_errors():
    a, b = torch.zeros(4, 3), torch.zeros(5, 4)
    with pytest.raises(ValueError, match="contraction mismatch"):
        gemm.matmul(a, b)
    with pytest.raises(ValueError, match="precision"):
        gemm.matmul(a, b[:, :3], tb=True, precision="HIGH")
