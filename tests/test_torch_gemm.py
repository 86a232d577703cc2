"""The port's matmul family (numpywren_tpu_torch/ops/gemm.py) against the JAX
Pallas kernel run in interpret mode, on the CPU.

On the CPU the port's wrapper takes matmul_ref, the plain fp32 version
(JAX on the CPU computes plain fp32 too). The CUDA kernel
csrc/gemm_split.cu runs only on the card, where chip_smoke.py holds it
against matmul_ref and against _matmul_split_ref; here _pack_ref and
_matmul_split_ref, its own arithmetic (bf16 planes, the pair schedule,
per-slice sums added in fp32), are checked against JAX, fp64 and
matmul3_ref. fp32 products and sums in different orders: rtol 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numpywren_tpu_torch.ops import gemm3

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


# ---------------------------------------------------------------------------
# The split kernel's plain versions: _pack_ref, _matmul_split_ref
# ---------------------------------------------------------------------------

def test_pack_ref_planes_sum_to_x_over_a_wide_exponent_range(rng):
    """Three bf16 planes, hi + mid + lo = x exactly (fp64 sum) for fp32 values
    of either sign with |x| from 2^-100 to 2^100 (every plane a normal bf16:
    below |x| ~ 2^-110, lo falls under bf16's smallest normal and loses
    bits); each plane is a rounding of what remains."""
    mag = rng.uniform(1.0, 2.0, (24, 100)) * 2.0 ** rng.integers(-100, 100, (24, 100))
    x = torch.from_numpy((rng.choice([-1.0, 1.0], (24, 100)) * mag).astype(np.float32))
    p = gemm._pack_ref(x, planes=3)
    assert p.dtype == torch.bfloat16 and p.shape == (3, 24, 128)
    torch.testing.assert_close(p.double().sum(0)[:, :100], x.double(), rtol=0, atol=0)
    assert torch.equal(p[0, :, :100], x.to(torch.bfloat16))
    assert torch.equal(p[1, :, :100], (x - p[0, :, :100].float()).to(torch.bfloat16))


@pytest.mark.parametrize("k,kp", [(0, 64), (1, 64), (64, 64), (100, 128), (1024, 1024)])
def test_pack_ref_pads_k_with_zeros(rng, k, kp):
    """K is padded to whole slices of gemm.SLICE (at least one), with zeros."""
    x = torch.from_numpy(rng.standard_normal((5, k)).astype(np.float32))
    p = gemm._pack_ref(x, planes=3)
    assert p.shape == (3, 5, kp) and kp % gemm.SLICE == 0
    assert not p[:, :, k:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans", [False, True])
def test_pack_ref_folds_the_transpose(rng, trans, dtype):
    """op(x) lands rows x K, K-major, whatever the layout it came in; bf16 is
    one plane, a copy."""
    rows, k = 7, 40
    x = torch.from_numpy(rng.standard_normal((k, rows) if trans else (rows, k)).astype(
        np.float32)).to(dtype)
    planes = gemm._planes_of(dtype)
    p = gemm._pack_ref(x, trans=trans, planes=planes)
    op = x.T if trans else x
    assert p.shape == (planes, rows, 64)
    torch.testing.assert_close(p.double().sum(0)[:, :k], op.double(), rtol=0, atol=0)
    if dtype == torch.bfloat16:
        assert planes == 1 and torch.equal(p[0, :, :k], op)


@pytest.mark.parametrize("planes,n_pairs", [(1, 1), (2, 3), (3, 6)])
def test_pair_schedule(planes, n_pairs):
    """Pairs (i, j) with i + j < planes, each once, smallest products first
    and hh last."""
    pairs = gemm._pairs(planes)
    assert len(pairs) == n_pairs == len(set(pairs))
    assert all(i + j < planes for i, j in pairs)
    assert [i + j for i, j in pairs] == sorted((i + j for i, j in pairs), reverse=True)
    assert pairs[-1] == (0, 0)


@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("tb", [False, True])
@pytest.mark.parametrize("ta", [False, True])
def test_matmul_split_ref_matches_pallas(rng, ta, tb, with_c):
    """The kernel's arithmetic (bf16x6) against the JAX kernel at HIGHEST,
    which on the CPU is a plain fp32 product: relative Frobenius error 1e-5,
    and no farther from the fp64 product than JAX's own result. (Element by
    element the two differ by up to ~3e-5 absolute on outputs of ~10 at
    K = 128: JAX's sequential fp32 sums carry 4x the split's error against
    fp64, and the split sums by 64-deep slices.)"""
    a, b, c = _operands(rng, ta, tb, with_c)
    ab = dict(alpha=0.5, beta=-2.0) if with_c else {}
    want = np.asarray(jgemm.matmul(jnp.asarray(a), jnp.asarray(b),
                                   None if c is None else jnp.asarray(c),
                                   ta=ta, tb=tb, **ab, **PALLAS))
    tc = None if c is None else torch.from_numpy(c)
    got = gemm._matmul_split_ref(torch.from_numpy(a), torch.from_numpy(b), tc, ta=ta, tb=tb,
                                 **ab).numpy()
    assert np.linalg.norm(got - want) <= RTOL * np.linalg.norm(want)
    exact = (a.T if ta else a).astype(np.float64) @ (b.T if tb else b).astype(np.float64)
    exact = exact * ab.get("alpha", 1.0) + (ab["beta"] * c if with_c else 0.0)
    assert np.linalg.norm(got - exact) <= np.linalg.norm(want - exact)


@pytest.mark.parametrize("k", [1024, 8192])
def test_matmul_split_ref_error_against_fp64(rng, k):
    """bf16x6 with per-slice fp32 sums is as accurate as the fp32 product:
    its error against fp64 within 2x of matmul_ref's."""
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((48, k)).astype(np.float32))
    want = a.double() @ b.double().T

    def err(x):
        return float(torch.linalg.norm(x.double() - want) / torch.linalg.norm(want))

    split, plain = err(gemm._matmul_split_ref(a, b, tb=True)), err(gemm.matmul_ref(a, b, tb=True))
    assert split <= 2 * plain, (split, plain)
    assert split < 1e-6


def test_matmul_split_ref_two_planes_is_matmul3(rng):
    """P = 2 is matmul3's bf16x3 (hh + hl + lh): the same products, summed
    by slices."""
    a = torch.from_numpy(rng.standard_normal((M, 300)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((N, 300)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32))
    got = gemm._matmul_split_ref(a, b, c, tb=True, alpha=-1.0, beta=1.0, planes=2)
    torch.testing.assert_close(got, gemm3.matmul3_ref(a, b, c, tb=True), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 64, 100, 130])
@pytest.mark.parametrize("trans", [False, True])
def test_pack_ref_two_planes_is_matmul3_split(rng, trans, k):
    """P = 2, matmul3's route: plane 0 is exactly gemm3._split's hi and
    plane 1 its lo, of op(x), K zero-padded to whole slices."""
    rows = 48
    x = torch.from_numpy((rng.standard_normal((k, rows) if trans else (rows, k)) * 1e3).astype(
        np.float32))
    p = gemm._pack_ref(x, trans=trans, planes=2)
    hi, lo = gemm3._split(x.T if trans else x)
    assert p.shape == (2, rows, gemm._depth(k))
    assert torch.equal(p[0, :, :k].float(), hi) and torch.equal(p[1, :, :k].float(), lo)
    assert not p[:, :, k:].any()


def test_matmul_split_ref_bf16_is_one_plane(rng):
    """bf16 operands: one plane, one product, exact bf16 products summed in
    fp32, as matmul_ref computes."""
    a, b, _ = _operands(rng, False, True, False)
    ta_, tb_ = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = gemm._matmul_split_ref(ta_, tb_, tb=True, out_dtype=torch.float32)
    assert gemm._planes_of(ta_.dtype) == 1
    torch.testing.assert_close(got, gemm.matmul_ref(ta_, tb_, tb=True, out_dtype=torch.float32),
                               rtol=RTOL, atol=ATOL)
