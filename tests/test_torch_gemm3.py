"""The port's bf16x3 matmul (numpywren_tpu_torch/ops/gemm3.py) against the
JAX Pallas kernel body, on the CPU.

The JAX package's matmul3 runs plain fp32 on the CPU, so the test builds
the pallas_call around its kernel body (gemm3._kernel) and interprets it:
that is the bf16 split and the three products as the TPU runs them. The
port's matmul3_ref (the plain version of the CUDA kernel, csrc/gemm_split.cu
at two planes, which a CPU tensor takes) must agree with it to 1e-6
relative: the same split, the same exact bf16 products, fp32 sums in
another order. gemm3.Panel (one Cholesky panel packed once for all of its
trailing updates) takes the same plain version on the CPU, over row
slices of its panel.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from numpywren_tpu_torch.ops import gemm3

jgemm3 = importlib.import_module("numpywren_tpu.ops.gemm3")

M, K, N = 256, 384, 256
BLK = 128
BODY_BAR = 1e-6
# dropping lo_a·lo_b and rounding lo to bf16 leaves ~2^-16 relative per
# product: 4.4e-6 relative Frobenius error against fp64 at this shape
# (plain fp32: 2.5e-7)
FP64_BAR = 1e-5


def _pallas_body(a, b, c, tb):
    """gemm3.matmul3's pallas_call, built here, interpreted on the CPU."""
    gm, gn, gk = M // BLK, N // BLK, K // BLK
    a_spec = pl.BlockSpec((BLK, BLK), lambda i, j, kk: (i, kk))
    b_spec = pl.BlockSpec((BLK, BLK), (lambda i, j, kk: (j, kk)) if tb else (lambda i, j, kk: (kk, j)))
    io_spec = pl.BlockSpec((BLK, BLK), lambda i, j, kk: (i, j))
    has_c = c is not None
    operands = (a, b, c) if has_c else (a, b)
    return np.asarray(pl.pallas_call(
        jgemm3._kernel(tb, gk, has_c, jnp.float32),
        grid=(gm, gn, gk),
        in_specs=[a_spec, b_spec] + ([io_spec] if has_c else []),
        out_specs=io_spec,
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        scratch_shapes=[pltpu.VMEM((BLK, BLK), jnp.float32)],
        interpret=True,
    )(*map(jnp.asarray, operands)))


def _rel(x, y):
    return float(np.linalg.norm(np.asarray(x, np.float64) - y) / np.linalg.norm(y))


@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("tb", [False, True])
def test_matmul3_ref_matches_pallas_body(rng, tb, with_c):
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((N, K) if tb else (K, N)).astype(np.float32)
    c = rng.standard_normal((M, N)).astype(np.float32) if with_c else None
    want = _pallas_body(a, b, c, tb)
    tc = None if c is None else torch.from_numpy(c)
    for fn in (gemm3.matmul3_ref, gemm3.matmul3):  # the wrapper: plain on the CPU
        got = fn(torch.from_numpy(a), torch.from_numpy(b), tc, tb=tb).numpy()
        assert _rel(got, want) <= BODY_BAR
    # and the bf16x3 bound against the exact product
    prod = a.astype(np.float64) @ (b.T if tb else b).astype(np.float64)
    exact = (c - prod) if with_c else prod
    assert _rel(got, exact) <= FP64_BAR


def test_split_matches_pallas_split(rng):
    x = rng.standard_normal((64, 64)).astype(np.float32) * 1e3
    hi, lo = (np.asarray(v, np.float32) for v in jgemm3._split(jnp.asarray(x)))
    t_hi, t_lo = gemm3._split(torch.from_numpy(x))
    np.testing.assert_array_equal(t_hi.numpy(), hi)
    np.testing.assert_array_equal(t_lo.numpy(), lo)


def test_in_place_and_errors(rng):
    a = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((48, 32)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    want = gemm3.matmul3_ref(a, b, c, tb=True)
    assert gemm3.matmul3(a, b, c, tb=True, out=c) is c
    torch.testing.assert_close(c, want, rtol=0, atol=0)
    with pytest.raises(TypeError, match="fp32"):
        gemm3.matmul3(a.double(), b.double(), tb=True)
    with pytest.raises(ValueError, match="contraction"):
        gemm3.matmul3(a, b)


# (rows, w, off, n): the panel's rows and width, the update's first row and
# column count (a trailing update reads b[off:] and b[off:off + n])
PANEL_CASES = [
    (256, 96, 0, 96),     # the first update: the whole panel against its first block
    (256, 96, 96, 96),    # a later block
    (256, 96, 192, 64),   # the ragged last block
    (300, 70, 17, 130),   # offsets off the tile grid, K off the slice
    (130, 64, 0, 1),      # one column
]


@pytest.mark.parametrize("out_is_c", [False, True])
@pytest.mark.parametrize("rows,w,off,n", PANEL_CASES)
def test_panel_matches_matmul3_ref_on_row_slices(rng, rows, w, off, n, out_is_c):
    b = torch.from_numpy(rng.standard_normal((rows, w)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((rows - off, n)).astype(np.float32))
    want = gemm3.matmul3_ref(b[off:], b[off:off + n], c, tb=True)
    keep = b.clone()
    panel = gemm3.Panel(b)
    got = panel.sub_update(c, off, n, out=c if out_is_c else None)
    assert (got is c) == out_is_c
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(b, keep)  # the panel is read, never written


@pytest.mark.parametrize("off", [0, 256])
def test_panel_matches_pallas_body(rng, off):
    """A trailing update through the panel against JAX's matmul3 body,
    interpreted: rows [off, off + M) of a panel of width K, their first N
    as B."""
    b = rng.standard_normal((off + M, K)).astype(np.float32)
    c = rng.standard_normal((M, N)).astype(np.float32)
    want = _pallas_body(b[off:], b[off:off + N], c, True)
    got = gemm3.Panel(torch.from_numpy(b)).sub_update(torch.from_numpy(c), off, N).numpy()
    assert _rel(got, want) <= BODY_BAR


@pytest.mark.parametrize("what", ["fp64 panel", "1-D panel", "rows past the panel",
                                  "negative offset", "c of another shape", "fp64 c"])
def test_panel_errors(rng, what):
    b = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((48, 16)).astype(np.float32))
    cases = {
        "fp64 panel": (TypeError, lambda: gemm3.Panel(b.double())),
        "1-D panel": (TypeError, lambda: gemm3.Panel(b[0])),
        "rows past the panel": (ValueError, lambda: gemm3.Panel(b).sub_update(c, 56, 16)),
        "negative offset": (ValueError, lambda: gemm3.Panel(b).sub_update(c, -1, 16)),
        "c of another shape": (ValueError, lambda: gemm3.Panel(b).sub_update(c, 0, 16)),
        "fp64 c": (TypeError, lambda: gemm3.Panel(b).sub_update(c.double(), 16, 16)),
    }
    err, call = cases[what]
    with pytest.raises(err):
        call()
