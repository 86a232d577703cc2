"""bf16x3 matmul: fp32-parity GEMM on the bf16 tensor cores.

Counterpart of numpywren_tpu/ops/gemm3.py. Each fp32 operand splits into
bf16 hi + bf16 lo (x = hi + lo keeps ~16 more mantissa bits), and

    a @ b  ~=  hi_a @ hi_b + hi_a @ lo_b + lo_a @ hi_b

sums in fp32 (lo_a @ lo_b is below fp32 epsilon). With `c` the kernel
computes ``c - a @ op(b)`` in its epilogue, the Cholesky trailing update's
subtract, and may write it into `c` in place (``out=c``).

The kernel is ``csrc/gemm3.cu``: a split pass writes each operand's hi and lo
as bf16 planes into a workspace this wrapper allocates, then a wgmma GEMM
(Hopper's warpgroup bf16 MMAs, fp32 accumulate) runs the three products
over the planes.
``matmul3_ref`` is the plain PyTorch version: the same split,
three fp32 ``torch.matmul`` of the upcast halves. A CPU tensor takes it; a
CUDA tensor launches the kernel or raises. On the CPU this is therefore an
exact bf16x3 emulation, where the JAX package's CPU path runs plain fp32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from numpywren_tpu_torch.ops import _build
from numpywren_tpu_torch.ops.common import cdiv, leading_dim, on_cuda
from numpywren_tpu_torch.ops.gemm import _strided

LAUNCHES = 0  # kernel launches in this process (matmul3_ref calls do not count)


def _split(x: torch.Tensor):
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi.float(), lo.float()


def _check(a, b, c, tb):
    if a.dtype != torch.float32 or b.dtype != torch.float32 or (
            c is not None and c.dtype != torch.float32):
        raise TypeError("matmul3 is fp32 only")
    m, k = a.shape
    n = b.shape[0] if tb else b.shape[1]
    kb = b.shape[1] if tb else b.shape[0]
    if k != kb:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} vs {tuple(b.shape)} (tb={tb})")
    if c is not None and tuple(c.shape) != (m, n):
        raise ValueError(f"c is {tuple(c.shape)}, the product is {(m, n)}")
    return m, n, k


def matmul3_ref(a, b, c=None, *, tb=False) -> torch.Tensor:
    """Plain PyTorch version: bf16 split, three fp32 matmuls of the halves."""
    _check(a, b, c, tb)
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b.T if tb else b)
    acc = a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    return c - acc if c is not None else acc


def _lib():
    lib = _build.library()
    if not getattr(lib, "_npw_gemm3_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.npw_gemm3.argtypes = [i, p, ll, p, ll, p, ll, p, ll, i, i, i, p, p]
        lib.npw_gemm3.restype = i
        lib._npw_gemm3_typed = True
    return lib


def matmul3(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None, *,
            tb: bool = False, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a @ op(b) at bf16x3 precision; with `c`, c - a @ op(b) in the same
    kernel. `out` receives the result in place and may be `c` itself."""
    global LAUNCHES
    m, n, k = _check(a, b, c, tb)
    if not on_cuda(a):
        res = matmul3_ref(a, b, c, tb=tb)
        return res if out is None else out.copy_(res)
    for name, t in (("b", b), ("c", c), ("out", out)):
        if t is not None and t.device != a.device:
            raise ValueError(f"{name} on {t.device}, a on {a.device}")
    a, lda = _strided(a)
    b, ldb = _strided(b)
    ldc = 0
    if c is not None:
        c, ldc = _strided(c)
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ldo = leading_dim(out)
    if ldo is None or tuple(out.shape) != (m, n) or out.dtype != torch.float32:
        raise ValueError(f"out must be fp32 ({m}, {n}) with unit column stride")
    ldp = cdiv(k, 8) * 8  # the planes' row length: K padded for 16-byte copies
    planes = torch.empty(2 * (m + n) * ldp, dtype=torch.bfloat16, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().npw_gemm3(int(tb), a.data_ptr(), lda, b.data_ptr(), ldb,
                              c.data_ptr() if c is not None else None, ldc,
                              out.data_ptr(), ldo, m, n, k, planes.data_ptr(), stream)
    LAUNCHES += 1
    _build.check(rc, "matmul3 kernel")
    return out
