"""The matmul family: the hot op of every blocked algorithm.

    out = alpha * op(A) @ op(B) + beta * C

Counterpart of numpywren_tpu/ops/gemm.py. The TPU kernel (Pallas, on the
MXU) becomes the hand-written CUDA kernel ``csrc/gemm.cu``: FP32 FFMA with
the transposes folded into index arithmetic and the epilogue fused, so the
Cholesky trailing update ``S - L Lᵀ`` is one launch that writes ``S`` in
place (``out=`` may be ``c``).

Routing mirrors the JAX package: precision ``"high"`` is the library GEMM
(``torch.matmul`` in true FP32, TF32 off, as JAX hands HIGH to XLA's dot);
``"highest"`` and bf16 ``"default"`` launch the kernel. A CPU tensor takes
``matmul_ref``, the plain PyTorch version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from numpywren_tpu_torch.ops import _build
from numpywren_tpu_torch.ops.common import (
    check_precision,
    default_precision,
    leading_dim,
    on_cuda,
)

LAUNCHES = 0  # kernel launches in this process (matmul_ref calls do not count)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _shape(a, b, ta, tb):
    m = a.shape[1] if ta else a.shape[0]
    ka = a.shape[0] if ta else a.shape[1]
    kb = b.shape[1] if tb else b.shape[0]
    n = b.shape[0] if tb else b.shape[1]
    if ka != kb:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} (ta={ta}) vs "
                         f"{tuple(b.shape)} (tb={tb})")
    return m, n, ka


def matmul_ref(a, b, c=None, *, ta=False, tb=False, alpha=1.0, beta=1.0,
               out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: fp32 product and epilogue, cast to out_dtype."""
    _shape(a, b, ta, tb)
    lhs = a.T if ta else a
    rhs = b.T if tb else b
    acc = torch.matmul(lhs.float(), rhs.float()) * alpha
    if c is not None:
        acc = acc + beta * c.float()
    return acc.to(out_dtype or a.dtype)


def _lib():
    lib = _build.library()
    if not getattr(lib, "_npw_gemm_typed", False):
        p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.npw_gemm.argtypes = [i, i, i, i, p, ll, p, ll, p, ll, p, ll, i, i, i, f, f, p]
        lib.npw_gemm.restype = i
        lib._npw_gemm_typed = True
    return lib


def _strided(t: torch.Tensor):
    """(tensor, leading dimension), copying only a layout the kernel can't read."""
    ld = leading_dim(t)
    if ld is None:
        t = t.contiguous()
        ld = leading_dim(t)
    return t, ld


def _launch(a, b, c, out, ta, tb, alpha, beta, m, n, k):
    global LAUNCHES
    if a.dtype not in _KERNEL_DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul kernel takes fp32 or bf16 A and B of one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    if out.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"matmul kernel writes fp32 or bf16, not {out.dtype}")
    dev = a.device
    for name, t in (("b", b), ("c", c), ("out", out)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, a on {dev}")
    a, lda = _strided(a)
    b, ldb = _strided(b)
    ldc = 0
    if c is not None:
        c, ldc = _strided(c)
    ldo = leading_dim(out)
    if ldo is None or tuple(out.shape) != (m, n):
        raise ValueError(f"out must be ({m}, {n}) with unit column stride, got "
                         f"{tuple(out.shape)} strides {out.stride()}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().npw_gemm(
            int(a.dtype == torch.bfloat16), int(out.dtype == torch.bfloat16),
            int(ta), int(tb), a.data_ptr(), lda, b.data_ptr(), ldb,
            c.data_ptr() if c is not None else None, ldc, out.data_ptr(), ldo,
            m, n, k, float(alpha), float(beta), stream)
    LAUNCHES += 1
    _build.check(rc, "matmul kernel")
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None, *,
           ta: bool = False, tb: bool = False, alpha: float = 1.0, beta: float = 1.0,
           out_dtype=None, precision: Optional[str] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """alpha * op(a) @ op(b) + beta * c (see module docstring).

    `out` receives the result in place and may be `c` itself (the trailing
    update writes its column buffer directly). Any M, N and K; operands may
    be row-strided views (unit column stride), other layouts are copied."""
    m, n, k = _shape(a, b, ta, tb)
    out_dtype = out_dtype or (out.dtype if out is not None else a.dtype)
    precision = check_precision(precision or default_precision(a.dtype))
    if precision == "high" or not on_cuda(a):
        res = matmul_ref(a, b, c, ta=ta, tb=tb, alpha=alpha, beta=beta, out_dtype=out_dtype)
        return res if out is None else out.copy_(res)
    if c is not None and c.dtype != out_dtype:
        # the kernel reads C in the output's dtype: sum in fp32, cast after
        res = matmul(a, b, c.float(), ta=ta, tb=tb, alpha=alpha, beta=beta,
                     out_dtype=torch.float32, precision=precision)
        return res.to(out_dtype) if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    return _launch(a, b, c, out, ta, tb, alpha, beta, m, n, k)


# ---------------------------------------------------------------------------
# The kernel-registry entry points (signatures match kernels.py references)
# ---------------------------------------------------------------------------

def gemm(a, b, **kw):
    return matmul(a, b, **kw)


def gemm_nt(a, b, **kw):
    return matmul(a, b, tb=True, **kw)


def gemm_tn(a, b, **kw):
    return matmul(a, b, ta=True, **kw)


def gemm_acc(c, a, b, **kw):
    """c + a @ b (accumulating statement of blocked GEMM)."""
    return matmul(a, b, c, **kw)


def syrk_update(s, x, y, **kw):
    """s - x @ yᵀ, the Cholesky trailing update, one fused kernel."""
    return matmul(x, y, s, tb=True, alpha=-1.0, beta=1.0, **kw)
