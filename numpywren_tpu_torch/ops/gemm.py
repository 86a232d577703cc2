"""The matmul family: the hot op of every blocked algorithm.

    out = alpha * op(A) @ op(B) + beta * C

Counterpart of numpywren_tpu/ops/gemm.py. The TPU kernel (Pallas, on the
MXU) computes HIGHEST as a bf16x6 split product, and so does its Hopper
counterpart ``csrc/gemm_split.cu``: a pack pass writes each operand as bf16
planes (three for fp32: hi, mid, lo; one for bf16), K-major with the
transposes folded in, then a TMA-fed wgmma mainloop sums the plane pairs
(i, j) with i + j < P (six products for fp32, one for bf16) with the
epilogue fused, so the Cholesky trailing update ``S - L Lᵀ`` writes ``S`` in
place (``out=`` may be ``c``). The same two passes at P = 2 (hi, lo: three
products) are ``ops/gemm3.py``'s matmul3; `_split_launch` runs them for
both wrappers, each of which keeps its own launch counters.

Routing mirrors the JAX package: precision ``"high"`` is the library GEMM
(``torch.matmul`` in true FP32, TF32 off, as JAX hands HIGH to XLA's dot);
``"highest"`` and bf16 ``"default"`` launch the kernel. A CPU tensor takes
``matmul_ref``, the plain PyTorch version in fp32 (as JAX on the CPU
computes); a CUDA tensor launches the kernel or raises. ``_pack_ref`` and
``_matmul_split_ref`` repeat the kernel's own arithmetic (planes, pair
schedule, per-slice sums added in fp32) for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from numpywren_tpu_torch.ops import _build
from numpywren_tpu_torch.ops.common import (
    cdiv,
    check_precision,
    default_precision,
    leading_dim,
    on_cuda,
)

LAUNCHES = 0  # matmul kernel calls in this process (matmul_ref calls do not count)
DEVICE_LAUNCHES = 0  # the device launches of those calls: pack A, pack B, mainloop

SLICE = 64  # the mainloop's slice depth (csrc/gemm_split.cu BK); planes pad K to it

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


def _planes_of(dtype) -> int:
    """Planes of an operand: three (hi, mid, lo) for fp32, one for bf16."""
    return 1 if dtype == torch.bfloat16 else 3


def _pairs(planes: int):
    """The product schedule: plane pairs (i, j) with i + j < planes, smallest
    products first, in the kernel's order (hl, mm, lh, hm, mh, hh at 3)."""
    return [(i, s - i) for s in range(planes - 1, -1, -1) for i in range(s + 1)]


def _depth(k: int) -> int:
    """K padded to whole slices, at least one (the planes' row length)."""
    return max(1, cdiv(k, SLICE)) * SLICE


def _pack_ref(x: torch.Tensor, *, trans: bool = False, planes: int = 3) -> torch.Tensor:
    """Plain version of the pack pass: op(x) (x, or xᵀ with `trans`; rows x K)
    as (planes, rows, kp) bf16, plane p = rn(x - planes before it), K
    zero-padded to whole slices."""
    r = (x.T if trans else x).float()
    rows, k = r.shape
    out = torch.zeros((planes, rows, _depth(k)), dtype=torch.bfloat16, device=x.device)
    for p in range(planes):
        out[p, :, :k] = r.to(torch.bfloat16)
        r = r - out[p, :, :k].float()  # exact in fp32
    return out


def _matmul_split_ref(a, b, c=None, *, ta=False, tb=False, alpha=1.0, beta=1.0,
                      out_dtype=None, planes=None) -> torch.Tensor:
    """Plain version of the kernel's arithmetic: `planes` bf16 planes of
    op(a) and op(b) (by default 3 for fp32, 1 for bf16), each slice's
    pair products summed in fp32, the slices' sums added in fp32 in order,
    then the epilogue. The tensor cores' truncating sums inside a slice are
    round-to-nearest here."""
    m, n, _ = _shape(a, b, ta, tb)
    planes = planes or _planes_of(a.dtype)
    pa = _pack_ref(a, trans=ta, planes=planes)
    pb = _pack_ref(b, trans=not tb, planes=planes)
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for k0 in range(0, pa.shape[2], SLICE):
        part = None
        for i, j in _pairs(planes):
            prod = pa[i, :, k0:k0 + SLICE].float() @ pb[j, :, k0:k0 + SLICE].float().T
            part = prod if part is None else part + prod
        acc += part
    acc = acc * alpha
    if c is not None:
        acc = acc + beta * c.float()
    return acc.to(out_dtype or a.dtype)


def _lib():
    lib = _build.library()
    if not getattr(lib, "_npw_gemm_typed", False):
        p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        ip = ctypes.POINTER(ctypes.c_int)
        lib.npw_gemm_pack.argtypes = [i, i, i, p, ll, i, i, i, p, p, ip]
        lib.npw_gemm_split.argtypes = [i, i, p, ll, p, ll, i, p, ll, p, ll, i, i, f, f, p, ip]
        lib.npw_gemm_split_plan.argtypes = [i, ip, ip, ip]
        for fn in (lib.npw_gemm_pack, lib.npw_gemm_split, lib.npw_gemm_split_plan):
            fn.restype = i
        lib._npw_gemm_typed = True
    return lib


def _strided(t: torch.Tensor):
    """(tensor, leading dimension), copying only a layout the kernel can't read."""
    ld = leading_dim(t)
    if ld is None:
        t = t.contiguous()
        ld = leading_dim(t)
    return t, ld


def split_plan(planes: int) -> dict:
    """The mainloop's slice depth, ring stages and dynamic shared bytes per
    CTA at `planes` planes (1, 2 or 3), as csrc/gemm_split.cu sets them."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    _build.check(_lib().npw_gemm_split_plan(planes, *map(ctypes.byref, vals)), "split plan")
    return dict(zip(("slice", "stages", "smem_bytes"), (v.value for v in vals)))


def _check_devices(a, **others) -> None:
    for name, t in others.items():
        if t is not None and t.device != a.device:
            raise ValueError(f"{name} on {t.device}, a on {a.device}")


def _out_ld(out: torch.Tensor, m: int, n: int) -> int:
    ldo = leading_dim(out)
    if ldo is None or tuple(out.shape) != (m, n):
        raise ValueError(f"out must be ({m}, {n}) with unit column stride, got "
                         f"{tuple(out.shape)} strides {out.stride()}")
    return ldo


def _pack(lib, x, ldx, trans, rows, k, kp, planes, dst, stream, launched) -> int:
    """Enqueue the pack of op(x) (rows x k) into `planes` planes at `dst`."""
    return lib.npw_gemm_pack(int(x.dtype == torch.bfloat16), planes, int(trans), x.data_ptr(),
                             ldx, rows, k, kp, dst, stream, ctypes.byref(launched))


def _mainloop(lib, planes, a_planes, a_stride, b_planes, b_stride, kp, c, ldc, out, ldo,
              m, n, alpha, beta, stream, launched) -> int:
    """Enqueue the mainloop over packed planes (strides in elements)."""
    return lib.npw_gemm_split(planes, int(out.dtype == torch.bfloat16), a_planes, a_stride,
                              b_planes, b_stride, kp,
                              c.data_ptr() if c is not None else None, ldc, out.data_ptr(), ldo,
                              m, n, float(alpha), float(beta), stream, ctypes.byref(launched))


def _split_launch(a, b, c, out, ta, tb, alpha, beta, m, n, k, planes):
    """Pack op(A) and op(B) into `planes` bf16 planes, then the mainloop:
    three device launches on the current stream. Returns (device launches
    enqueued, the C entries' return code, the step it came from); the
    caller counts and raises."""
    _check_devices(a, b=b, c=c, out=out)
    a, lda = _strided(a)
    b, ldb = _strided(b)
    ldc = 0
    if c is not None:
        c, ldc = _strided(c)
    ldo = _out_ld(out, m, n)
    kp = _depth(k)
    # op(A)'s planes (planes, m, kp), then op(B)'s (planes, n, kp), in one buffer
    buf = torch.empty(planes * (m + n) * kp, dtype=torch.bfloat16, device=a.device)
    a_planes, b_planes = buf.data_ptr(), buf.data_ptr() + 2 * planes * m * kp
    lib, launched = _lib(), ctypes.c_int(0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        what, rc = "pack A", _pack(lib, a, lda, ta, m, k, kp, planes, a_planes, stream, launched)
        if rc == 0:
            what, rc = "pack B", _pack(lib, b, ldb, not tb, n, k, kp, planes, b_planes, stream,
                                       launched)
        if rc == 0:
            what, rc = "mainloop", _mainloop(lib, planes, a_planes, m * kp, b_planes, n * kp, kp,
                                             c, ldc, out, ldo, m, n, alpha, beta, stream,
                                             launched)
    return launched.value, rc, what


def _launch(a, b, c, out, ta, tb, alpha, beta, m, n, k):
    """The matmul kernel: `_split_launch` at the operands' planes, counted
    as one call."""
    global LAUNCHES, DEVICE_LAUNCHES
    if a.dtype not in _KERNEL_DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul kernel takes fp32 or bf16 A and B of one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    if out.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"matmul kernel writes fp32 or bf16, not {out.dtype}")
    launched, rc, what = _split_launch(a, b, c, out, ta, tb, alpha, beta, m, n, k,
                                       _planes_of(a.dtype))
    LAUNCHES += 1
    DEVICE_LAUNCHES += launched
    _build.check(rc, f"matmul kernel ({what})")
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
