"""bf16x3 matmul: fp32-parity GEMM on the bf16 tensor cores.

Counterpart of numpywren_tpu/ops/gemm3.py. Each fp32 operand splits into
bf16 hi + bf16 lo (x = hi + lo keeps ~16 more mantissa bits), and

    a @ b  ~=  hi_a @ hi_b + hi_a @ lo_b + lo_a @ hi_b

sums in fp32 (lo_a @ lo_b is below fp32 epsilon). With `c` the kernel
computes ``c - a @ op(b)`` in its epilogue, the Cholesky trailing update's
subtract, and may write it into `c` in place (``out=c``).

The kernel is ``csrc/gemm_split.cu`` at two planes (P = 2), the mainloop
``ops/gemm.py``'s matmul runs at three: a pack pass writes each operand's
hi and lo as bf16 planes (K-major, K padded to whole 64-deep slices), then
the TMA-fed wgmma mainloop runs the three products over them, adds each
slice's sum in fp32 and writes ``c - acc`` (alpha = -1, beta = 1) from its
epilogue. One call is three device launches on the current stream (pack
A, pack B, mainloop): ``LAUNCHES`` += 1, ``DEVICE_LAUNCHES`` += 3.

``Panel(b)`` packs one Cholesky panel once for all of its trailing
updates: ``Panel(b).sub_update(c, off, n, out=c)`` computes
``matmul3(b[off:], b[off:off + n], c, tb=True, out=c)`` as the mainloop
alone over rows of the one packed panel (the pack is one device launch,
each update one launch and one call in ``LAUNCHES``). On the card it gives
the per-call route's bits; on the CPU it is that route's plain version.

``matmul3_ref`` is the plain PyTorch version: the same split, three fp32
``torch.matmul`` of the upcast halves. A CPU tensor takes it; a CUDA
tensor launches the kernel or raises. On the CPU this is therefore an
exact bf16x3 emulation, where the JAX package's CPU path runs plain fp32.
``ops/gemm.py``'s ``_matmul_split_ref(..., planes=2)`` repeats the
kernel's own sum order (per-slice sums added in fp32).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from numpywren_tpu_torch.ops import _build
from numpywren_tpu_torch.ops.common import on_cuda
from numpywren_tpu_torch.ops.gemm import (
    _check_devices,
    _depth,
    _lib,
    _mainloop,
    _out_ld,
    _pack,
    _split_launch,
    _strided,
)

LAUNCHES = 0  # matmul3 calls and Panel updates on CUDA tensors (plain calls do not count)
DEVICE_LAUNCHES = 0  # their device launches, with each Panel's pack

PLANES = 2  # hi, lo


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


def _out(out, m, n, device):
    if out is None:
        return torch.empty((m, n), dtype=torch.float32, device=device)
    if out.dtype != torch.float32:
        raise ValueError(f"out must be fp32, not {out.dtype}")
    return out


def matmul3_ref(a, b, c=None, *, tb=False) -> torch.Tensor:
    """Plain PyTorch version: bf16 split, three fp32 matmuls of the halves."""
    _check(a, b, c, tb)
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b.T if tb else b)
    acc = a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    return c - acc if c is not None else acc


def matmul3(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None, *,
            tb: bool = False, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a @ op(b) at bf16x3 precision; with `c`, c - a @ op(b) in the same
    kernel. `out` receives the result in place and may be `c` itself."""
    global LAUNCHES, DEVICE_LAUNCHES
    m, n, k = _check(a, b, c, tb)
    if not on_cuda(a):
        res = matmul3_ref(a, b, c, tb=tb)
        return res if out is None else out.copy_(res)
    out = _out(out, m, n, a.device)
    alpha = -1.0 if c is not None else 1.0
    launched, rc, what = _split_launch(a, b, c, out, False, tb, alpha, 1.0, m, n, k, PLANES)
    LAUNCHES += 1
    DEVICE_LAUNCHES += launched
    _build.check(rc, f"matmul3 kernel ({what})")
    return out


class Panel:
    """An fp32 panel b (rows x w), packed once into bf16 hi and lo planes
    for the products c - b[off:] @ b[off:off + n]ᵀ of its trailing updates
    (see the module docstring). The planes are b's values when the Panel
    was made: b must not change while the Panel is in use."""

    def __init__(self, b: torch.Tensor):
        global DEVICE_LAUNCHES
        if b.dtype != torch.float32 or b.dim() != 2:
            raise TypeError(f"Panel takes a 2-D fp32 panel, got {b.dtype} {tuple(b.shape)}")
        self.b = b
        self.rows, self.k = b.shape
        self.kp = _depth(self.k)
        self.planes = None  # the CPU route keeps no planes
        if on_cuda(b):
            b, ldb = _strided(b)
            self.planes = torch.empty(PLANES * self.rows * self.kp, dtype=torch.bfloat16,
                                      device=b.device)
            lib, launched = _lib(), ctypes.c_int(0)
            with torch.cuda.device(b.device):
                rc = _pack(lib, b, ldb, False, self.rows, self.k, self.kp, PLANES,
                           self.planes.data_ptr(), torch.cuda.current_stream().cuda_stream,
                           launched)
            DEVICE_LAUNCHES += launched.value
            _build.check(rc, "matmul3 kernel (panel pack)")

    def sub_update(self, c: torch.Tensor, off: int, n: int, *,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """c - b[off:] @ b[off:off + n]ᵀ, written into `out` when given
        (`out` may be `c`)."""
        global LAUNCHES, DEVICE_LAUNCHES
        if off < 0 or n < 0 or off + n > self.rows:
            raise ValueError(f"rows [{off}, {off + n}) are outside the panel's {self.rows}")
        a, bt = self.b[off:], self.b[off:off + n]
        m = self.rows - off
        _check(a, bt, c, True)
        if self.planes is None:
            res = matmul3_ref(a, bt, c, tb=True)
            return res if out is None else out.copy_(res)
        _check_devices(self.b, c=c, out=out)
        out = _out(out, m, n, self.b.device)
        c, ldc = _strided(c)
        ldo = _out_ld(out, m, n)
        stride = self.rows * self.kp  # elements from one plane to the next
        rows_off = self.planes.data_ptr() + 2 * off * self.kp  # row `off` of plane 0
        lib, launched = _lib(), ctypes.c_int(0)
        with torch.cuda.device(self.b.device):
            rc = _mainloop(lib, PLANES, rows_off, stride, rows_off, stride, self.kp, c, ldc,
                           out, ldo, m, n, -1.0, 1.0, torch.cuda.current_stream().cuda_stream,
                           launched)
        LAUNCHES += 1
        DEVICE_LAUNCHES += launched.value
        _build.check(rc, "matmul3 kernel (panel update)")
        return out
