"""Factorization tile kernels: potrf, (potrf, its inverse), trtri, trsm,
the CholeskyQR2 chain and the blocked-Householder QR.

Counterpart of numpywren_tpu/ops/pallas_factor.py. Module and function
names are the JAX package's, so callers and tests read alike; the kernels
are hand-written CUDA C++ for Hopper:

- ``csrc/potrf.cu``: ``potrf`` of an (n, n) fp32 tile as a right-looking
  blocked factor over many CTAs, enqueued from C on the caller's stream:
  per 128-wide panel a one-CTA diagonal step (the block and its inverse in
  shared memory, factored by a 32-wide recursion: one warp factors and
  inverts each 32 x 32 sub-block in registers, all warps solve and update
  the rest), then the panel solve X = A21 W11ᵀ and the trailing update
  A22 -= X Xᵀ as launches of ``csrc/gemm.cu``'s FP32 FFMA ``npw_gemm``, and
  a store of X into L.
- ``csrc/trtri.cu``: ``trtri`` of an (n, n) lower-triangular fp32 tile
  by recursive doubling, 1 + 2⌈log2(n/128)⌉ launches: one launch of n/128
  CTAs inverts the 128 x 128 diagonal blocks in shared memory (a warp per
  32 x 32 sub-block by forward substitution, then the levels h = 32, 64
  inside the block); then per level h = 128, 256, ... two launches over
  64 x 64 output tiles of every pair of h-blocks (A, C):
  T = L[C, A] W[A, A], then W[C, A] = -W[C, C] T, the products' k ranges
  cut by W's zero triangles.
- ``potrf_inv`` is ``csrc/potrf.cu``'s sequence with each panel's W11 left
  in the inverse's diagonal block, then ``trtri.cu``'s levels from h = 128
  (``npw_potrf_inv``): (4n/128 − 3) + 2⌈log2(n/128)⌉ launches.
- ``csrc/cholqr_chain.cu``: CholeskyQR2 passes 1-2 of
  ``compiler.lower._cholqr_adaptive`` as one launch sequence (15 + the
  potrf_inv sequence's launches, ``device_launches("cholqr2_chain", b)``):
  the shift, ``npw_potrf_inv`` for the shifted factor and its inverse, the
  analytic pass-2 Gram and the Neumann products as FFMA ``npw_gemm``
  launches, the Neumann or identity fold chosen on the device, the folded
  inverse and R; then the apply of the folded inverse to the tall operand
  as ``csrc/gemm_split.cu``'s pack and mainloop at three bf16 planes
  (bf16x6, as the TPU computes HIGHEST). Its plain versions:
  ``cholqr2_chain_ref`` (fp32 throughout, the CPU route) and
  ``_cholqr2_chain_steps_ref`` (the sequence's own arithmetic).
- ``csrc/qr.cu``: the thin compact-WY Householder QR of an (m, n) tile with
  LAPACK geqrf signs, one cooperative launch of P = min(16, m / 32) CTAs,
  each holding its m / P rows of the working copy and of V (later of Q) in
  shared memory; the CTAs meet only in column sums through device scratch,
  added in CTA order. Its plain version in that arithmetic order is
  ``_qr_rowsplit_ref``.

Routing, the same for every wrapper: a CUDA tensor inside the envelope
launches the kernel or raises; a CPU tensor takes the plain PyTorch
version (``potrf_ref``, ``potrf_inv_ref``, ``trtri_ref``,
``cholqr2_chain_ref``, ``qr_ref``), a blocked step-by-step transcription of
the kernel, so the two differ only in summation order (potrf_ref and
potrf_inv_ref keep the reference's 128-wide column loop: the kernel's
diagonal step has its own plain version, ``_factor_block_rec_ref``; the
inverses follow the kernels' doubling order, ``_inverse_levels_ref``).
Outside the envelope (the TPU's VMEM limits kept for parity: fp32,
128 | n <= 1024 for the factors; 128 | m, 128 | n <= 512, m >= n,
m n <= 2^18 for QR) a shape check routes the factor wrappers to
``torch.linalg``, the reference's own library fallback; the chain raises
ValueError there, as the reference does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from numpywren_tpu_torch.ops import _build
from numpywren_tpu_torch.ops.common import check_precision, on_cuda
from numpywren_tpu_torch.ops.gemm import _matmul_split_ref, matmul

_B = 128  # the diagonal block one CTA factors in shared memory
_R = 32   # the potrf diagonal step's sub-block: one warp's rows

LAUNCHES = {"potrf": 0, "potrf_diag": 0, "potrf_inv": 0, "trtri": 0, "cholqr2_chain": 0,
            "qr": 0}
"""Wrapper calls that launched a kernel in this process, by kernel (plain
versions do not count). One potrf, potrf_inv or trtri call enqueues a
sequence of device launches (DEVICE_LAUNCHES); "potrf_diag" counts the
potrf diagonal step run alone, for its comparison with
_factor_block_rec_ref."""

DEVICE_LAUNCHES = {"potrf": 0, "potrf_inv": 0, "trtri": 0, "cholqr2_chain": 0}
"""Device kernels that the launch sequences enqueued in this process, as
csrc/potrf.cu, csrc/trtri.cu and csrc/cholqr_chain.cu count them:
device_launches(kind, n) a call."""

_CHAIN_OWN = 15
"""The chain's own launches (csrc/cholqr_chain.cu): the row sums, the
shift, P = W1 W1ᵀ, the fold's preparation, the four Neumann products and
the "+ I" between the first two, the select, linv, R, and the apply's two
packs and mainloop; npw_potrf_inv's sequence comes on top."""


def device_launches(kind: str, n: int) -> int:
    """Device launches of one `kind` call at n (128 | n): potrf's diagonal
    step and three multi-CTA launches per panel after the first, trtri's
    diagonal launch and two launches per doubling level; potrf_inv is
    potrf's sequence and trtri's levels; the chain at b = n is its own
    launches and potrf_inv's sequence."""
    levels = 2 * (n // _B - 1).bit_length()  # 2 ceil(log2(n / 128))
    potrf = 4 * n // _B - 3
    return {"potrf": potrf, "trtri": 1 + levels, "potrf_inv": potrf + levels,
            "cholqr2_chain": _CHAIN_OWN + potrf + levels}[kind]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in DEVICE_LAUNCHES:
        DEVICE_LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _factor_block_ref(d: torch.Tensor):
    """(l, w) of the (B, B) SPD block d: l lᵀ = d, w = l⁻¹, by the column
    loop of _factor_block_with_inverse: pivot, scaled column, the inverse's
    row j = (e_j - L[j, :j] W) / piv, then the rank-1 trailing update."""
    b = d.shape[0]
    d = d.clone()
    l = torch.zeros_like(d)
    w = torch.zeros_like(d)
    for j in range(b):
        piv = torch.sqrt(d[j, j])
        col = d[:, j] / piv
        col[:j] = 0
        wrow = -(l[j] @ w)
        wrow[j] += 1
        w[j] = wrow / piv
        l[:, j] = col
        d -= torch.outer(col, col)
    return l, w


def _invert_block_ref(lb: torch.Tensor) -> torch.Tensor:
    """w = lb⁻¹ for a lower-triangular block by row-wise forward
    substitution (_trtri_kernel's invert_block); reads the lower triangle."""
    b = lb.shape[0]
    w = torch.zeros_like(lb)
    for j in range(b):
        wrow = -(lb[j, :j] @ w[:j])
        wrow[j] += 1
        w[j] = wrow / lb[j, j]
    return w


def _offdiag_inverse_ref(l: torch.Tensor, w: torch.Tensor, block: int = _B) -> None:
    """W[i, j] = -W[i, i] Σ_k L[i, k] W[k, j] for the strictly lower blocks,
    in place; W's diagonal blocks must be set."""
    nb = l.shape[0] // block

    def blk(m, i, j):
        return m[i * block:(i + 1) * block, j * block:(j + 1) * block]

    for j in range(nb):
        for i in range(j + 1, nb):
            acc = sum(blk(l, i, k) @ blk(w, k, j) for k in range(j, i))
            blk(w, i, j).copy_(-(blk(w, i, i) @ acc))


def _blocked_factor_ref(a: torch.Tensor, block: int = _B):
    """Blocked (L, W) of _potrf_inv_into's factor loop: per `block`-wide
    diagonal block the column loop, the below-panel solve X = A21 W11ᵀ and
    the trailing update A22 -= X Xᵀ. W holds the diagonal blocks' inverses
    W11 and zeros elsewhere."""
    n = a.shape[0]
    l = a.clone()
    w = torch.zeros_like(a)
    for j0 in range(0, n, block):
        j1 = j0 + block
        lb, wb = _factor_block_ref(l[j0:j1, j0:j1])
        l[j0:j1, j0:j1] = lb
        w[j0:j1, j0:j1] = wb
        if j1 < n:
            x = l[j1:, j0:j1] @ wb.T
            l[j1:, j0:j1] = x
            l[j1:, j1:] -= x @ x.T
    return torch.tril(l), w


def _inverse_levels_ref(l: torch.Tensor, w: torch.Tensor, h0: int) -> None:
    """The trtri kernel's doubling levels, in place on w (right on its
    h0-wide diagonal blocks): for h = h0, 2 h0, ... while h < n, every pair
    A = [2hp, 2hp + h), C = [2hp + h, min(2hp + 2h, n)) takes
    W[C, A] = -W[C, C] (L[C, A] W[A, A]) and W[A, C] = 0."""
    n = l.shape[0]
    h = h0
    while h < n:
        for a0 in range(0, n - h, 2 * h):
            c0, c1 = a0 + h, min(a0 + 2 * h, n)
            t = l[c0:c1, a0:c0] @ w[a0:c0, a0:c0]
            w[c0:c1, a0:c0] = -(w[c0:c1, c0:c1] @ t)
            w[a0:c0, c0:c1] = 0
        h *= 2


def _factor_block_rec_ref(d: torch.Tensor):
    """Plain version of the potrf kernel's diagonal step: (l, w) of the
    (128, 128) SPD block d, l lᵀ = d, w = l⁻¹, by its 32-wide recursion.
    Per 32-wide sub-block the column loop (the warp's factor and forward
    substitution), the rows below solved by the sub-block's inverse and
    the rank-32 trailing update; then w's strictly lower sub-blocks by
    W[i, j] = -W[i, i] Σ_k L[i, k] W[k, j]."""
    l, w = _blocked_factor_ref(d, block=_R)
    _offdiag_inverse_ref(l, w, _R)
    return l, w


def potrf_ref(a: torch.Tensor) -> torch.Tensor:
    """Plain version of the potrf kernel: the lower factor, strict upper 0."""
    return _blocked_factor_ref(a)[0]


def potrf_inv_ref(a: torch.Tensor):
    """Plain version of the potrf_inv kernel: (L, L⁻¹). The factor loop's
    128-wide W11s, then the trtri kernel's doubling levels from h = 128."""
    l, w = _blocked_factor_ref(a)
    _inverse_levels_ref(l, w, _B)
    return l, w


def trtri_ref(l: torch.Tensor) -> torch.Tensor:
    """Plain version of the trtri kernel: L⁻¹ of a lower-triangular tile
    (its strict upper is not read). The 32 x 32 diagonal blocks by forward
    substitution, then the doubling levels from h = 32."""
    n = l.shape[0]
    w = torch.zeros_like(l)
    for i0 in range(0, n, _R):
        w[i0:i0 + _R, i0:i0 + _R] = _invert_block_ref(l[i0:i0 + _R, i0:i0 + _R])
    _inverse_levels_ref(l, w, _R)
    return w


# ---------------------------------------------------------------------------
# Envelopes
# ---------------------------------------------------------------------------

def _supported(n: int, dtype) -> bool:
    return n % _B == 0 and n <= 1024 and dtype == torch.float32


def _chain_tm(m: int, n: int) -> int:
    """The reference's stream-tile rows (VMEM-sized); kept for the
    envelope's parity: the CUDA apply streams any m."""
    for tm in (2048, 1024, 512, 256, 128):
        if m % tm == 0 and tm * n * 4 <= (1 << 18):
            return tm
    return 0


def _chain_supported(m: int, n: int, dtype) -> bool:
    return (n % _B == 0 and n <= 256 and m >= n and dtype == torch.float32
            and _chain_tm(m, n) > 0)


def chain_supported(m: int, n: int, dtype) -> bool:
    """Public envelope check for cholqr2_chain_pallas."""
    return _chain_supported(m, n, dtype)


def _square(x: torch.Tensor, what: str) -> int:
    if x.dim() != 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"{what}: need a square tile, got {tuple(x.shape)}")
    return x.shape[0]


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.library()
    if not getattr(lib, "_npw_factor_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.npw_potrf.argtypes = [i, p, p, p, p, ctypes.POINTER(i)]
        lib.npw_potrf.restype = i
        lib.npw_potrf_inv.argtypes = [i, p, p, p, p, p, ctypes.POINTER(i)]
        lib.npw_potrf_inv.restype = i
        lib.npw_trtri.argtypes = [i, p, p, p, p, ctypes.POINTER(i)]
        lib.npw_trtri.restype = i
        lib.npw_potrf_diag.argtypes = [p, p, p, p]
        lib.npw_potrf_diag.restype = i
        lib.npw_cholqr2_chain.argtypes = [i, i, i, p, p, p, p, p, p, p, f, f, p,
                                          ctypes.POINTER(i)]
        lib.npw_cholqr2_chain.restype = i
        lib.npw_cholqr2_chain_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_longlong),
                                               ctypes.POINTER(ctypes.c_longlong)]
        lib.npw_cholqr2_chain_plan.restype = None
        lib.npw_qr.argtypes = [i, i, p, p, p, p, p]
        lib.npw_qr.restype = i
        lib.npw_qr_plan.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i),
                                    ctypes.POINTER(ctypes.c_longlong)]
        lib.npw_qr_plan.restype = None
        lib._npw_factor_typed = True
    return lib


def _contiguous_on(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if x.device != dev:
        raise ValueError(f"operand on {x.device}, expected {dev}")
    return x.contiguous()


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte aligned address (the kernel loads float4s)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _launch_sequence(kind: str, a: torch.Tensor):
    """One launch sequence on the current stream: "potrf" (csrc/potrf.cu)
    gives L, "potrf_inv" (potrf.cu's sequence, then csrc/trtri.cu's levels)
    (L, L⁻¹), "trtri" (csrc/trtri.cu) L⁻¹ of the lower-triangular a.
    Scratch: potrf's W11 (128 x 128) then X ((n - 128) x 128); trtri's
    levels' T, n²/4 floats; potrf_inv X, later T."""
    n = a.shape[0]
    a = _aligned(a)
    outs = [torch.empty_like(a) for _ in range(2 if kind == "potrf_inv" else 1)]
    floats = {"potrf": n * _B, "trtri": n * n // 4, "potrf_inv": max(n * _B, n * n // 4)}[kind]
    scratch = torch.empty(floats, dtype=torch.float32, device=a.device)
    launched = ctypes.c_int(0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_lib(), f"npw_{kind}")(n, a.data_ptr(), *(o.data_ptr() for o in outs),
                                            scratch.data_ptr(), stream, ctypes.byref(launched))
    LAUNCHES[kind] += 1
    DEVICE_LAUNCHES[kind] += launched.value
    _build.check(rc, f"{kind} kernel")
    return outs[0] if len(outs) == 1 else tuple(outs)


def potrf_diag_block(d: torch.Tensor):
    """The potrf kernel's diagonal step alone: (l, w) of a (128, 128) SPD
    fp32 block (its lower triangle read), l lᵀ = d with strict upper 0,
    w = l⁻¹. One CTA on the card, _factor_block_rec_ref on the CPU."""
    if tuple(d.shape) != (_B, _B) or d.dtype != torch.float32:
        raise ValueError(f"potrf_diag_block: need a ({_B}, {_B}) fp32 block, "
                         f"got {tuple(d.shape)} {d.dtype}")
    if not on_cuda(d):
        return _factor_block_rec_ref(d)
    d = _aligned(d)
    l, w = torch.empty_like(d), torch.empty_like(d)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().npw_potrf_diag(d.data_ptr(), l.data_ptr(), w.data_ptr(), stream)
    LAUNCHES["potrf_diag"] += 1
    _build.check(rc, "potrf diagonal step")
    return l, w


def _cholesky_lib(a: torch.Tensor) -> torch.Tensor:
    # lax.linalg.cholesky(symmetrize_input=False): the lower triangle only
    return torch.linalg.cholesky_ex(a)[0]


def _trtri_lib(l: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(l.shape[0], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def potrf_pallas(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of an SPD tile (fp32, 128 | n <= 1024): the
    potrf kernel on the card, potrf_ref on the CPU, torch.linalg outside
    the envelope. The strict upper triangle is exactly 0; a non-SPD tile
    gives non-finite values (the pivot's square root), with no host read."""
    n = _square(a, "potrf_pallas")
    if not _supported(n, a.dtype):
        return _cholesky_lib(a)
    if not on_cuda(a):
        return potrf_ref(a)
    return _launch_sequence("potrf", a)


def potrf_inv_pallas(a: torch.Tensor):
    """(L, L⁻¹) of an SPD tile (same envelope): the potrf_inv launch
    sequence on the card, potrf_inv_ref on the CPU; cholesky + triangular
    solve outside it."""
    n = _square(a, "potrf_inv_pallas")
    if not _supported(n, a.dtype):
        l = _cholesky_lib(a)
        return l, _trtri_lib(l)
    if not on_cuda(a):
        return potrf_inv_ref(a)
    return _launch_sequence("potrf_inv", a)


def trtri_pallas(l: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular tile (same envelope): the trtri launch
    sequence on the card, trtri_ref on the CPU, solve_triangular outside
    it."""
    n = _square(l, "trtri_pallas")
    if not _supported(n, l.dtype):
        return _trtri_lib(l)
    if not on_cuda(l):
        return trtri_ref(l)
    return _launch_sequence("trtri", l)


def trsm_pallas(a: torch.Tensor, l: torch.Tensor, *,
                precision: Optional[str] = None) -> torch.Tensor:
    """Solve X Lᵀ = A (kernels.trsm semantics) by the explicit tile inverse
    and one GEMM at `precision` (ops.gemm.matmul's routing)."""
    return matmul(a, trtri_pallas(l), tb=True, precision=precision)


# ---------------------------------------------------------------------------
# The CholeskyQR2 chain
# ---------------------------------------------------------------------------

def neumann_fold(e2: torch.Tensor):
    """(l2, li2) of the first-order cleanup: M = tril(E, -1) + diag(E)/2,
    li2 = (I + M²)(I - M), l2 = (I + M⁴)(I + M), in the chain kernel's
    order: M², I + M², li2 = (I + M²) - (I + M²) M, then M⁴ + I and
    l2 = (M⁴ + I)(I + M)."""
    eye = torch.eye(e2.shape[0], dtype=e2.dtype, device=e2.device)
    m_ = torch.tril(e2, -1) + torch.diag(0.5 * torch.diagonal(e2))
    m2 = m_ @ m_
    ip2 = eye + m2
    li2 = ip2 - ip2 @ m_
    m4 = m2 @ m2
    return (eye + m4) @ (eye + m_), li2


def _chain_step0_ref(g: torch.Tensor, *, rows: bool, shift_c: float):
    """Step 0 of the chain in plain PyTorch, in the kernels' order:
    (linv, total, dev2). The shift floor = shift_c max row sum |g|, (L1, W1)
    of g + floor I by potrf_inv_ref (the kernels' blocked and doubling
    order), E2 = -floor W1 W1ᵀ, dev2 = max |E2|, the Neumann products
    (neumann_fold), the fold chosen with torch.where on the tensors' device
    (no host read), linv = LI2 W1 and R."""
    b = g.shape[0]
    eye = torch.eye(b, dtype=g.dtype, device=g.device)
    floor = shift_c * torch.max(torch.sum(torch.abs(g), dim=1))
    l1, w1 = potrf_inv_ref(g + floor * eye)
    e2 = (-floor) * (w1 @ w1.T)
    dev2 = torch.max(torch.abs(e2))
    l2, li2 = neumann_fold(e2)
    cleanup = dev2 < 1e-1
    l2 = torch.where(cleanup, l2, eye)
    li2 = torch.where(cleanup, li2, eye)
    total = l1 @ l2 if rows else l2.T @ l1.T
    return li2 @ w1, total, dev2


def cholqr2_chain_ref(g: torch.Tensor, p: torch.Tensor, *, rows: bool,
                      shift_c: float, conv_gate: float):
    """Plain version of the chain: (q, total, conv, dev2) with conv and dev2
    0-d tensors, fp32 throughout (as JAX on the CPU computes the reference
    kernel): step 0 (_chain_step0_ref), then the apply in fp32."""
    linv, total, dev2 = _chain_step0_ref(g, rows=rows, shift_c=shift_c)
    q = linv @ p if rows else p @ linv.T
    return q, total, dev2 < conv_gate, dev2


def _cholqr2_chain_steps_ref(g: torch.Tensor, p: torch.Tensor, *, rows: bool,
                             shift_c: float, conv_gate: float):
    """The chain's launch sequence in plain PyTorch, the kernels' own
    arithmetic in another summation order: step 0 (_chain_step0_ref), then
    the apply through three bf16 planes (gemm._matmul_split_ref). Used by
    the tests and the card's check of the kernel; on no path."""
    linv, total, dev2 = _chain_step0_ref(g, rows=rows, shift_c=shift_c)
    if rows:
        q = _matmul_split_ref(linv, p, planes=3)
    else:
        q = _matmul_split_ref(p, linv, tb=True, planes=3)
    return q, total, dev2 < conv_gate, dev2


def _chain_plan(m: int, b: int):
    """(fp32 floats, bf16 elements) of the chain's scratch, as
    csrc/cholqr_chain.cu lays it out. Reads the built library."""
    floats, halves = ctypes.c_longlong(0), ctypes.c_longlong(0)
    _lib().npw_cholqr2_chain_plan(m, b, ctypes.byref(floats), ctypes.byref(halves))
    return floats.value, halves.value


def cholqr2_chain_pallas(g: torch.Tensor, p: torch.Tensor, *, rows: bool,
                         shift_c: float, conv_gate: float,
                         precision: Optional[str] = None):
    """CholeskyQR2 pass-1-2 chain: (q, total, conv, dev2) with
    p = q @ total (rows=False) or p = total @ q (rows=True), the fold-path
    semantics of compiler.lower._cholqr_adaptive; the extras loop stays
    with the caller. conv and dev2 are 0-d tensors on p's device.

    `precision` is checked: the reference coerces None and "high" to
    "highest", and on the card every precision runs the apply at three
    bf16 planes (bf16x6), as ops.gemm.matmul routes "highest" and
    "default" for fp32 operands; the CPU route is fp32 throughout. Raises
    ValueError outside the envelope (fp32, 128 | b <= 256, the reference's
    stream tile dividing m >= b) and for an unknown precision; callers gate
    on chain_supported()."""
    check_precision(precision or "highest")
    b = p.shape[0] if rows else p.shape[1]
    m = p.shape[1] if rows else p.shape[0]
    if not _chain_supported(m, b, p.dtype) or tuple(g.shape) != (b, b):
        raise ValueError(f"cholqr2_chain_pallas: unsupported shapes "
                         f"m={m} b={b} dtype={p.dtype}")
    if not on_cuda(p):
        return cholqr2_chain_ref(g, p, rows=rows, shift_c=shift_c, conv_gate=conv_gate)
    dev = p.device
    g = _contiguous_on(g, dev)
    p = _contiguous_on(p, dev)
    if g.dtype != torch.float32:
        raise TypeError(f"cholqr2_chain_pallas: g must be fp32, got {g.dtype}")
    q = torch.empty_like(p)
    total = torch.empty((b, b), dtype=torch.float32, device=dev)
    stat = torch.empty(2, dtype=torch.float32, device=dev)
    floats, halves = _chain_plan(m, b)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    plane_buf = torch.empty(halves, dtype=torch.bfloat16, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().npw_cholqr2_chain(
            int(rows), m, b, g.data_ptr(), p.data_ptr(), q.data_ptr(),
            total.data_ptr(), stat.data_ptr(), scratch.data_ptr(), plane_buf.data_ptr(),
            float(shift_c), float(conv_gate), stream, ctypes.byref(launched))
    LAUNCHES["cholqr2_chain"] += 1
    DEVICE_LAUNCHES["cholqr2_chain"] += launched.value
    _build.check(rc, "cholqr2_chain kernel")
    return q, total, stat[1] > 0.5, stat[0]


# ---------------------------------------------------------------------------
# Blocked-Householder QR (the qr_factor / qr_leaf member of the family)
# ---------------------------------------------------------------------------

def _householder_panel_ref(s: torch.Tensor, v: torch.Tensor, taus: torch.Tensor,
                           j0: int) -> None:
    """The column loop of _householder_panel on s[:, j0:j0+B], in place:
    geqrf signs (beta = -sign(alpha)||x||, v[diag] = 1, tau = (beta -
    alpha)/beta), a zero column gives tau = 1 and v = 0, the panel's later
    columns take the reflection and R[jg, jg] = beta exactly. Column jg of
    v and taus[jj] receive the vector and its tau. No host read: the
    branches are torch.where on the device."""
    one = torch.ones((), dtype=s.dtype, device=s.device)
    for jj in range(_B):
        jg = j0 + jj
        x = s[jg:, jg]
        sigma = torch.dot(x, x)
        alpha = x[0].clone()
        nrm = torch.sqrt(sigma)
        beta = torch.where(alpha >= 0, -nrm, nrm)
        good = sigma > 0
        vcol = torch.where(good, x / torch.where(good, alpha - beta, one), 0 * one)
        vcol[0] = torch.where(good, one, 0 * one)
        tau = torch.where(good, (beta - alpha) / torch.where(good, beta, one), one)
        v[jg:, jg] = vcol
        taus[jj] = tau
        c1 = j0 + _B
        w = (vcol @ s[jg:, jg + 1:c1]) * tau
        s[jg:, jg + 1:c1] -= torch.outer(vcol, w)
        s[jg, jg] = beta


def _invert_upper_ref(tinv: torch.Tensor) -> torch.Tensor:
    """T = (T⁻¹)⁻¹ for an upper-triangular T⁻¹, rows bottom-up
    (_invert_upper): T[j] = (e_j - T⁻¹[j, j+1:] T[j+1:]) / T⁻¹[j, j]."""
    b = tinv.shape[0]
    t = torch.zeros_like(tinv)
    for j in range(b - 1, -1, -1):
        row = -(tinv[j, j + 1:] @ t[j + 1:])
        row[j] += 1
        t[j] = row / tinv[j, j]
    return t


def _invert_upper_blocked_ref(u: torch.Tensor, w: int = 32) -> torch.Tensor:
    """T = U⁻¹ for an upper-triangular U as the qr kernel forms it: the
    w x w diagonal blocks by _invert_upper_ref, then block rows bottom-up,
    T[i, i+1:] = -T[i, i] (U[i, i+1:] T[i+1:, i+1:])."""
    b = u.shape[0]
    t = torch.zeros_like(u)
    for i0 in range(0, b, w):
        t[i0:i0 + w, i0:i0 + w] = _invert_upper_ref(u[i0:i0 + w, i0:i0 + w])
    for i in reversed(range(b // w - 1)):
        r0, r1 = i * w, (i + 1) * w
        t[r0:r1, r1:] = -(t[r0:r1, r0:r1] @ (u[r0:r1, r1:] @ t[r1:, r1:]))
    return t


def qr_ref(a: torch.Tensor):
    """Plain version of the qr kernel: (q, r) by the blocked compact-WY
    steps of _qr_kernel. Per 128-column panel the column loop, T from
    T⁻¹ = strict_upper(VᵀV) + diag(1/tau), the trailing update
    S -= V(Tᵀ(VᵀS)); then R = triu(S[:n]) and Q rebuilt right to left,
    Q -= V(T(VᵀQ)). V is zero above its diagonal, so the products run over
    rows (and, in the rebuild, columns) from the panel's first on: the
    reference's sums less their exact zero terms."""
    m, n = a.shape
    s = a.clone()
    v = torch.zeros_like(a)
    ts = []
    for j0 in range(0, n, _B):
        taus = torch.zeros(_B, dtype=a.dtype, device=a.device)
        _householder_panel_ref(s, v, taus, j0)
        vp = v[j0:, j0:j0 + _B]
        t = _invert_upper_ref(torch.triu(vp.T @ vp, 1) + torch.diag(1.0 / taus))
        ts.append(t)
        if j0 + _B < n:
            st = s[j0:, j0 + _B:]
            st -= vp @ (t.T @ (vp.T @ st))
    r = torch.triu(s[:n])
    q = torch.eye(m, n, dtype=a.dtype, device=a.device)
    for p in reversed(range(n // _B)):
        j0 = p * _B
        vp = v[j0:, j0:j0 + _B]
        qs = q[j0:, j0:]
        qs -= vp @ (ts[p] @ (vp.T @ qs))
    return q, r


def _qr_parts(m: int) -> int:
    """The qr kernel's CTAs for m rows: each owns m / P rows, 32 to 128."""
    return min(16, m // 32)


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """x[0] + x[1] + ... + x[-1] along dim 0, in that order: the kernel's
    sum of its CTAs' partials."""
    acc = x[0]
    for part in x[1:]:
        acc = acc + part
    return acc


def _qr_rowsplit_ref(a: torch.Tensor, parts: int):
    """The qr kernel's arithmetic order in plain PyTorch: (q, r) of qr_ref's
    steps with the rows split into `parts` blocks of m / parts, each step's
    sums formed per block and added in block order. Per column jg: sigma
    over rows >= jg, the dot products sum_{r > jg} x_r s[r, c], and
    vᵀs[:, c] = ((alpha - beta) s[jg, c] + that) / (alpha - beta); per
    panel the column sum [VᵀV | VᵀS], T by 32-wide blocks
    (_invert_upper_blocked_ref) and the trailing update (V Tᵀ) W;
    the rebuild Q -= (V T)(VᵀQ) with VᵀQ a column sum. Used by the tests
    and the card's check of the kernel; on no path."""
    m, n = a.shape
    h = m // parts
    s = a.clone()
    v = torch.zeros_like(a)
    rows = torch.arange(m, device=a.device)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)

    def colsum(x, y):  # Σ_p x_pᵀ y_p over the row blocks, in block order
        return _ordered_sum(torch.bmm(x.reshape(parts, h, -1).mT, y.reshape(parts, h, -1)))

    ts = []
    for j0 in range(0, n, _B):
        c1 = j0 + _B
        taus = torch.zeros(_B, dtype=a.dtype, device=a.device)
        for jj in range(_B):
            jg = j0 + jj
            x = s[:, jg]
            xs = torch.where(rows >= jg, x, zero)
            xd = torch.where(rows > jg, x, zero)
            sigma = _ordered_sum((xs * xs).reshape(parts, h).sum(1))
            d = colsum(xd[:, None], s[:, jg + 1:c1])[0]
            alpha = s[jg, jg].clone()
            nrm = torch.sqrt(sigma)
            beta = torch.where(alpha >= 0, -nrm, nrm)
            good = sigma > 0
            denom = torch.where(good, alpha - beta, one)
            tau = torch.where(good, (beta - alpha) / torch.where(good, beta, one), one)
            w = torch.where(good, tau * ((denom * s[jg, jg + 1:c1] + d) / denom), zero)
            vcol = torch.where(good & (rows > jg), x / denom, zero)
            vcol[jg] = torch.where(good, one, zero)
            v[:, jg] = vcol
            taus[jj] = tau
            s[:, jg + 1:c1] -= torch.outer(vcol, w)
            s[jg, jg] = beta
        vp = v[:, j0:c1]
        gw = colsum(vp, torch.cat([vp, s[:, c1:]], dim=1))  # [VᵀV | VᵀS[:, c1:]]
        t = _invert_upper_blocked_ref(torch.triu(gw[:, :_B], 1) + torch.diag(1.0 / taus))
        ts.append(t)
        if c1 < n:
            s[:, c1:] -= (vp @ t.T) @ gw[:, _B:]
    r = torch.triu(s[:n])
    q = torch.eye(m, n, dtype=a.dtype, device=a.device)
    for p in reversed(range(n // _B)):
        j0 = p * _B
        vp = v[:, j0:j0 + _B]
        q[:, j0:] -= (vp @ ts[p]) @ colsum(vp, q[:, j0:])
    return q, r


def qr_plan(m: int, n: int) -> dict:
    """The qr kernel's launch for an (m, n) tile inside the envelope, as
    csrc/qr.cu computes it: its CTAs, each CTA's dynamic shared memory in
    bytes and the scratch in floats. Reads the built library."""
    parts, smem, floats = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)
    _lib().npw_qr_plan(m, n, ctypes.byref(parts), ctypes.byref(smem), ctypes.byref(floats))
    return {"parts": parts.value, "smem_bytes": smem.value, "scratch_floats": floats.value}


def _qr_supported(m: int, n: int, dtype) -> bool:
    return (m % _B == 0 and n % _B == 0 and m >= n and n <= 512
            and m * n <= (1 << 18) and dtype == torch.float32)


def qr_pallas(a: torch.Tensor):
    """Thin Householder QR of a tile, (q, r) with a = q r, q (m, n)
    orthonormal, r (n, n) upper triangular, LAPACK geqrf signs. Inside the
    envelope (fp32, 128 | m, 128 | n, m >= n, n <= 512, m n <= 2^18) the
    qr kernel on the card and qr_ref on the CPU; outside it
    torch.linalg.qr(mode="reduced"), the reference's jnp.linalg.qr."""
    if a.dim() != 2:
        raise ValueError(f"qr_pallas: need a 2-D tile, got {tuple(a.shape)}")
    m, n = a.shape
    if not _qr_supported(m, n, a.dtype):
        return torch.linalg.qr(a, mode="reduced")
    if not on_cuda(a):
        return qr_ref(a)
    a = a.contiguous()
    q = torch.empty_like(a)
    r = torch.empty((n, n), dtype=torch.float32, device=a.device)
    scratch = torch.empty(qr_plan(m, n)["scratch_floats"], dtype=torch.float32,
                          device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().npw_qr(m, n, a.data_ptr(), q.data_ptr(), r.data_ptr(), scratch.data_ptr(),
                           stream)
    LAUNCHES["qr"] += 1
    _build.check(rc, "qr kernel")
    return q, r
