"""Region-fused lowering of DSL programs, on PyTorch tensors.

Counterpart of numpywren_tpu/compiler/lower.py for Cholesky, GEMM and TSQR.
The store keeps a matrix as ONE padded tensor, so a panel or a trailing
region is a strided view:

- Cholesky lowers to a handful of large GEMMs per column super-panel:
  1. the W x W diagonal block factors with one library potrf
     (``torch.linalg.cholesky_ex``, which reads only the lower triangle: the
     diagonal blocks' strict upper may hold stale values);
  2. the below-panel solve B := B L⁻ᵀ is a recursive GEMM-rich trsm
     (`_rtrsm`) whose tile-sized leaves multiply by an explicit inverse;
  3. one trailing update ``c - a·bᵀ`` per later column block.
- GEMM is one matmul over the flat tensors (`fused_gemm`).
- TSQR is a batched Householder combine tree (`fused_tsqr_fn`), CholeskyQR2
  (`fused_cholqr2_fn`) or the adaptive shifted CholeskyQR chain
  (`_cholqr_adaptive`), whose factor and pass-1-2 chain may run the
  factorization kernels of ops/pallas_factor.py (opt-in: NPW_PALLAS_FACTOR,
  NPW_PALLAS_CHAIN).

Cholesky's and GEMM's products go through `_matmul` / `_sub_matmul`, which
pick the kernel by precision and NpwConfig.compensated (see ops/common.py);
in compensated mode each Cholesky panel is packed once for all of its
trailing updates (`ops.gemm3.Panel`).
TSQR's builders take the reference's ``precision`` and map it onto two
routes (`_tsqr_matmul`): "high" in compensated mode is the matmul3 kernel
for a 2-D apply; every other product (the Grams, the batched tree
products, any other precision) is ``torch.matmul`` in true FP32, as the
JAX package's are ``jnp.matmul``. PyTorch runs eagerly: there is no jit,
what JAX expresses as buffer donation is an in-place write here, and the
TSQR chain's ``lax.cond`` / ``while_loop`` read their predicate on the
host (one read per factoring decision). The Cholesky factorization
overwrites the buffers it is given.

The tuning constants (panel_tiles=8, syrk_depth=3, leaf_rows=4096, the
inner tile of 128) were measured on a TPU and are kept until measured on
the GPU.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import torch

from numpywren_tpu_torch.config import default_config
from numpywren_tpu_torch.ops.common import cdiv, check_precision, default_precision
from numpywren_tpu_torch.ops.gemm import matmul as kernel_matmul
from numpywren_tpu_torch.ops.gemm3 import Panel, matmul3
from numpywren_tpu_torch.ops.pallas_factor import (
    chain_supported,
    cholqr2_chain_pallas,
    neumann_fold,
    potrf_inv_pallas,
)

_SPILL = "out-of-core spill (runtime/spill.py) is not ported yet (ROADMAP Queue 1 #1)"


def _dus(arr: torch.Tensor, update: torch.Tensor, i0: int, j0: int) -> torch.Tensor:
    """Write `update` into `arr` at (i0, j0), in place."""
    arr[i0:i0 + update.shape[0], j0:j0 + update.shape[1]].copy_(update)
    return arr


def _use_compensated(a: torch.Tensor, precision: str) -> bool:
    """The bf16x3 kernel (ops/gemm3.py) as the "high" backend, opted into by
    NpwConfig.compensated (BASELINE's "fp32 + compensated accumulation"
    mode). The gate is dtype, precision and config; the wrapper then picks
    kernel or plain version by the tensor's device."""
    return (a.dtype == torch.float32 and precision == "high"
            and default_config().compensated)


def _matmul(a, b, *, ta=False, tb=False, precision: str) -> torch.Tensor:
    """op(a) @ op(b): "high" is torch.matmul in true FP32, or the matmul3
    kernel in compensated mode; other precisions launch the matmul kernel."""
    if precision == "high":
        if not ta and _use_compensated(a, precision):
            return matmul3(a, b, tb=tb)
        return torch.matmul(a.T if ta else a, b.T if tb else b)
    return kernel_matmul(a, b, ta=ta, tb=tb, precision=precision)


def _tsqr_matmul(a, b, *, tb=False, precision: str) -> torch.Tensor:
    """a @ op(b) for the TSQR applies: the matmul3 kernel when
    `_use_compensated` holds, else torch.matmul in true FP32 (TSQR has no
    bf16 route, as `_matmul`'s "default" is)."""
    if _use_compensated(a, precision):
        return matmul3(a, b, tb=tb)
    return torch.matmul(a, b.T if tb else b)


def _sub_matmul(c, a, b, *, tb=False, precision: str,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """c - a @ op(b), the trailing-update shape, written into `out` when given
    (`out` may be `c`). Both kernels fuse the subtract into their epilogue."""
    if _use_compensated(a, precision):
        return matmul3(a, b, c, tb=tb, out=out)
    if precision != "high":
        return kernel_matmul(a, b, c, tb=tb, alpha=-1.0, beta=1.0,
                             precision=precision, out=out)
    rhs = b.T if tb else b
    if out is c:
        return c.addmm_(a, rhs, alpha=-1.0)
    if out is None:
        return torch.addmm(c, a, rhs, alpha=-1.0)
    return torch.addmm(c, a, rhs, alpha=-1.0, out=out)


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------

def _potrf(d: torch.Tensor, infos: List[torch.Tensor]) -> torch.Tensor:
    """Lower factor of the SPD block `d` (its lower triangle only). The
    status goes to `infos` and is checked once per factorization, so the
    host does not wait on the device after every panel."""
    ld, info = torch.linalg.cholesky_ex(d)
    infos.append(info)
    return ld


def _raise_if_not_spd(infos: List[torch.Tensor], what: str = "cholesky") -> None:
    if infos and bool((torch.stack(infos) != 0).any()):
        bad = next(p for p, i in enumerate(infos) if int(i) != 0)
        raise torch.linalg.LinAlgError(
            f"{what}: diagonal block of panel {bad} is not positive-definite "
            f"(leading minor of order {int(infos[bad])})")


def _rtrsm(b: torch.Tensor, l: torch.Tensor, tile: int, precision: str,
           inv_panel: bool = True) -> None:
    """b := b @ l⁻ᵀ in place, for lower-triangular l (w x w), recursively:
    half the flops per level land in one (rows x w/2) GEMM; tile-sized
    leaves multiply by the leaf's explicit inverse (the MAGMA trick) or,
    with inv_panel=False, solve against it."""
    w = l.shape[0]
    if w <= tile:
        if inv_panel:
            eye = torch.eye(w, dtype=l.dtype, device=l.device)
            winv = torch.linalg.solve_triangular(l, eye, upper=False)
            b.copy_(_matmul(b, winv, tb=True, precision=precision))
        else:
            b.copy_(torch.linalg.solve_triangular(l.T, b, upper=True, left=False))
        return
    h = (w // 2 + tile - 1) // tile * tile
    b1, b2 = b[:, :h], b[:, h:]
    _rtrsm(b1, l[:h, :h], tile, precision, inv_panel)
    _sub_matmul(b2, b1, l[h:, :h], tb=True, precision=precision, out=b2)
    _rtrsm(b2, l[h:, h:], tile, precision, inv_panel)


def _chol_columns(cols: List[torch.Tensor], panel: int, tile: int, precision: str,
                  stop: Optional[int] = None, inv_panel: bool = True) -> None:
    """Right-looking Cholesky over column-block buffers, in place.

    cols[c] holds rows [c*panel, n_pad) of columns [c*panel, c*panel + w_c):
    the trapezoid tier's own buffers, or views into one flat array. Panels
    [0, stop) are factored; later ones receive their trailing updates and
    keep the Schur complement (the reference's truncate prefix run)."""
    nb = len(cols)
    stop = nb if stop is None else min(int(stop), nb)
    infos: List[torch.Tensor] = []
    for p in range(stop):
        colp = cols[p]
        wp = colp.shape[1]
        ld = _potrf(colp[:wp], infos)
        colp[:wp].copy_(ld)  # ld's strict upper is zero: tril(ld)
        if colp.shape[0] <= wp:
            continue
        b = colp[wp:]
        _rtrsm(b, ld, tile, precision, inv_panel)
        # compensated: b is packed once for all of its updates, which write
        # only into later columns
        packed = Panel(b) if _use_compensated(b, precision) else None
        for c in range(p + 1, nb):
            off, w = (c - p - 1) * panel, cols[c].shape[1]
            if packed is not None:
                packed.sub_update(cols[c], off, w, out=cols[c])
            else:
                _sub_matmul(cols[c], b[off:], b[off:off + w], tb=True, precision=precision,
                            out=cols[c])
    _raise_if_not_spd(infos)


def _syrk_tril(a, pan, r1, j0, rows, depth, tile, precision, leaf_rows) -> None:
    """In-place a[j0:j0+rows, j0:j0+rows] -= P Pᵀ restricted to the (block)
    lower triangle, recursively: the off-diagonal rectangle is ONE GEMM, the
    two diagonal halves recurse; leaves compute their full square.

    Splits land on tile boundaries: a split through a diagonal tile would
    leave stale upper-triangle values inside a tile a later potrf reads."""
    if depth == 0 or rows <= leaf_rows:
        p = pan[j0 - r1:j0 - r1 + rows]
        s = a[j0:j0 + rows, j0:j0 + rows]
        _sub_matmul(s, p, p, tb=True, precision=precision, out=s)
        return
    h = (rows // 2 + tile - 1) // tile * tile
    p1 = pan[j0 - r1:j0 - r1 + h]
    p2 = pan[j0 - r1 + h:j0 - r1 + rows]
    s21 = a[j0 + h:j0 + rows, j0:j0 + h]
    _sub_matmul(s21, p2, p1, tb=True, precision=precision, out=s21)
    _syrk_tril(a, pan, r1, j0, h, depth - 1, tile, precision, leaf_rows)
    _syrk_tril(a, pan, r1, j0 + h, rows - h, depth - 1, tile, precision, leaf_rows)


def fused_cholesky_fn(
    n_pad: int,
    tile: int,
    *,
    truncate: int = 0,
    panel_tiles: int = 8,
    syrk_depth: int = 3,
    leaf_rows: int = 4096,
    inv_panel: bool = True,
    precision: Optional[str] = None,
    dtype=torch.float32,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the in-place blocked Cholesky over a flat padded (n_pad, n_pad)
    tensor: fn(a) factors `a` where it lies and returns it.

    With truncate == 0 (chol_cols) the super-panels of W = panel_tiles*tile
    columns are column views of `a`, run through the same schedule as the
    trapezoid tier, and `a` comes back as the lower factor (upper zeroed).
    With truncate > 0 (chol_flat) the first g - truncate tile columns are
    factored with a recursive lower-only trailing syrk, and `a` comes back
    holding the factored panels and the updated Schur complement."""
    if n_pad % tile != 0:
        raise ValueError(f"n_pad {n_pad} not a multiple of tile {tile}")
    g = n_pad // tile
    n_done = (g - truncate) * tile
    w_max = max(1, panel_tiles) * tile
    precision = check_precision(precision or default_precision(dtype))

    def chol_flat(a):
        infos: List[torch.Tensor] = []
        for p0 in range(0, n_done, w_max):
            pw = min(w_max, n_done - p0)
            ld = _potrf(a[p0:p0 + pw, p0:p0 + pw], infos)
            _dus(a, ld, p0, p0)
            rem = n_pad - (p0 + pw)
            if rem == 0:
                continue
            b = a[p0 + pw:, p0:p0 + pw]
            _rtrsm(b, ld, tile, precision, inv_panel)
            _syrk_tril(a, b, p0 + pw, p0 + pw, rem, syrk_depth, tile, precision,
                       leaf_rows)
        _raise_if_not_spd(infos)
        return a.tril_() if truncate == 0 else a

    def chol_cols(a):
        nb = cdiv(n_pad, w_max)
        cols = [a[c * w_max:, c * w_max:min(n_pad, (c + 1) * w_max)] for c in range(nb)]
        _chol_columns(cols, w_max, tile, precision, inv_panel=inv_panel)
        return a.tril_()

    return chol_flat if truncate else chol_cols


def fused_cholesky(a: torch.Tensor, tile: int, *, truncate: int = 0,
                   panel_tiles: int = 8, syrk_depth: int = 3,
                   leaf_rows: int = 4096, inv_panel: bool = True,
                   precision: Optional[str] = None) -> torch.Tensor:
    """One-call fused Cholesky on a flat padded tensor. Overwrites `a` with
    the result and returns it (JAX's donation, done in place)."""
    fn = fused_cholesky_fn(a.shape[0], tile, truncate=truncate,
                           panel_tiles=panel_tiles, syrk_depth=syrk_depth,
                           leaf_rows=leaf_rows, inv_panel=inv_panel,
                           precision=precision, dtype=a.dtype)
    return fn(a)


# ---------------------------------------------------------------------------
# TSQR: the adaptive shifted CholeskyQR chain
# ---------------------------------------------------------------------------

def _flag(name: str) -> bool:
    """An opt-in read at each call: NPW_PALLAS_FACTOR, NPW_PALLAS_CHAIN,
    NPW_GEMM_INV (the JAX package's names and default, off)."""
    return os.environ.get(name, "0") == "1"


def _trtri_gemm(l: torch.Tensor) -> torch.Tensor:
    """Exact lower-triangular inverse by nilpotent Neumann doubling, GEMMs
    only. L = D (I + N), N strictly lower (nilpotent of index b):
    (I + N)⁻¹ = Σ_{k<b} (-N)^k by ceil(log2 b) doubling steps
    S <- S + P S, P <- P², then one Newton polish X <- X + X (I - L X)."""
    b = l.shape[0]
    eye = torch.eye(b, dtype=l.dtype, device=l.device)
    dinv = 1.0 / torch.diagonal(l)
    n_ = l * dinv[:, None] - eye          # strictly lower, nilpotent
    s = eye - n_                           # Σ_{k<2}
    p = n_ @ n_                            # (-N)²
    for _ in range(max((b - 1).bit_length() - 1, 0)):  # 2^(1+steps) >= b
        s = s + p @ s
        p = p @ p
    linv = s * dinv[None, :]               # (I+N)⁻¹ D⁻¹
    return linv + linv @ (eye - l @ linv)


def _cholqr_adaptive(p: torch.Tensor, rows: bool = False, max_passes: int = 16,
                     pallas_chain: Optional[bool] = None, precision: str = "high"):
    """Adaptive CholeskyQR chain: thin QR (rows=False: p = q r, r upper
    b x b) or thin LQ (rows=True: p = l q, l lower b x b) of p by repeated
    Gram-Cholesky passes with shift-on-breakdown.

    Passes 1-2 are CholeskyQR2 with ONE big Gram and ONE big apply: pass 1
    factors G + 4 u sqrt(m b) ||G||_inf I (positive definite by
    construction, no pivot test), pass 2's Gram comes analytically from
    pass 1's (G2 = L1⁻¹ G L1⁻ᵀ), and pass 2 is the first-order Neumann
    cleanup when max|G2 - I| < 0.1, else a shifted factor. The two inverses
    fold into one b x b transform applied to p. Then up to max_passes - 2
    real-Gram passes run until CONVERGED (a pass whose input deviation is
    below conv_gate = 2 sqrt(1e-4) lands under 1e-4).

    Opt-ins, read at each call: NPW_PALLAS_FACTOR=1 factors each shifted
    pass with the potrf_inv kernel (its input 0.5 (Gs + Gsᵀ)); on a CPU
    tensor the wrapper runs its plain version. NPW_PALLAS_CHAIN=1 (or
    pallas_chain=True) runs passes 1-2 as the chain kernel's launch sequence
    inside its envelope (its input G1 unsymmetrized); NPW_GEMM_INV=1 swaps
    the library triangular solve for _trtri_gemm.

    Host reads: the library route reads dev2 once (the fold and the
    convergence flag); the chain reads its conv flag once; each extras
    pass reads its Gram's deviation once.

    precision routes the applies of the inverse to the tall operand
    (`_tsqr_matmul`); the Grams and the b x b algebra stay true FP32, the
    reference's HIGHEST smalls."""
    b = p.shape[0] if rows else p.shape[1]
    m = p.shape[1] if rows else p.shape[0]
    eye = torch.eye(b, dtype=p.dtype, device=p.device)
    u = torch.finfo(torch.float32).eps
    shift_c = 4.0 * u * (m * b) ** 0.5
    conv_gate = 2.0 * 1e-4 ** 0.5
    if pallas_chain is None:
        pallas_chain = _flag("NPW_PALLAS_CHAIN")

    def gram_dev(x):
        g = x @ x.T if rows else x.T @ x
        e = g - eye
        return g, e, torch.max(torch.abs(e))

    def shifted_linv(g, extra_floor=0.0):
        """Always-shifted factor and its explicit b x b inverse."""
        floor = shift_c * torch.max(torch.sum(torch.abs(g), dim=1)) + extra_floor
        gs = g + floor * eye
        sym = 0.5 * (gs + gs.T)
        if _flag("NPW_PALLAS_FACTOR"):
            return potrf_inv_pallas(sym)
        l = torch.linalg.cholesky_ex(sym)[0]
        if _flag("NPW_GEMM_INV"):
            return l, _trtri_gemm(l)
        return l, torch.linalg.solve_triangular(l, eye, upper=False)

    def apply_linv(x, linv):
        if rows:
            return _tsqr_matmul(linv, x, precision=precision)
        return _tsqr_matmul(x, linv, tb=True, precision=precision)

    def iterate_pass(x):
        """Extras pass: cleanup in the near-orthonormal regime, a full
        shifted factor otherwise; one host read of the deviation."""
        g, e, dev = gram_dev(x)
        dev = float(dev)
        l, linv = neumann_fold(e) if dev < 1e-1 else shifted_linv(g)
        return apply_linv(x, linv), l, dev < conv_gate

    # incremental composition of R: rows form p = L1 L2 ... q folds on the
    # right; column form p = q (Lkᵀ ... L1ᵀ) folds on the left
    if rows:
        def fold(total, li):
            return total @ li
    else:
        def fold(total, li):
            return li.T @ total

    g1, _, _ = gram_dev(p)
    if pallas_chain and chain_supported(m, b, p.dtype):
        q, total, conv, _ = cholqr2_chain_pallas(
            g1, p, rows=rows, shift_c=float(shift_c), conv_gate=float(conv_gate),
            precision=precision)
    else:
        l1, linv1 = shifted_linv(g1)
        g2 = (linv1 @ g1) @ linv1.T
        e2 = g2 - eye
        dev2 = torch.max(torch.abs(e2))
        # the analytic G2 is not a real Gram: its roundoff can push a
        # near-singular G2 indefinite, so a shifted pass 2 shifts past it
        rb1 = torch.max(torch.sum(torch.abs(linv1), dim=1))
        err2 = 3.0 * u * rb1 * rb1 * torch.max(torch.sum(torch.abs(g1), dim=1))
        dev2 = float(dev2)
        l2, linv2 = neumann_fold(e2) if dev2 < 1e-1 else shifted_linv(g2, err2)
        # converged only via the cleanup branch (a shifted pass 2 carries
        # the err2-inflated shift; the extras correct it)
        conv = dev2 < conv_gate
        q = apply_linv(p, linv2 @ linv1)
        total = fold(l1, l2) if rows else fold(l1.T, l2)

    for _ in range(max(max_passes - 2, 0)):
        if bool(conv):
            break
        q, li, conv = iterate_pass(q)
        total = fold(total, li)
    return q, total


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

def fused_gemm(a: torch.Tensor, b: torch.Tensor, *,
               precision: Optional[str] = None) -> torch.Tensor:
    """a @ b in one product, routed by precision and config (`_matmul`)."""
    return _matmul(a, b, precision=check_precision(precision or default_precision(a.dtype)))


# ---------------------------------------------------------------------------
# TSQR
# ---------------------------------------------------------------------------

def fused_cholqr2_fn(compute_q: bool = False, precision: Optional[str] = None,
                     dtype=torch.float32) -> Callable:
    """CholeskyQR2: two Gram + Cholesky + apply passes; needs kappa(A) well
    below 1/sqrt(eps). fn(a) -> R (or (Q, R)) for a tall (m, b) tensor.
    precision (None: dtype's default) routes the applies and R's product
    (`_tsqr_matmul`)."""
    precision = check_precision(default_precision(dtype) if precision is None else precision)

    def one_pass(x):
        g = x.T @ x
        l = torch.linalg.cholesky_ex(g)[0]  # the lower triangle only
        eye = torch.eye(l.shape[0], dtype=x.dtype, device=x.device)
        w = torch.linalg.solve_triangular(l, eye, upper=False)
        return _tsqr_matmul(x, w, tb=True, precision=precision), l  # X L⁻ᵀ

    def f(a):
        q1, l1 = one_pass(a)
        q2, l2 = one_pass(q1)
        r = _tsqr_matmul(l2.T, l1, tb=True, precision=precision)  # R = R2 R1
        return (q2, r) if compute_q else r

    return f


def fused_cholqr3s_fn(compute_q: bool = False, precision: Optional[str] = None,
                      dtype=torch.float32) -> Callable:
    """Shifted CholeskyQR3 (Fukaya et al., SISC 2020) through
    _cholqr_adaptive: the fast robust tall-skinny QR. precision (None:
    dtype's default) reaches the chain's applies."""
    precision = check_precision(default_precision(dtype) if precision is None else precision)

    def f(a):
        q, r = _cholqr_adaptive(a, rows=False, precision=precision)
        return (q, r) if compute_q else r

    return f


def fused_tsqr_fn(n_leaves: int, tile_rows: int, b: int, *, b_fac: int = 2,
                  compute_q: bool = False, precision: Optional[str] = None,
                  dtype=torch.float32) -> Callable:
    """TSQR over the (n_leaves*tile_rows, b) flat tensor: batched leaf QRs,
    then a b_fac-ary combine tree whose levels are batched QRs of stacked
    R groups (the DSL `reducer` tree). A lone tail block passes through; a
    ragged tail group is zero-padded (QR of [Rs; 0] has the same R).
    fn(a) -> R, or (Q, R) with Q rebuilt by the downward sweep.

    precision (None: dtype's default) is checked as the reference's is; the
    tree's products are batched, which the compensated kernel does not
    take, so every precision runs them in true FP32."""
    precision = check_precision(default_precision(dtype) if precision is None else precision)
    if b_fac < 2:
        raise ValueError(f"b_fac must be >= 2, got {b_fac}")

    def tsqr(a):
        stack = a.reshape(n_leaves, tile_rows, b)
        q0, r = torch.linalg.qr(stack, mode="reduced")  # batched leaf QR
        levels = []  # (q, m_in, tail) per level for the downward sweep
        m = n_leaves
        while m > 1:
            full = m // b_fac
            rem = m - full * b_fac
            if rem == 1:
                body, tail = r[: full * b_fac], 1
            elif rem == 0:
                body, tail = r, 0
            else:  # ragged group: zero-pad to a full stack
                pad = torch.zeros((b_fac - rem, b, b), dtype=r.dtype, device=r.device)
                body, tail = torch.cat([r, pad], dim=0), 0
            g = body.shape[0] // b_fac
            q, r2 = torch.linalg.qr(body.reshape(g, b_fac * b, b), mode="reduced")
            if tail:
                r2 = torch.cat([r2, r[full * b_fac:]], dim=0)
            levels.append((q, m, tail))
            r = r2
            m = g + tail
        r_final = r[0]
        if not compute_q:
            return r_final
        # Z maps each leaf's local basis to the global one
        z = torch.eye(b, dtype=a.dtype, device=a.device)[None]
        for q, m_in, tail in reversed(levels):
            g = q.shape[0]
            z_child = (q @ z[:g]).reshape(g * b_fac, b, b)[: m_in - tail]
            z = torch.cat([z_child, z[g:]], dim=0) if tail else z_child
        return (q0 @ z).reshape(n_leaves * tile_rows, b), r_final

    return tsqr


def fused_tsqr(a: torch.Tensor, tile_rows: int, *, compute_q: bool = False,
               precision: Optional[str] = None, method: str = "tree", b_fac: int = 2):
    """Tall-skinny QR: method "cholqr2" (two GEMM passes, moderate kappa),
    "cholqr3s" (the adaptive shifted chain, kappa up to ~1/eps) or "tree"
    (the Householder combine tree, unconditionally stable). b_fac is the
    tree's branching factor; precision (None: a's dtype default) goes to
    the method's builder."""
    m, b = a.shape
    if m % tile_rows != 0:
        raise ValueError(f"rows {m} not a multiple of tile_rows {tile_rows}")
    kw = dict(compute_q=compute_q, precision=precision, dtype=a.dtype)
    if method == "cholqr2":
        fn = fused_cholqr2_fn(**kw)
    elif method == "cholqr3s":
        fn = fused_cholqr3s_fn(**kw)
    elif method == "tree":
        fn = fused_tsqr_fn(m // tile_rows, tile_rows, b, b_fac=b_fac, **kw)
    else:
        raise ValueError(f"unknown tsqr method {method!r}")
    return fn(a)


# ---------------------------------------------------------------------------
# Program-level dispatch
# ---------------------------------------------------------------------------

def lower_fused(program) -> Optional[Callable[[], None]]:
    """A no-arg callable running `program` through its fused lowering and
    committing the results into its bound matrices; None when the program's
    template has no fused specialization in the port (cholesky, gemm and
    the tsqr family have)."""
    name = program.dag.template.name
    if name == "cholesky":
        inner = lambda: _run_fused_cholesky(program)  # noqa: E731
    elif name == "gemm":
        inner = lambda: _run_fused_gemm(program)  # noqa: E731
    elif name in ("tsqr", "tsqr_q") or name.startswith("tsqr_b"):
        inner = lambda: _run_fused_tsqr(program, compute_q=(name == "tsqr_q"))  # noqa: E731
    else:
        return None

    def run_and_commit():
        """The runners promote host-tier operands to device-tier copies; the
        caller's handles must still see the results (the reference's
        semantics: writes land in the store the program was bound to), so
        computed blocks are copied back and the handles restored."""
        originals = {nm: ba.matrix for nm, ba in program.matrices.items()}
        inner()
        for nm, orig in originals.items():
            cur = program.matrices[nm].matrix
            if cur is orig or orig.storage in ("hbm", "trapezoid"):
                continue
            for (i, j) in cur.block_idxs_exist:
                orig.put_block(cur.get_block(i, j), i, j)
            program.matrices[nm].matrix = orig

    return run_and_commit


def _hbm_budget_bytes() -> int:
    """Usable device memory (config.spill_threshold of the card's total);
    unbounded when there is no CUDA device."""
    cfg = default_config()
    if cfg.hbm_budget_bytes:
        return int(cfg.hbm_budget_bytes * cfg.spill_threshold)
    if torch.cuda.is_available():
        _, total = torch.cuda.mem_get_info()
        return int(total * cfg.spill_threshold)
    return 1 << 62


def _hbm(program, name):
    """The bound matrix on the flat device tier, promoted if it is not."""
    ba = program.matrices[name]
    if ba.matrix.storage != "hbm":
        ba.matrix = ba.matrix.to_hbm()
    return ba.matrix


def _spill_if_over_budget(program, factor: int = 2, names=None) -> bool:
    """Host-tier operands whose wholesale promotion would exceed the
    device-memory budget run through the streaming SpillTaskExecutor
    instead. Returns True when the program ran that way. `names`: the
    matrices the fused runner would promote (default: all); scratch it never
    touches (gemm's chunk partials) does not count."""
    total, any_host = 0, False
    for nm, ba in program.matrices.items():
        if names is not None and nm not in names:
            continue
        m = ba.matrix
        pm, pn = m.padded_shape
        total += pm * pn * m.dtype.itemsize
        any_host = any_host or m.storage != "hbm"
    if any_host and factor * total > _hbm_budget_bytes():
        from numpywren_tpu_torch.runtime.executor import SpillTaskExecutor

        SpillTaskExecutor(program).run()
        return True
    return False


def _run_fused_cholesky(program):
    s_ba = program.matrices["S"]
    truncate = program.consts.get("truncate", 0)
    # trapezoid tier: factor the column buffers where they lie
    if s_ba.matrix.storage == "trapezoid":
        from numpywren_tpu_torch.trapezoid import cholesky_trapezoid

        s_m = s_ba.matrix
        o_m = program.matrices["O"].matrix
        if truncate == 0:
            o_m.adopt(cholesky_trapezoid(s_m.trap))
        else:
            # prefix run: factored panels and the updated Schur complement
            # share O's buffers; only the factored tile columns count as
            # computed (the bind step checked panel alignment)
            done_tiles = s_m.grid[0] - truncate
            stop = (done_tiles * s_m.tile[0]) // s_m.trap.panel
            o_m.adopt(cholesky_trapezoid(s_m.trap, stop_panels=stop),
                      written_tile_cols=done_tiles)
        s_m.free()  # its buffers now belong to O
        return
    if s_ba.matrix.storage == "host" and truncate == 0:
        # the fused factorization holds ~3 flat copies on the card; a host
        # matrix too large for that streams out of core in the reference
        # (runtime.spill.out_of_core_cholesky), which the port has not yet
        m = s_ba.matrix
        pm, pn = m.padded_shape
        if 3 * pm * pn * m.dtype.itemsize > _hbm_budget_bytes():
            raise NotImplementedError(f"cholesky of a {pm}x{pn} host matrix: {_SPILL}")

    s = _hbm(program, "S")
    o = _hbm(program, "O")
    # the lowering's blocking is independent of the storage tile: 128
    # whenever it divides the padded size
    n_pad = s.padded_shape[0]
    inner = 128 if n_pad % 128 == 0 and truncate == 0 else s.tile[0]
    l = fused_cholesky(s.array, inner, truncate=truncate)
    if truncate == 0:
        o.replace_array(l)
        s.free()
        return
    # prefix run: factored panels go to O, the trailing matrix stays in S
    n_done = (s.grid[0] - truncate) * s.tile[0]
    o_arr = torch.zeros_like(l)
    o_arr[:, :n_done] = torch.tril(l[:, :n_done])
    o.replace_array(o_arr)
    l[:, :n_done] = 0
    s.replace_array(l)


def _run_fused_gemm(program):
    if _spill_if_over_budget(program, names=("A", "B", "C")):
        return
    a = _hbm(program, "A")
    b = _hbm(program, "B")
    c = _hbm(program, "C")
    c.replace_array(fused_gemm(a.array, b.array).to(c.dtype))
    # the chunk-partials scratch exists for the generic executor only
    p = program.matrices.get("P")
    if p is not None:
        p.matrix.free()


def _run_fused_tsqr(program, compute_q: bool):
    if _spill_if_over_budget(program):
        return
    a = _hbm(program, "A")
    r_mat = _hbm(program, "R")
    n_leaves = program.consts["N"]
    depth = program.consts["L"]
    tile_rows, b = a.tile
    opts = getattr(program, "fused_options", {})
    arr = a.array[: n_leaves * tile_rows, :b]
    out = fused_tsqr(arr, tile_rows, compute_q=compute_q,
                     method=opts.get("tsqr_method", "tree"), b_fac=opts.get("b_fac", 2))
    if compute_q:
        q_arr, r_final = out
        q_mat = _hbm(program, "Q")
        pad = torch.zeros(q_mat.padded_shape, dtype=q_mat.dtype, device=q_arr.device)
        pad[: q_arr.shape[0], : q_arr.shape[1]] = q_arr
        q_mat.replace_array(pad)
    else:
        r_final = out
    # the final R lives at block (0, depth) of R (algs.tsqr layout)
    r_mat.put_block(r_final.to(r_mat.dtype), 0, depth)
