"""Region-fused lowering of DSL programs, on PyTorch tensors.

Counterpart of numpywren_tpu/compiler/lower.py for Cholesky, GEMM, TSQR and
BDFAC. The store keeps a matrix as ONE padded tensor, so a panel or a
trailing region is a strided view:

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
- BDFAC (`fused_bdfac_fn`) sweeps QR panels down the columns and LQ panels
  along the rows, by that chain and Yamamoto reflectors or by geqrf and
  compact-WY, updating the trailing views in place; its large products go
  through `_matmul` / `_sub_matmul`.

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
from numpywren_tpu_torch.metrics import span
from numpywren_tpu_torch.ops.common import cdiv, check_precision, default_precision
from numpywren_tpu_torch.ops.gemm import matmul as kernel_matmul
from numpywren_tpu_torch.ops.gemm3 import Panel, matmul3
from numpywren_tpu_torch.ops.pallas_factor import (
    chain_supported,
    cholqr2_chain_pallas,
    neumann_fold,
    potrf_inv_pallas,
)


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
    if not infos:
        return
    with span("host_read"):
        failed = bool((torch.stack(infos) != 0).any())
    if failed:
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
                  stop: Optional[int] = None, inv_panel: bool = True,
                  infos: Optional[List[torch.Tensor]] = None) -> None:
    """Right-looking Cholesky over column-block buffers, in place.

    cols[c] holds rows [c*panel, n_pad) of columns [c*panel, c*panel + w_c):
    the trapezoid tier's own buffers, or views into one flat array. Panels
    [0, stop) are factored; later ones receive their trailing updates and
    keep the Schur complement (the reference's truncate prefix run). With
    `infos`, the diagonal blocks' factor statuses are appended to it for the
    caller to check (`_raise_if_not_spd`); else they are checked here, which
    waits for the device."""
    nb = len(cols)
    stop = nb if stop is None else min(int(stop), nb)
    check = infos is None
    infos = [] if infos is None else infos
    for p in range(stop):
        colp = cols[p]
        wp = colp.shape[1]
        with span("chol.factor"):
            ld = _potrf(colp[:wp], infos)
            colp[:wp].copy_(ld)  # ld's strict upper is zero: tril(ld)
        if colp.shape[0] <= wp:
            continue
        b = colp[wp:]
        with span("chol.solve"):
            _rtrsm(b, ld, tile, precision, inv_panel)
        with span("chol.update"):
            # compensated: b is packed once for all of its updates, which
            # write only into later columns
            packed = Panel(b) if _use_compensated(b, precision) else None
            for c in range(p + 1, nb):
                off, w = (c - p - 1) * panel, cols[c].shape[1]
                if packed is not None:
                    packed.sub_update(cols[c], off, w, out=cols[c])
                else:
                    _sub_matmul(cols[c], b[off:], b[off:off + w], tb=True,
                                precision=precision, out=cols[c])
    if check:
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
    infos: Optional[List[torch.Tensor]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the in-place blocked Cholesky over a flat padded (n_pad, n_pad)
    tensor: fn(a) factors `a` where it lies and returns it.

    With truncate == 0 (chol_cols) the super-panels of W = panel_tiles*tile
    columns are column views of `a`, run through the same schedule as the
    trapezoid tier, and `a` comes back as the lower factor (upper zeroed).
    With truncate > 0 (chol_flat) the first g - truncate tile columns are
    factored with a recursive lower-only trailing syrk, and `a` comes back
    holding the factored panels and the updated Schur complement. `infos`
    as in `_chol_columns` (the column schedule only)."""
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
        _chol_columns(cols, w_max, tile, precision, inv_panel=inv_panel, infos=infos)
        return a.tril_()

    return chol_flat if truncate else chol_cols


def fused_cholesky(a: torch.Tensor, tile: int, *, truncate: int = 0,
                   panel_tiles: int = 8, syrk_depth: int = 3,
                   leaf_rows: int = 4096, inv_panel: bool = True,
                   precision: Optional[str] = None,
                   infos: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """One-call fused Cholesky on a flat padded tensor. Overwrites `a` with
    the result and returns it (JAX's donation, done in place). `infos` as in
    `_chol_columns`: the out-of-core Cholesky checks its panels' statuses
    in its writer thread, off the factor loop."""
    fn = fused_cholesky_fn(a.shape[0], tile, truncate=truncate,
                           panel_tiles=panel_tiles, syrk_depth=syrk_depth,
                           leaf_rows=leaf_rows, inv_panel=inv_panel,
                           precision=precision, dtype=a.dtype, infos=infos)
    return fn(a)


# ---------------------------------------------------------------------------
# TSQR: the adaptive shifted CholeskyQR chain
# ---------------------------------------------------------------------------

def _flag(name: str) -> bool:
    """An opt-in read at each call: NPW_PALLAS_FACTOR, NPW_PALLAS_CHAIN,
    NPW_GEMM_INV (the JAX package's names and default, off)."""
    return os.environ.get(name, "0") == "1"


def _cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower factor of the SPD `a` (its lower triangle); where the
    factorization fails, a lower triangle of NaN, as JAX's cholesky
    returns (cholesky_ex leaves a finite partial factor). No host read."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, l, torch.tril(torch.full_like(l, float("nan"))))


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


# the chains `_cholqr_adaptive` ran and their extras passes, counted where
# they run (host counters; `reset_chain_passes` sets them to 0)
CHAIN_PASSES = {"chains": 0, "extras": 0}


def reset_chain_passes() -> None:
    for k in CHAIN_PASSES:
        CHAIN_PASSES[k] = 0


def _cholqr_adaptive(p: torch.Tensor, rows: bool = False, max_passes: int = 16,
                     pallas_chain: Optional[bool] = None, precision: str = "high",
                     conv_tol: float = 1e-4, gemm_inv: Optional[bool] = None,
                     psum_mesh=None, global_m: Optional[int] = None):
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
    below conv_gate = min(2 sqrt(conv_tol), 0.1) lands under conv_tol; the
    fused BDFAC passes 1e-5).

    Opt-ins, read at each call: NPW_PALLAS_FACTOR=1 factors each shifted
    pass with the potrf_inv kernel (its input 0.5 (Gs + Gsᵀ)); on a CPU
    tensor the wrapper runs its plain version. NPW_PALLAS_CHAIN=1 (or
    pallas_chain=True) runs passes 1-2 as the chain kernel's launch sequence
    inside its envelope (its input G1 unsymmetrized); NPW_GEMM_INV=1 (or
    gemm_inv=True) swaps the library triangular solve for _trtri_gemm. A
    library factor that fails comes out NaN, as JAX's cholesky does, with
    no host read.

    Host reads: the library route reads dev2 once (the fold and the
    convergence flag); the chain reads its conv flag once; each extras
    pass reads its Gram's deviation once. CHAIN_PASSES counts the calls
    and the extras passes. Spans (metrics.span): the call is `tsqr.chain`,
    each host read `host_read`, each Gram `chain.gram`, the b x b factors
    and folds `chain.factor`, each apply `chain.apply`, each extras pass
    `chain.extra`.

    precision routes the applies of the inverse to the tall operand
    (`_tsqr_matmul`); the Grams and the b x b algebra stay true FP32, the
    reference's HIGHEST smalls.

    psum_mesh (a DeviceMesh; the reference's psum_axes): `p` is this rank's
    shard along the non-b axis, and every real Gram is all_reduced over the
    mesh (`sum_over_mesh`); global_m is then the operand's true height, for
    the shift. The chain kernel is off there. Every host read takes the
    value of the mesh's first rank (one broadcast), so every rank takes the
    same branches and the same number of extras passes, and so enters the
    same all_reduces, whatever bits the all_reduce gave each rank."""
    with span("tsqr.chain"):
        b = p.shape[0] if rows else p.shape[1]
        m_loc = p.shape[1] if rows else p.shape[0]
        m = global_m if global_m is not None else m_loc
        eye = torch.eye(b, dtype=p.dtype, device=p.device)
        u = torch.finfo(torch.float32).eps
        shift_c = 4.0 * u * (m * b) ** 0.5
        conv_gate = min(2.0 * float(conv_tol) ** 0.5, 1e-1)
        if pallas_chain is None:
            pallas_chain = _flag("NPW_PALLAS_CHAIN")
        if gemm_inv is None:
            gemm_inv = _flag("NPW_GEMM_INV")

        if psum_mesh is not None:
            from numpywren_tpu_torch.parallel.mesh import broadcast_flat, sum_over_mesh

        def host(v) -> float:
            """One host read of the 0-d `v`: over a mesh, the first rank's."""
            with span("host_read"):
                if psum_mesh is not None:
                    v = broadcast_flat(v.reshape(1).clone(), 0, psum_mesh)
                return float(v)

        def gram_dev(x):
            with span("chain.gram"):
                g = x @ x.T if rows else x.T @ x
                if psum_mesh is not None:
                    sum_over_mesh(g, psum_mesh)
                e = g - eye
                return g, e, torch.max(torch.abs(e))

        def shifted_linv(g, extra_floor=0.0):
            """Always-shifted factor and its explicit b x b inverse."""
            floor = shift_c * torch.max(torch.sum(torch.abs(g), dim=1)) + extra_floor
            gs = g + floor * eye
            sym = 0.5 * (gs + gs.T)
            if _flag("NPW_PALLAS_FACTOR"):
                return potrf_inv_pallas(sym)
            l = _cholesky_nan(sym)
            if gemm_inv:
                return l, _trtri_gemm(l)
            return l, torch.linalg.solve_triangular(l, eye, upper=False)

        def apply_linv(x, linv):
            with span("chain.apply"):
                if rows:
                    return _tsqr_matmul(linv, x, precision=precision)
                return _tsqr_matmul(x, linv, tb=True, precision=precision)

        def iterate_pass(x):
            """Extras pass: cleanup in the near-orthonormal regime, a full
            shifted factor otherwise; one host read of the deviation."""
            g, e, dev = gram_dev(x)
            dev = host(dev)
            with span("chain.factor"):
                l, linv = neumann_fold(e) if dev < 1e-1 else shifted_linv(g)
            return apply_linv(x, linv), l, dev < conv_gate

        # incremental composition of R: rows form p = L1 L2 ... q folds on
        # the right; column form p = q (Lkᵀ ... L1ᵀ) folds on the left
        if rows:
            def fold(total, li):
                return total @ li
        else:
            def fold(total, li):
                return li.T @ total

        CHAIN_PASSES["chains"] += 1
        g1, _, _ = gram_dev(p)
        if pallas_chain and psum_mesh is None and chain_supported(m_loc, b, p.dtype):
            q, total, conv, _ = cholqr2_chain_pallas(
                g1, p, rows=rows, shift_c=float(shift_c), conv_gate=float(conv_gate),
                precision=precision)
        else:
            with span("chain.factor"):
                l1, linv1 = shifted_linv(g1)
                g2 = (linv1 @ g1) @ linv1.T
                e2 = g2 - eye
                dev2 = torch.max(torch.abs(e2))
                # the analytic G2 is not a real Gram: its roundoff can push
                # a near-singular G2 indefinite, so a shifted pass 2 shifts
                # past it
                rb1 = torch.max(torch.sum(torch.abs(linv1), dim=1))
                err2 = 3.0 * u * rb1 * rb1 * torch.max(torch.sum(torch.abs(g1), dim=1))
            dev2 = host(dev2)
            with span("chain.factor"):
                l2, linv2 = neumann_fold(e2) if dev2 < 1e-1 else shifted_linv(g2, err2)
                # converged only via the cleanup branch (a shifted pass 2
                # carries the err2-inflated shift; the extras correct it)
                conv = dev2 < conv_gate
                linv = linv2 @ linv1
                total = fold(l1, l2) if rows else fold(l1.T, l2)
            q = apply_linv(p, linv)

        for _ in range(max(max_passes - 2, 0)):
            if isinstance(conv, torch.Tensor):  # the chain kernel's flag, on the device
                with span("host_read"):
                    conv = bool(conv)
            if conv:
                break
            CHAIN_PASSES["extras"] += 1
            with span("chain.extra"):
                q, li, conv = iterate_pass(q)
                total = fold(total, li)
        return q, total


# ---------------------------------------------------------------------------
# BDFAC (block bidiagonalization)
# ---------------------------------------------------------------------------
#
# The panel updates' large products go through `_matmul` / `_sub_matmul` at
# the sweep's precision (compensated "high": matmul3; "highest" and
# "default": matmul; plain "high": torch.matmul, true FP32; a transposed
# left operand is torch.matmul in compensated mode, as in Cholesky). The
# b x b algebra (folds, `_small_inv_t`, `_ns_inv`, the Neumann series,
# `_wy_t`'s Gram) is torch.matmul in true FP32 at every precision: the
# reference runs it at HIGH under BDFAC, so the port is the more accurate
# there, and the helpers that do only b x b algebra take no precision (the
# reference's `small_precision` has no counterpart). The sweeps update the
# input's trailing views in place.


def _geqrf(panel: torch.Tensor):
    """Householder QR: V in the lower trapezoid of the first result, the
    taus in the second (LAPACK's geqrf, torch.geqrf)."""
    return torch.geqrf(panel)


def _wy_t(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Compact-WY block reflector: upper-triangular T with Q = I - V T Vᵀ
    for unit-lower-trapezoidal V and Householder taus, from
    T⁻¹ = diag(1/tau) + striu(Vᵀ V) by one triangular solve (a zero tau
    gets 1e30 on the diagonal, so its column of T is 0)."""
    g = v.T @ v
    nz = tau != 0
    dinv = torch.where(nz, 1.0 / torch.where(nz, tau, torch.ones_like(tau)),
                       torch.full_like(tau, 1e30))
    m = torch.triu(g, 1) + torch.diag(dinv)
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    return torch.linalg.solve_triangular(m, eye, upper=True)


def _row_major(t: torch.Tensor) -> bool:
    return t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1)


def _apply_wy_left(v, t, trailing, precision: str) -> None:
    """trailing := (I - V T Vᵀ)ᵀ trailing, in place: two large products
    (Vᵀ trailing, then the subtract) and one narrow one (Tᵀ W1). A
    transposed view (the Householder LQ's bodyᵀ) is updated through its
    row-major transpose, with the products mirrored, so it is never
    materialized."""
    if _row_major(trailing) or not _row_major(trailing.T):
        w1 = _matmul(v, trailing, ta=True, precision=precision)       # (b, c)
        w2 = _matmul(t, w1, ta=True, precision=precision)             # (b, c)
        _sub_matmul(trailing, v, w2, precision=precision, out=trailing)
        return
    tr = trailing.T                                                  # (c, rows)
    w1t = _matmul(tr, v, precision=precision)                        # W1ᵀ (c, b)
    w2t = _matmul(w1t, t, precision=precision)                       # W2ᵀ = W1ᵀ T
    _sub_matmul(tr, w2t, v, tb=True, precision=precision, out=tr)


def _panel_qr_update(panel, trailing, precision: str, want_reflector: bool = False):
    """QR-factor `panel` (rows x b) by Householder and apply the full Qᵀ to
    `trailing` (rows x c) in place via the compact-WY reflector: returns
    (R, trailing), plus ("wy", V, T) with H = I - V T Vᵀ when
    want_reflector (trailing' = Hᵀ trailing; the left accumulator applies
    P := P H)."""
    b = panel.shape[1]
    vr, tau = _geqrf(panel)
    r = torch.triu(vr[:b])
    v = torch.tril(vr, -1) + torch.eye(vr.shape[0], b, dtype=vr.dtype, device=vr.device)
    t = _wy_t(v, tau)
    if trailing is not None and trailing.shape[1]:
        _apply_wy_left(v, t, trailing, precision)
    if want_reflector:
        return r, trailing, ("wy", v, t)
    return r, trailing


def _cholqr3s(p, precision: str, conv_tol: float = 1e-4, gemm_inv=None,
              pallas_chain=None):
    """Thin QR of tall `p` by the adaptive shifted CholeskyQR chain
    (`_cholqr_adaptive`, column form): the shifted first pass cannot break
    down, and the later passes restore the orthogonality the Yamamoto
    reflector depends on."""
    return _cholqr_adaptive(p, rows=False, precision=precision, conv_tol=conv_tol,
                            gemm_inv=gemm_inv, pallas_chain=pallas_chain)


def _cholqr3s_rows(p, precision: str, conv_tol: float = 1e-4, gemm_inv=None,
                   pallas_chain=None):
    """Row form of `_cholqr3s`: thin LQ of wide `p` (b x m) as p = l @ qr,
    l lower (b x b), qr row-orthonormal, with the Gram p pᵀ; no transpose
    of p is materialized."""
    return _cholqr_adaptive(p, rows=True, precision=precision, conv_tol=conv_tol,
                            gemm_inv=gemm_inv, pallas_chain=pallas_chain)


def _ns_inv(a: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Newton-Schulz inverse of a (b, b) matrix, products only:
    X <- X (2I - A X) from X0 = Aᵀ / (||A||_1 ||A||_inf); 20 iterations
    cover cond(A) <= ~25, the Yamamoto W1 regime."""
    two_eye = 2.0 * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    scale = 1.0 / (torch.max(torch.sum(torch.abs(a), dim=0))
                   * torch.max(torch.sum(torch.abs(a), dim=1)))
    x = a.T * scale
    for _ in range(iters):
        x = x @ (two_eye - a @ x)
    return x


def _small_inv_t(w1: torch.Tensor, gemm_inv=None) -> torch.Tensor:
    """Sᵀ for the Yamamoto factor from the identity S⁻¹ = -W1ᵀ (W1 the
    reflector's leading b x b block), by the normal equations
    (W1ᵀ)⁻¹ = W1 (W1ᵀ W1)⁻¹: one cholesky, one triangular solve against I
    and two b x b products. NPW_GEMM_INV=1 (or gemm_inv=True) takes
    Newton-Schulz on W1 instead (-W1⁻¹ = Sᵀ)."""
    if gemm_inv if gemm_inv is not None else _flag("NPW_GEMM_INV"):
        return -_ns_inv(w1)
    c = w1.T @ w1
    lc = _cholesky_nan(0.5 * (c + c.T))
    eye = torch.eye(w1.shape[0], dtype=w1.dtype, device=w1.device)
    cinv = torch.linalg.solve_triangular(lc, eye, upper=False)
    return -(cinv.T @ (cinv @ w1.T))  # -C⁻¹ W1ᵀ = Sᵀ


def _yamamoto_signs(d: torch.Tensor) -> torch.Tensor:
    """Sigma = diag(-sign(Q1_ii)) (0 counts as positive): keeps
    diag(S⁻¹) = 1 + |Q1_ii|, so S is well-conditioned."""
    return -torch.where(d >= 0, torch.ones_like(d), -torch.ones_like(d))


def _yamamoto_reflector(q, q1, fast_s: bool = False, gemm_inv=None,
                        e_rows: Optional[slice] = None, e_from: int = 0):
    """The Yamamoto basis-kernel reflector H = I - W S Wᵀ of the thin Q of a
    b-wide panel: Sigma = diag(-sign(Q1_ii)) (`_yamamoto_signs`),
    W = Q Sigma - E, S⁻¹ = I - Sigma Q1ᵀ (Q1 the leading b x b block of Q,
    E the leading b columns of I). Hᵀ panel = E Sigma R; the row form (LQ)
    passes qrᵀ and Q1rᵀ and takes Wᵀ. S comes from the normal equations
    (fast_s: `_small_inv_t` of W's leading block Q1 Sigma - I) or an LU
    inverse.

    `q` may be a share of Q's rows (over a mesh, `q1` then the whole Q1 on
    every rank): its rows e_rows hold E's rows from e_from on (default: E's
    b rows at the top of `q`; an empty slice where it holds none). Returns
    (Sigma, W, S⁻¹, S)."""
    b = q1.shape[0]
    eye = torch.eye(b, dtype=q.dtype, device=q.device)
    sigma = _yamamoto_signs(torch.diagonal(q1))
    w = q * sigma[None, :]
    e_rows = slice(0, b) if e_rows is None else e_rows
    k = len(range(*e_rows.indices(w.shape[0])))
    w[e_rows] -= eye[e_from:e_from + k]
    s_inv = eye - sigma[:, None] * q1.T
    if fast_s:
        s = _small_inv_t(q1 * sigma[None, :] - eye, gemm_inv=gemm_inv).T
    else:
        s = torch.linalg.inv_ex(s_inv)[0]
    return sigma, w, s_inv, s


def _panel_qr_update_cholqr(panel, trailing, precision: str, want_reflector: bool = False,
                            conv_tol: float = 1e-4, fast_s: bool = False,
                            gemm_inv=None, pallas_chain=None):
    """Products-only counterpart of `_panel_qr_update`: thin Q, R from the
    shifted CholeskyQR chain, then the full orthogonal factor as a Yamamoto
    basis-kernel reflector (`_yamamoto_reflector`). Hᵀ panel = E Sigma R
    and Hᵀ trailing = trailing - W (Sᵀ (Wᵀ trailing)), written in place.
    fast_s takes Sᵀ by the normal equations (`_small_inv_t`), else by an
    LU inverse. A square panel (rows == b) uses H = Q Sigma directly: there
    S⁻¹ can be arbitrarily ill-conditioned. Returns (Sigma R, trailing),
    plus the reflector when want_reflector."""
    b = panel.shape[1]
    q, r = _cholqr3s(panel, precision, conv_tol=conv_tol, gemm_inv=gemm_inv,
                     pallas_chain=pallas_chain)
    if panel.shape[0] == b:
        sigma = _yamamoto_signs(torch.diagonal(q[:b]))
        h = q * sigma[None, :]
        if trailing is not None and trailing.shape[1]:
            trailing.copy_(_matmul(h, trailing, ta=True, precision=precision))
        if want_reflector:
            return sigma[:, None] * r, trailing, ("dense", h)
        return sigma[:, None] * r, trailing
    sigma, w, s_inv, s = _yamamoto_reflector(q, q[:b], fast_s, gemm_inv)
    if trailing is not None and trailing.shape[1]:
        w1 = _matmul(w, trailing, ta=True, precision=precision)      # (b, c)
        sw1 = _matmul(s.T, w1, precision=precision)                  # Sᵀ W1, narrow side
        _sub_matmul(trailing, w, sw1, precision=precision, out=trailing)
    if want_reflector:
        return sigma[:, None] * r, trailing, ("yam", w, s_inv)
    return sigma[:, None] * r, trailing


def _panel_lq_update_cholqr(panel, body, precision: str, want_reflector: bool = False,
                            conv_tol: float = 1e-4, fast_s: bool = False,
                            gemm_inv=None, pallas_chain=None):
    """Right-side mirror of `_panel_qr_update_cholqr` for the LQ sweep,
    in row orientation: LQ-factor the wide row `panel` (b x m) by the
    row-form chain and apply H = I - W S Wᵀ (Wᵀ = Wr = Sigma qr - Eᵀ) from
    the right to `body` (rows x m) in place:
    body H = body - ((body Wrᵀ) S) Wr. Returns (l Sigma, body), plus
    ("yam_t", Wr, S⁻¹) when want_reflector."""
    b = panel.shape[0]
    qr_, l = _cholqr3s_rows(panel, precision, conv_tol=conv_tol, gemm_inv=gemm_inv,
                            pallas_chain=pallas_chain)
    sigma, w, s_inv, s_row = _yamamoto_reflector(qr_.T, qr_[:, :b].T, fast_s, gemm_inv)
    wr = w.T                                                        # (b, m): Wᵀ
    if body is not None and body.shape[0]:
        u1 = _matmul(body, wr, tb=True, precision=precision)         # (rows, b) = body W
        u1s = _matmul(u1, s_row, precision=precision)                # narrow side
        _sub_matmul(body, u1s, wr, precision=precision, out=body)
    if want_reflector:
        return l * sigma[None, :], body, ("yam_t", wr, s_inv)
    return l * sigma[None, :], body


def _apply_reflector_right(x, refl, c0: int, precision: str):
    """x[:, c0:] := x[:, c0:] @ H in place for a panel reflector H (the
    transform accumulator's step: two large products a panel) and returns
    x. refl: ("wy", V, T) with H = I - V T Vᵀ; ("yam", W, S⁻¹) with
    H = I - W S Wᵀ; ("yam_t", Wᵀ, S⁻¹) the same with W given transposed;
    ("dense", H) the explicit orthogonal factor."""
    kind = refl[0]
    sub = x[:, c0:]
    if kind == "dense":
        sub.copy_(_matmul(sub, refl[1], precision=precision))
        return x
    if kind == "wy":
        _, v, t = refl
        xv = _matmul(sub, v, precision=precision)                    # (n, b)
        rhs = _matmul(t, v, tb=True, precision=precision)            # T Vᵀ
    elif kind == "yam":
        _, w, s_inv = refl
        xv = _matmul(sub, w, precision=precision)
        rhs = _matmul(torch.linalg.inv_ex(s_inv)[0], w, tb=True, precision=precision)
    else:  # "yam_t"
        _, wr, s_inv = refl
        xv = _matmul(sub, wr, tb=True, precision=precision)
        rhs = _matmul(torch.linalg.inv_ex(s_inv)[0], wr, precision=precision)
    _sub_matmul(sub, xv, rhs, precision=precision, out=sub)
    return x


def fused_bdfac_fn(n_pad: int, tile: int, *, precision: Optional[str] = None,
                   dtype=torch.float32, panel_method: Optional[str] = None,
                   accumulate: bool = False, accum_precision: Optional[str] = None,
                   gemm_inv: Optional[bool] = None,
                   pallas_chain: Optional[bool] = None) -> Callable:
    """Block bidiagonalization over a flat padded (n_pad, n_pad) tensor, the
    fused lowering of algs.bdfac: per block column a tall QR whose full Q
    updates the trailing matrix, then a wide LQ of the row panel while two
    or more superdiagonal blocks remain (LAPACK gebrd at block
    granularity). fn(a) returns B (block upper bidiagonal, the singular
    values of a) and overwrites `a`: the live trailing matrix is a view of
    it, updated in place.

    panel_method: "cholqr" (default; NPW_BDFAC_PANEL overrides) factors
    panels by the shifted CholeskyQR chain (conv_tol 1e-5) and applies a
    Yamamoto reflector, products only; "house" uses geqrf and compact-WY,
    unconditionally stable. gemm_inv / pallas_chain (None: NPW_GEMM_INV /
    NPW_PALLAS_CHAIN, read when fn is built) reach the chains.

    accumulate=True returns fn(a) -> (B, P, Q) with A = P B Qᵀ (P, Q
    orthogonal, n_pad x n_pad): each reflector also updates the
    accumulator's live columns, at accum_precision (None: precision). The
    sigma-only path takes S by the normal equations (fast_s), the vector
    path by an LU inverse."""
    if n_pad % tile != 0:
        raise ValueError(f"n_pad {n_pad} not a multiple of tile {tile}")
    g = n_pad // tile
    precision = check_precision(precision or default_precision(dtype))
    if panel_method is None:
        panel_method = os.environ.get("NPW_BDFAC_PANEL", "cholqr")
    if panel_method not in ("cholqr", "house"):
        raise ValueError(f"unknown bdfac panel_method {panel_method!r}")
    if gemm_inv is None:
        gemm_inv = _flag("NPW_GEMM_INV")
    if pallas_chain is None:
        pallas_chain = _flag("NPW_PALLAS_CHAIN")
    chain_kw = dict(conv_tol=1e-5, fast_s=not accumulate, gemm_inv=gemm_inv,
                    pallas_chain=pallas_chain)
    if panel_method == "cholqr":
        def panel_update(panel, trailing, want=False):
            return _panel_qr_update_cholqr(panel, trailing, precision, want, **chain_kw)
    else:
        def panel_update(panel, trailing, want=False):
            return _panel_qr_update(panel, trailing, precision, want)
    ap = check_precision(accum_precision or precision)

    def bdfac(a):
        out = torch.zeros_like(a)
        cur = a
        p_acc = q_acc = None
        if accumulate:
            p_acc = torch.eye(n_pad, dtype=a.dtype, device=a.device)
            q_acc = torch.eye(n_pad, dtype=a.dtype, device=a.device)
        for k in range(g):
            c0, c1 = k * tile, (k + 1) * tile
            rows = n_pad - c0
            panel = cur[:, :tile]
            trailing = cur[:, tile:] if rows > tile else None
            if accumulate:
                r, trailing, refl = panel_update(panel, trailing, True)
                _apply_reflector_right(p_acc, refl, c0, ap)
            else:
                r, trailing = panel_update(panel, trailing)
            _dus(out, r, c0, c0)
            if rows == tile:
                break
            row_pan, body = trailing[:tile], trailing[tile:]
            if g - k - 1 >= 2:
                if panel_method == "cholqr":
                    res = _panel_lq_update_cholqr(row_pan, body, precision, accumulate,
                                                  **chain_kw)
                    l_blk = res[0]
                else:  # LQ of the row panel = QR of its transpose (views)
                    res = _panel_qr_update(row_pan.T, body.T, precision, accumulate)
                    l_blk = res[0].T
                if accumulate:
                    _apply_reflector_right(q_acc, res[2], c1, ap)
                _dus(out, l_blk, c0, c1)
            else:  # the single superdiagonal block lands as it is
                _dus(out, row_pan, c0, c1)
            cur = body
        if accumulate:
            return out, p_acc, q_acc
        return out

    return bdfac


def fused_bdfac(a: torch.Tensor, tile: int, *, precision: Optional[str] = None,
                panel_method: Optional[str] = None, donate: bool = False,
                accumulate: bool = False, accum_precision: Optional[str] = None,
                gemm_inv: Optional[bool] = None):
    """Fused BDFAC of the square tensor `a` (its side a multiple of `tile`):
    B, or (B, P, Q) with A = P B Qᵀ when accumulate=True. donate=True works
    in place on `a` (its contents are then lost); donate=False works on a
    copy, the reference's defensive input copy. gemm_inv (None: the
    NPW_GEMM_INV default) and the rest as in `fused_bdfac_fn`."""
    fn = fused_bdfac_fn(a.shape[0], tile, precision=precision, dtype=a.dtype,
                        panel_method=panel_method, accumulate=accumulate,
                        accum_precision=accum_precision, gemm_inv=gemm_inv)
    return fn(a if donate else a.clone())


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
    """A no-arg callable running `program` through its fused lowering,
    committing the results into its bound matrices and marking the program's
    success (the `run.commit` span); None when the program's template has no
    fused specialization (cholesky, gemm, the tsqr family and bdfac have)."""
    name = program.dag.template.name
    if name == "cholesky":
        inner = lambda: _run_fused_cholesky(program)  # noqa: E731
    elif name == "gemm":
        inner = lambda: _run_fused_gemm(program)  # noqa: E731
    elif name in ("tsqr", "tsqr_q") or name.startswith("tsqr_b"):
        inner = lambda: _run_fused_tsqr(program, compute_q=(name == "tsqr_q"))  # noqa: E731
    elif name == "bdfac":
        inner = lambda: _run_fused_bdfac(program)  # noqa: E731
    else:
        return None

    def run_and_commit():
        """The runners promote host-tier operands to device-tier copies; the
        caller's handles must still see the results (the reference's
        semantics: writes land in the store the program was bound to), so
        computed blocks are copied back and the handles restored."""
        from numpywren_tpu_torch.runtime.executor import _mark_success

        originals = {nm: ba.matrix for nm, ba in program.matrices.items()}
        inner()
        with span("run.commit"):
            for nm, orig in originals.items():
                cur = program.matrices[nm].matrix
                if cur is orig or orig.storage in ("hbm", "trapezoid"):
                    continue
                for (i, j) in cur.block_idxs_exist:
                    orig.put_block(cur.get_block(i, j), i, j)
                program.matrices[nm].matrix = orig
            _mark_success(program)

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
        # matrix too large for that streams out of core instead
        m = s_ba.matrix
        pm, pn = m.padded_shape
        if 3 * pm * pn * m.dtype.itemsize > _hbm_budget_bytes():
            from numpywren_tpu_torch.runtime.spill import out_of_core_cholesky

            o_host = program.matrices["O"].matrix
            if o_host.storage != "host":
                o_host = o_host.to_host()
                program.matrices["O"].matrix = o_host
            out_of_core_cholesky(m, out=o_host)
            return

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


def _run_fused_bdfac(program):
    if _spill_if_over_budget(program):
        return
    s = _hbm(program, "S")
    b = _hbm(program, "B")
    # S is the program's own copy of X, freed below: the sweeps work in it
    out = fused_bdfac(s.array, s.tile[0], donate=True)
    b.replace_array(out.to(b.dtype))
    s.free()


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
        with span("tsqr.q_pad"):
            pad = torch.zeros(q_mat.padded_shape, dtype=q_mat.dtype, device=q_arr.device)
            pad[: q_arr.shape[0], : q_arr.shape[1]] = q_arr
            q_mat.replace_array(pad)
    else:
        r_final = out
    # the final R lives at block (0, depth) of R (algs.tsqr layout)
    r_mat.put_block(r_final.to(r_mat.dtype), 0, depth)
