"""Region-fused lowering of the Cholesky program, on PyTorch tensors.

Counterpart of numpywren_tpu/compiler/lower.py (Cholesky only). The store
keeps a matrix as ONE padded tensor, so a panel or a trailing region is a
strided view, and the right-looking schedule lowers to a handful of large
GEMMs per column super-panel:

1. the W x W diagonal block factors with one library potrf
   (``torch.linalg.cholesky_ex``, which reads only the lower triangle: the
   diagonal blocks' strict upper may hold stale values);
2. the below-panel solve B := B L⁻ᵀ is a recursive GEMM-rich trsm
   (`_rtrsm`) whose tile-sized leaves multiply by an explicit inverse;
3. one trailing update ``c - a·bᵀ`` per later column block.

Every GEMM goes through `_matmul` / `_sub_matmul`, which pick the kernel by
precision and NpwConfig.compensated (see ops/common.py). PyTorch runs
eagerly: there is no jit, and what JAX expresses as buffer donation is an
in-place write here. The factorization overwrites the buffers it is given.

The tuning constants (panel_tiles=8, syrk_depth=3, leaf_rows=4096, the
inner tile of 128) were measured on a TPU and are kept until measured on
the GPU.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from numpywren_tpu.config import default_config
from numpywren_tpu_torch.ops.common import cdiv, check_precision, default_precision
from numpywren_tpu_torch.ops.gemm import matmul as kernel_matmul
from numpywren_tpu_torch.ops.gemm3 import matmul3

_SPILL = "out-of-core spill is not ported yet (ROADMAP Queue 1: host tier and spill)"


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
        for c in range(p + 1, nb):
            off = (c - p - 1) * panel
            _sub_matmul(cols[c], b[off:], b[off:off + cols[c].shape[1]], tb=True,
                        precision=precision, out=cols[c])
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
# Program-level dispatch
# ---------------------------------------------------------------------------

def lower_fused(program) -> Optional[Callable[[], None]]:
    """A no-arg callable running `program` through its fused lowering and
    committing the results into its bound matrices; None when the program's
    template has no fused specialization in the port (only cholesky has)."""
    if program.dag.template.name == "cholesky":
        return lambda: _run_fused_cholesky(program)
    return None


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
    m = ba.matrix
    if m.storage != "hbm":
        pm, pn = m.padded_shape
        need = pm * pn * m.dtype.itemsize
        if need > _hbm_budget_bytes():
            raise NotImplementedError(
                f"{name}: a flat {pm}x{pn} copy needs {need} bytes, over the "
                f"device-memory budget; {_SPILL}")
        ba.matrix = m.to_hbm()
    return ba.matrix


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
    if s_ba.matrix.storage != "hbm":
        raise NotImplementedError(f"cholesky on the {s_ba.matrix.storage!r} tier: {_SPILL}")

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
