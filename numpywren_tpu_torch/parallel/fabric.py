"""Fabric: explicit collectives over a DeviceMesh.

Counterpart of numpywren_tpu/parallel/fabric.py. There, the collectives
are ``psum`` and ``ppermute`` inside ``shard_map``; here they are the two
collectives every backend takes for a CUDA tensor, in the mesh axes'
process groups:

- a masked psum with one contributor (a panel broadcast) is
  ``dist.broadcast`` (`broadcast_along`; over the flattened mesh
  `broadcast_flat`: along the cols axis in the root's row, then along the
  rows axis);
- a psum with several contributors (a Gram, disjoint pieces) is
  ``dist.all_reduce`` (`sum_over_mesh` over the flattened mesh);
- the butterfly's ppermutes are one all_reduce of a zero-masked slot
  buffer a level.

A group of the flattened mesh is never created: that is collective over
the whole world, which ranks outside the mesh do not join. The local math
runs on each rank's own block through the port's GEMM kernels
(`_matmul`, `_sub_matmul`, `_tsqr_matmul`), as the reference's shard_map
keeps its Pallas kernels. Every decision the host makes is one that every
rank makes alike by construction (the rank's coordinates, or a value
broadcast from the mesh's first rank), so no rank skips a collective that
the others enter.

The distributed BDFAC (``bdfac_1d``, ``bdfac_2d``) keeps the reference's
collectives, logs and results; its tile² inverses read tiles broadcast
from one owner, so every rank holds the same bits.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from numpywren_tpu_torch.compiler.lower import (
    _cholesky_nan,
    _cholqr_adaptive,
    _matmul,
    _potrf,
    _raise_if_not_spd,
    _sub_matmul,
    _tsqr_matmul,
    _use_compensated,
    _yamamoto_reflector,
)
from numpywren_tpu_torch.exceptions import ShapeError
from numpywren_tpu_torch.ops.common import check_precision, default_precision, torch_dtype
from numpywren_tpu_torch.ops.gemm3 import Panel
from numpywren_tpu_torch.parallel.mesh import (
    NamedSharding,
    as_dtensor,
    broadcast_flat,
    flat_index,
    flat_rows,
    local_block,
    make_mesh,
    mesh_device,
    mesh_sharding,
    P,
    sum_over_mesh,
)


def _as_host(x):
    """Pass tensors (and DTensors) through; keep host arrays host-side, so
    that each rank copies only its own block to its device."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def broadcast_along(x: torch.Tensor, axis_name: str, root: int, mesh: DeviceMesh) -> torch.Tensor:
    """One-to-all broadcast along a mesh axis: every rank of this rank's
    group along `axis_name` receives, into `x` (in place, and returned), the
    `x` of the rank at index `root` of the axis. The reference's masked
    psum. Collective over the axis's group: each of its ranks calls it with
    the same root and a tensor of the same shape and dtype."""
    axis = mesh.mesh_dim_names.index(axis_name)
    if mesh.size(axis) == 1:
        return x
    coord = list(mesh.get_coordinate())
    coord[axis] = root
    dist.broadcast(x, src=int(mesh.mesh[tuple(coord)]), group=mesh.get_group(axis))
    return x


def _from(loc: torch.Tensor, axis_name: str, root: int, mesh: DeviceMesh) -> torch.Tensor:
    """The block `loc` of the rank at index `root` along `axis_name`, on
    every rank of this rank's group along it (broadcast_along into a fresh
    buffer; the root passes its own). Collective over the axis's group."""
    mine = mesh.get_coordinate()[mesh.mesh_dim_names.index(axis_name)] == root
    buf = loc.contiguous() if mine else torch.empty(loc.shape, dtype=loc.dtype, device=loc.device)
    return broadcast_along(buf, axis_name, root, mesh)


def _square(mesh: DeviceMesh, what: str) -> int:
    r, c = mesh.shape
    if r != c:
        raise ShapeError(f"{what} needs a square mesh, got {tuple(mesh.shape)}")
    return r


# ---------------------------------------------------------------------------
# SUMMA GEMM
# ---------------------------------------------------------------------------

def summa_gemm(a, b, mesh: Optional[DeviceMesh] = None, *, precision=None):
    """C = A @ B by SUMMA over a SQUARE (s x s) mesh: s k-steps, each
    broadcasting one block-column of A along the mesh's cols axis and one
    block-row of B along its rows axis, accumulating the local products
    (`_matmul`: the matmul3 kernel under compensated, the matmul kernel at
    "highest"). All operands and the result are 2-D block-sharded (a
    DTensor). Collective over the mesh."""
    mesh = mesh or make_mesh()
    rows_ax, cols_ax = mesh.mesh_dim_names
    s = _square(mesh, "summa_gemm")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ShapeError(f"gemm shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if m % s or k % s or n % s:
        raise ShapeError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} must divide mesh {s}")
    precision = check_precision(precision or default_precision(a.dtype))
    sh = mesh_sharding(mesh, P(rows_ax, cols_ax))
    a_loc = local_block(_as_host(a), sh)
    b_loc = local_block(_as_host(b), sh)
    acc = None
    for t in range(s):
        a_pan = _from(a_loc, cols_ax, t, mesh)  # block-col t of A
        b_pan = _from(b_loc, rows_ax, t, mesh)  # block-row t of B
        part = _matmul(a_pan, b_pan, precision=precision)
        acc = part if acc is None else acc.add_(part)
    return as_dtensor(acc, (m, n), sh)


def summa_syrk(s, pan, mesh: Optional[DeviceMesh] = None, *, precision=None):
    """S := S - P Pᵀ over a SQUARE (r x r) mesh with S 2-D block-sharded and
    P row-sharded: rank (i, j) pulls P's row block j from the diagonal
    owner with ONE broadcast along the rows axis, then runs its local
    update through `_sub_matmul` (the matmul3 kernel under compensated, the
    matmul kernel at "highest", the subtract fused in). Returns a new S (a
    DTensor); a sharded input is not overwritten. Collective over the mesh."""
    mesh = mesh or make_mesh()
    rows_ax, cols_ax = mesh.mesh_dim_names
    r = _square(mesh, "summa_syrk")
    n = s.shape[0]
    if s.shape[1] != n:
        raise ShapeError(f"S must be square, got {tuple(s.shape)}")
    if pan.shape[0] != n:
        raise ShapeError(f"panel rows {pan.shape[0]} != S rows {n}")
    if n % r:
        raise ShapeError(f"n {n} must divide mesh dim {r}")
    precision = check_precision(precision or default_precision(s.dtype))
    s_sh = mesh_sharding(mesh, P(rows_ax, cols_ax))
    s_loc = local_block(_as_host(s), s_sh)
    p_loc = local_block(_as_host(pan), mesh_sharding(mesh, P(rows_ax, None)))
    # rank (i, j) holds P's row block i (P is replicated along cols); it
    # needs row block j, held by rank (j, j) of its mesh column
    my_col = mesh.get_coordinate()[1]
    p_j = _from(p_loc, rows_ax, my_col, mesh)
    return as_dtensor(_sub_matmul(s_loc, p_loc, p_j, tb=True, precision=precision), (n, n), s_sh)


# ---------------------------------------------------------------------------
# Explicit-collective Cholesky: block-cyclic panels over a 1-D mesh
# ---------------------------------------------------------------------------

def _check_square(a, panel: int) -> int:
    n = a.shape[0]
    if a.ndim != 2 or a.shape[1] != n:
        raise ShapeError(f"cholesky needs a square matrix, got {tuple(a.shape)}")
    if n % panel:
        raise ShapeError(f"n {n} must be a multiple of panel {panel}")
    return n


def _check_gather(gather: str) -> None:
    if gather not in ("device", "host"):
        raise ValueError(f"gather must be 'device' or 'host', got {gather!r}")


def _host_or_tensor(x, rows, cols) -> torch.Tensor:
    """x[rows][:, cols] for index arrays: a copy of that block alone, on x's
    device for a tensor, on the host for an array."""
    if isinstance(x, torch.Tensor):
        return x.index_select(0, torch.as_tensor(rows, device=x.device)).index_select(
            1, torch.as_tensor(cols, device=x.device))
    return torch.from_numpy(np.ascontiguousarray(x[np.ix_(rows, cols)]))


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _block_rows(blocks, panel: int) -> np.ndarray:
    """The element indices of the given block indices, in order."""
    return (np.asarray(list(blocks), np.int64)[:, None] * panel
            + np.arange(panel, dtype=np.int64)).reshape(-1)


class _Updates:
    """The trailing updates c -= L[j*panel:] @ L[j*panel:(j+1)*panel]ᵀ of the
    factored panel `lk` (its rows [k*panel, n) hold the factor), for the
    column blocks j > k: under compensated the rows are packed once
    (`gemm3.Panel`) for all of them, as the single-device schedule does;
    otherwise each is one `_sub_matmul`. Only the rows [j*panel, n) of
    column block j are updated: the rows above them lie above the
    diagonal, where the reference's full-column product changes values
    that no later step reads and the final tril drops."""

    def __init__(self, lk: torch.Tensor, k: int, panel: int, precision: str):
        self.lk, self.k, self.panel, self.precision = lk, k, panel, precision
        d0 = k * panel
        self.packed = Panel(lk[d0:]) if _use_compensated(lk, precision) else None

    def __call__(self, col: torch.Tensor, j: int) -> None:
        """col (n rows, panel wide, in place) -= the update of block j."""
        w, lk = self.panel, self.lk
        live = col[j * w:]
        if self.packed is not None:
            self.packed.sub_update(live, (j - self.k) * w, w, out=live)
        else:
            _sub_matmul(live, lk[j * w:], lk[j * w:(j + 1) * w], tb=True,
                        precision=self.precision, out=live)


def cholesky_1d(a, mesh: Optional[DeviceMesh] = None, *, panel: int = 512, precision=None,
                lookahead: bool = True, gather: str = "device",
                schedule_log: Optional[list] = None):
    """Right-looking blocked Cholesky with column super-panels distributed
    BLOCK-CYCLICALLY over the mesh flattened row-major (panel k lives on
    flat rank k mod P): each step is one broadcast of the current panel
    from its owner (`broadcast_flat`, the reference's masked psum), every
    rank factors it redundantly (`_potrf`, an explicit W x W inverse, the
    solve through `_matmul`), and the trailing updates of the panels a rank
    owns run locally (`_sub_matmul`, or one `gemm3.Panel` a step under
    compensated: the matmul3 kernel; the matmul kernel at "highest").

    `a` is a host array (or a tensor), the same on every rank: each rank
    copies only its own panels to its device. lookahead=True reorders each
    step as the reference does: the owner of panel k+1 updates only that
    column, its broadcast is issued, and the bulk updates of step k come
    after it. schedule_log receives the reference's events ("bcast", k) /
    ("col_update", k) / ("bulk", k, slot) / ("factor", k) in the order they
    run. gather="device" returns the dense lower factor on every rank (one
    all_reduce of the zero-masked columns); gather="host" an ndarray on
    every rank, assembled panel by panel (one broadcast each), with no
    dense copy on the device. A panel that is not positive-definite raises
    torch.linalg.LinAlgError on every rank. Collective over the mesh."""
    n = _check_square(a, panel)
    _check_gather(gather)
    mesh = mesh or make_mesh()
    p, me = mesh.size(), flat_index(mesh)
    nb = n // panel
    nb_local = -(-nb // p)
    dtype = torch_dtype(a.dtype)
    precision = check_precision(precision or default_precision(dtype))
    dev = mesh_device(mesh)
    a = _as_host(a)
    # local[s] = global panel me + s*p as full (n, panel) columns (zeros
    # above the diagonal are dead; past nb, zero)
    local = torch.zeros((nb_local, n, panel), dtype=dtype, device=dev)
    for s in range(nb_local):
        j = me + s * p
        if j < nb:
            cols = a[:, j * panel:(j + 1) * panel]
            local[s].copy_(cols if isinstance(cols, torch.Tensor) else torch.from_numpy(cols))
    log = schedule_log if schedule_log is not None else []
    eye = torch.eye(panel, dtype=dtype, device=dev)
    infos: List[torch.Tensor] = []

    def bcast_state(k):
        """The current state of panel k, from its owner."""
        owner, slot = k % p, k // p
        log.append(("bcast", k))
        buf = local[slot] if me == owner else torch.empty((n, panel), dtype=dtype, device=dev)
        return broadcast_flat(buf, owner, mesh)

    def factor_panel(pan, k):
        """potrf + solve of the (n, panel) column holding panel k, on every
        rank; rows above k*panel come back zero."""
        d0 = k * panel
        ld = _potrf(pan[d0:d0 + panel], infos)
        winv = torch.linalg.solve_triangular(ld, eye, upper=False)
        out = torch.zeros_like(pan)
        out[d0:d0 + panel] = ld
        if d0 + panel < n:
            out[d0 + panel:] = _matmul(pan[d0 + panel:], winv, tb=True, precision=precision)
        return out

    def commit(lk, k):
        if me == k % p:
            local[k // p].copy_(lk)

    def bulk(upd, k, first):
        """Step k's updates of the owned panels j >= first."""
        for s in range(nb_local):
            j = me + s * p
            log.append(("bulk", k, s))
            if first <= j < nb:
                upd(local[s], j)

    if not lookahead:
        for k in range(nb):
            pan = bcast_state(k)
            log.append(("factor", k))
            lk = factor_panel(pan, k)
            commit(lk, k)
            bulk(_Updates(lk, k, panel, precision), k, k + 1)
    else:
        pan = bcast_state(0)
        log.append(("factor", 0))
        lk = factor_panel(pan, 0)
        commit(lk, 0)
        for k in range(nb):
            upd = _Updates(lk, k, panel, precision)
            pan_next = None
            if k + 1 < nb:
                # critical path first: the owner of k+1 updates only that
                # column, then its broadcast is issued before the bulk
                log.append(("col_update", k + 1))
                if me == (k + 1) % p:
                    upd(local[(k + 1) // p], k + 1)
                pan_next = bcast_state(k + 1)
            bulk(upd, k, k + 2)
            if pan_next is not None:
                log.append(("factor", k + 1))
                lk = factor_panel(pan_next, k + 1)
                commit(lk, k + 1)
    _raise_if_not_spd(infos, "cholesky_1d")

    if gather == "host":
        out_np = np.zeros((n, n), dtype=_np_dtype(dtype))
        for j in range(nb):
            d, s = j % p, j // p
            buf = local[s] if me == d else torch.empty((n, panel), dtype=dtype, device=dev)
            out_np[:, j * panel:(j + 1) * panel] = broadcast_flat(buf, d, mesh).cpu().numpy()
        return np.tril(out_np)
    out = torch.zeros((n, n), dtype=dtype, device=dev)
    for s in range(nb_local):
        j = me + s * p
        if j < nb:
            out[:, j * panel:(j + 1) * panel] = local[s]
    del local
    return sum_over_mesh(out, mesh).tril_()


# ---------------------------------------------------------------------------
# 2-D block-cyclic Cholesky
# ---------------------------------------------------------------------------

def cholesky_2d(a, mesh: Optional[DeviceMesh] = None, *, panel: int = 512, precision=None,
                lookahead: bool = True, gather: str = "device",
                schedule_log: Optional[list] = None,
                collective_log: Optional[list] = None):
    """Right-looking blocked Cholesky over an (r x c) mesh with 2-D
    block-cyclic tiles (global block (i, j) on mesh rank (i mod r, j mod c))
    and ScaLAPACK-shaped collectives. Per panel step k, three collectives:

      1. ``akk``: the panel² diagonal block, broadcast from its owner
         (`broadcast_flat`); every rank factors it redundantly (`_potrf`,
         an explicit inverse);
      2. ``bcast_rows``: mesh column k mod c solves its row blocks (one
         `_matmul` against the inverse), then broadcasts them along the
         cols axis: n_loc_r * panel floats;
      3. ``bcast_cols``: each rank contributes the pieces its mesh column
         needs (global block j with j mod c == its column), and one
         all_reduce over the rows axis sums them: n_loc_c * panel floats
         (several ranks add disjoint pieces, so it is no broadcast).

    The trailing update is then local: one `_sub_matmul` a rank a step (the
    matmul3 kernel under compensated, the matmul kernel at "highest"), over
    the reference's conservative static region, which wastes at most one
    block row and column of flops on zero pieces.

    lookahead=True: after step k's pieces arrive, only panel k+1's column
    strip is updated, panel k+1's collectives are issued, and step k's
    bulk update comes last; the ``bcast_cols`` all_reduce of k+1 runs
    asynchronously (async_op) under that bulk update and is waited on where
    its pieces are read. schedule_log receives ("akk" | "solve" |
    "bcast_rows" | "bcast_cols" | "col_update" | "bulk", k) in the order
    they run, collective_log ("<kind>", k, floats a rank) for each
    collective: the reference's lists. `a`, gather and the errors as in
    `cholesky_1d`; gather="host" assembles one block column at a time (one
    all_reduce each). Collective over the mesh."""
    n = _check_square(a, panel)
    _check_gather(gather)
    mesh = mesh or make_mesh()
    rows_ax, cols_ax = mesh.mesh_dim_names
    r, c = mesh.shape
    pi, pj = mesh.get_coordinate()
    nb = n // panel
    nbr, nbc = -(-nb // r), -(-nb // c)   # local row / column blocks
    n_loc_r, n_loc_c = nbr * panel, nbc * panel
    dtype = torch_dtype(a.dtype)
    precision = check_precision(precision or default_precision(dtype))
    dev = mesh_device(mesh)
    a = _as_host(a)
    # local block (s, t) = global block (pi + s*r, pj + t*c), zero past the grid
    local = torch.zeros((n_loc_r, n_loc_c), dtype=dtype, device=dev)
    my_r, my_c = range(pi, nb, r), range(pj, nb, c)
    if len(my_r) and len(my_c):
        local[:len(my_r) * panel, :len(my_c) * panel].copy_(
            _host_or_tensor(a, _block_rows(my_r, panel), _block_rows(my_c, panel)))
    log = schedule_log if schedule_log is not None else []
    clog = collective_log if collective_log is not None else []
    eye = torch.eye(panel, dtype=dtype, device=dev)
    infos: List[torch.Tensor] = []

    def slot(k, mine, m, count):
        """The local block slot of global block k (clipped to the range)."""
        return min(max((k - mine) // m, 0), count - 1)

    def factor_panel(k):
        """Step k's diagonal broadcast, local solve and piece collectives.
        Returns (my_rows, my_cols, the pending all_reduce of my_cols or
        None): my_rows[s] = L[pi + s*r, k], my_cols[t] = L[pj + t*c, k],
        zero where that block is not below k."""
        ok_col, ok_row = pj == k % c, pi == k % r
        s_k, t_k = slot(k, pi, r, nbr), slot(k, pj, c, nbc)
        log.append(("akk", k))
        clog.append(("akk", k, panel * panel))
        if ok_row and ok_col:
            akk = local[s_k * panel:(s_k + 1) * panel, t_k * panel:(t_k + 1) * panel].clone()
        else:
            akk = torch.empty((panel, panel), dtype=dtype, device=dev)
        broadcast_flat(akk, (k % r) * c + k % c, mesh)
        lkk = _potrf(akk, infos)
        log.append(("solve", k))
        solved = torch.zeros((n_loc_r, panel), dtype=dtype, device=dev)
        if ok_col:
            winv = torch.linalg.solve_triangular(lkk, eye, upper=False)
            col = local[:, t_k * panel:(t_k + 1) * panel]
            s0 = min(max((k - pi) // r + 1, 0), nbr)   # first local row block below k
            if s0 < nbr:
                solved[s0 * panel:] = _matmul(col[s0 * panel:], winv, tb=True,
                                              precision=precision)
                col[s0 * panel:] = solved[s0 * panel:]
            if ok_row:
                col[s_k * panel:(s_k + 1) * panel] = lkk
        log.append(("bcast_rows", k))
        clog.append(("bcast_rows", k, n_loc_r * panel))
        my_rows = broadcast_along(solved, cols_ax, k % c, mesh)
        my_cols = torch.zeros((n_loc_c, panel), dtype=dtype, device=dev)
        for t in range(nbc):
            j = pj + t * c
            if j % r == pi and k < j < nb:
                src = (j - pi) // r
                my_cols[t * panel:(t + 1) * panel] = my_rows[src * panel:(src + 1) * panel]
        log.append(("bcast_cols", k))
        clog.append(("bcast_cols", k, n_loc_c * panel))
        work = None
        if r > 1:
            work = dist.all_reduce(my_cols, group=mesh.get_group(0), async_op=lookahead)
        return my_rows, my_cols, work

    def bulk_update(k, my_rows, my_cols, skip_col=None):
        """local[live, live] -= my_rows @ my_colsᵀ over the conservative
        region; skip_col zeroes the piece of the column block the lookahead
        already updated."""
        if skip_col is not None and pj == skip_col % c:
            t_s = slot(skip_col, pj, c, nbc)
            my_cols[t_s * panel:(t_s + 1) * panel] = 0
        r0 = ((k + 1) // r) * panel   # the fewest factored rows over the ranks
        c0 = ((k + 1) // c) * panel
        log.append(("bulk", k))
        if n_loc_r - r0 <= 0 or n_loc_c - c0 <= 0:
            return
        sub = local[r0:, c0:]
        _sub_matmul(sub, my_rows[r0:], my_cols[c0:], tb=True, precision=precision, out=sub)

    if not lookahead:
        for k in range(nb):
            my_rows, my_cols, _ = factor_panel(k)
            bulk_update(k, my_rows, my_cols)
    else:
        my_rows, my_cols, work = factor_panel(0)
        for k in range(nb):
            if work is not None:
                work.wait()
            nxt = None
            if k + 1 < nb:
                # critical path first: only panel k+1's column strip, on its
                # mesh column, then panel k+1's solve and collectives
                log.append(("col_update", k + 1))
                if pj == (k + 1) % c:
                    t_n = slot(k + 1, pj, c, nbc)
                    strip = local[:, t_n * panel:(t_n + 1) * panel]
                    _sub_matmul(strip, my_rows, my_cols[t_n * panel:(t_n + 1) * panel], tb=True,
                                precision=precision, out=strip)
                nxt = factor_panel(k + 1)
            bulk_update(k, my_rows, my_cols, skip_col=k + 1 if k + 1 < nb else None)
            if nxt is not None:
                my_rows, my_cols, work = nxt
    _raise_if_not_spd(infos, "cholesky_2d")

    def tiles(j):
        """This rank's blocks (i, j), i >= j, as (i, local view)."""
        if j % c != pj:
            return
        t = (j - pj) // c
        for s in range(nbr):
            i = pi + s * r
            if j <= i < nb:
                yield i, local[s * panel:(s + 1) * panel, t * panel:(t + 1) * panel]

    if gather == "host":
        out_np = np.zeros((n, n), dtype=_np_dtype(dtype))
        for j in range(nb):
            buf = torch.zeros((n - j * panel, panel), dtype=dtype, device=dev)
            for i, blk in tiles(j):
                buf[(i - j) * panel:(i - j + 1) * panel] = blk
            out_np[j * panel:, j * panel:(j + 1) * panel] = sum_over_mesh(buf, mesh).cpu().numpy()
        return np.tril(out_np)
    out = torch.zeros((n, n), dtype=dtype, device=dev)
    for j in range(nb):
        for i, blk in tiles(j):
            out[i * panel:(i + 1) * panel, j * panel:(j + 1) * panel] = blk
    del local
    return sum_over_mesh(out, mesh).tril_()


# ---------------------------------------------------------------------------
# Distributed CholeskyQR over row shards
# ---------------------------------------------------------------------------

def _row_shards(a, mesh: DeviceMesh):
    """(this rank's rows of `a` over the flattened mesh, that layout, m, b)."""
    m, b = a.shape
    p = mesh.size()
    if m % p:
        raise ShapeError(f"rows {m} must divide {p} devices")
    sh = flat_rows(mesh)
    return local_block(_as_host(a), sh), sh, m, b


def _qr_out(q, r, m: int, b: int, sh, mesh: DeviceMesh, compute_q: bool):
    r_out = as_dtensor(r.contiguous(), (b, b), NamedSharding(mesh, (Replicate(), Replicate())))
    return (as_dtensor(q, (m, b), sh), r_out) if compute_q else r_out


def cholqr2_sharded(a, mesh: Optional[DeviceMesh] = None, *, compute_q: bool = False,
                    precision=None):
    """CholeskyQR2 over row shards of the flattened mesh: each rank forms
    its local Gram, ONE all_reduce sums them, the b x b Cholesky and its
    inverse run replicated, and Q stays row-sharded; two passes. The
    applies go through `_tsqr_matmul` (the matmul3 kernel under
    compensated), the Grams and the b x b algebra are true FP32. A Gram
    that is not positive-definite gives NaN, as the reference's does.
    Returns R (replicated), or (Q, R) with Q a Shard(0) DTensor.
    Collective over the mesh."""
    mesh = mesh or make_mesh()
    x, sh, m, b = _row_shards(a, mesh)
    precision = check_precision(precision or default_precision(x.dtype))
    eye = torch.eye(b, dtype=x.dtype, device=x.device)

    def one_pass(x):
        g = sum_over_mesh(x.T @ x, mesh)
        l = _cholesky_nan(g)
        w = torch.linalg.solve_triangular(l, eye, upper=False)
        return _tsqr_matmul(x, w, tb=True, precision=precision), l

    q1, l1 = one_pass(x)
    q2, l2 = one_pass(q1)
    return _qr_out(q2, l2.T @ l1.T, m, b, sh, mesh, compute_q)


def cholqr3s_sharded(a, mesh: Optional[DeviceMesh] = None, *, compute_q: bool = False,
                     precision=None):
    """The robust distributed tall-skinny QR: the adaptive shifted
    CholeskyQR chain (`compiler.lower._cholqr_adaptive`) over row shards of
    the flattened mesh, its real Grams all_reduced; every host decision is
    the mesh's first rank's (broadcast), so every rank runs the same chain.
    The well-conditioned case costs one all_reduce'd Gram; ill-conditioned
    inputs pay extra passes (where cholqr2_sharded gives NaN). Returns R
    (replicated), or (Q, R) with Q a Shard(0) DTensor. Collective over the
    mesh."""
    mesh = mesh or make_mesh()
    x, sh, m, b = _row_shards(a, mesh)
    precision = check_precision(precision or default_precision(x.dtype))
    q, r = _cholqr_adaptive(x, rows=False, precision=precision, psum_mesh=mesh, global_m=m)
    return _qr_out(q, r, m, b, sh, mesh, compute_q)


# ---------------------------------------------------------------------------
# Butterfly TSQR
# ---------------------------------------------------------------------------

def _butterfly_groups(p: int, stride: int, b_fac: int):
    """Group structure at one butterfly level: groups[i] = the ordered
    members of rank i's group (i0 + k*stride < p for its b_fac-aligned
    base i0)."""
    groups = []
    for i in range(p):
        i0 = (i // (stride * b_fac)) * (stride * b_fac) + i % stride
        groups.append([i0 + k * stride for k in range(b_fac) if i0 + k * stride < p])
    return groups


def tsqr_butterfly(a, mesh: Optional[DeviceMesh] = None, *, axis: Optional[str] = None,
                   b_fac: int = 2, _return_stacked: bool = False):
    """R factor of a tall-skinny A by a k-ary butterfly TSQR across one mesh
    axis (`axis`, the rows split over it and replicated over the other) or
    the whole mesh flattened row-major (axis=None). Each rank QRs its rows,
    then ceil(log_b P) levels: groups of `b_fac` ranks at stride b_fac^l
    stack their R factors in member order (a ragged tail group stacks
    fewer, zero-padded) and every member QRs the identical stack. The
    exchange is one all_reduce of a zero-masked slot buffer, a slot a rank
    (the reference's ppermutes; backends take no point-to-point of a CUDA
    tensor): a sum of one value and zeros is exact. When P is not a power
    of b_fac one final broadcast from index 0 gives every rank the same R.
    Returns R (b x b, replicated), or with _return_stacked the (P*b, b)
    stack of every rank's R, sharded as the rows were. Collective over the
    mesh."""
    if b_fac < 2:
        raise ShapeError(f"b_fac must be >= 2, got {b_fac}")
    mesh = mesh or make_mesh()
    m, b = a.shape
    if axis is None:
        p, me, sh = mesh.size(), flat_index(mesh), flat_rows(mesh)
    else:
        ax = mesh.mesh_dim_names.index(axis)
        p, me = mesh.size(ax), mesh.get_coordinate()[ax]
        sh = NamedSharding(mesh, tuple(Shard(0) if i == ax else Replicate()
                                       for i in range(mesh.ndim)))
    if m % p:
        raise ShapeError(f"rows {m} must divide {p} devices")
    q = p
    while q % b_fac == 0:
        q //= b_fac
    loc = local_block(_as_host(a), sh)
    r = torch.linalg.qr(loc, mode="r")[1]
    stride = 1
    while stride < p:
        group = _butterfly_groups(p, stride, b_fac)[me]
        slots = loc.new_zeros((p, b, b))
        slots[me, :r.shape[0]] = r
        if axis is None:
            sum_over_mesh(slots, mesh)
        else:
            dist.all_reduce(slots, group=mesh.get_group(ax))
        stack = loc.new_zeros((b_fac * b, b))
        stack[:len(group) * b] = slots[group].reshape(-1, b)
        r = torch.linalg.qr(stack, mode="r")[1]
        stride *= b_fac
    if q != 1:
        r = r.contiguous()
        if axis is None:
            broadcast_flat(r, 0, mesh)
        else:
            broadcast_along(r, axis, 0, mesh)
    if _return_stacked:
        return as_dtensor(r.contiguous(), (p * b, b), sh)
    return as_dtensor(r.contiguous(), (b, b), NamedSharding(mesh, (Replicate(), Replicate())))




# ---------------------------------------------------------------------------
# Distributed BDFAC (block bidiagonalization)
# ---------------------------------------------------------------------------

def _check_bdfac(a, tile: int, what: str) -> int:
    n = a.shape[0]
    if a.ndim != 2 or a.shape[1] != n:
        raise ShapeError(f"{what} needs a square matrix, got {tuple(a.shape)}")
    if n % tile:
        raise ShapeError(f"n {n} must be a multiple of tile {tile}")
    return n


def _from_root(get, shape, root: int, mine: bool, mesh: DeviceMesh, dtype, dev) -> torch.Tensor:
    """The block `get()` of the rank at flat index `root`, on every rank of
    the mesh (a copy: `get` is called on the root alone). Collective over
    the mesh."""
    buf = get().clone(memory_format=torch.contiguous_format) if mine \
        else torch.empty(shape, dtype=dtype, device=dev)
    return broadcast_flat(buf, root, mesh)


def _first_slot(j: int, mine: int, m: int, count: int) -> int:
    """The first of this rank's `count` block slots (slot s holds global
    block mine + s*m) whose global block is >= j."""
    return min(max(-(-(j - mine) // m), 0), count)


def _bdfac_setup(a, tile: int, precision, mesh):
    """(tile, blocks a side, dtype, precision, device)."""
    dtype = torch_dtype(a.dtype)
    return (tile, a.shape[0] // tile, dtype, check_precision(precision or default_precision(dtype)),
            mesh_device(mesh))


def bdfac_1d(a, mesh: Optional[DeviceMesh] = None, *, tile: int = 256, precision=None,
             lookahead: bool = True, return_band: bool = False,
             collective_log: Optional[list] = None, schedule_log: Optional[list] = None):
    """Block bidiagonalization (compiler.lower.fused_bdfac's sweep) with
    ROW blocks of `tile` distributed block-cyclically over the mesh
    flattened row-major (global row block j on flat rank j mod P), each
    rank holding its blocks as a (slots * tile, n) stack: the full column
    extent is local, so the right-side (LQ) applies need no collective.

    Per step k, the collectives of the reference:

      1. ``qr_gram``: the QR panel's adaptive CholeskyQR chain
         (`_cholqr_adaptive(psum_mesh=mesh)`) all_reduces its Grams (one in
         the converged chain; extras passes fire only on breakdown) and
         broadcasts each host decision from the mesh's first rank;
         ``qr_q1``: the panel's top block, broadcast from its owner
         (`broadcast_flat`), so the Yamamoto S is the same bits on every
         rank;
      2. ``qr_w1``: Wᵀ·trailing, one all_reduce of (tile, n - c1) partial
         products, after which the two-sided update is local;
      3. ``lq_rowpan``: the owner's updated row panel, broadcast; every
         rank runs the row-form chain on it redundantly (no collective) and
         applies the row reflector to its own rows.

    The updates run on the live rows only (the reference masks full
    stacks: the same values), through `_matmul`/`_sub_matmul` (the matmul3
    kernel under compensated, the matmul kernel at "highest"); the tile² S
    inverses are `torch.linalg.inv_ex`. lookahead=True updates row block k
    alone first ("strip"), broadcasts the LQ panel, then runs the bulk
    update ("qr_bulk") before the LQ body. schedule_log receives ("strip" |
    "qr_bulk" | "lq_panel" | "lq_body", k), collective_log ("<kind>", k,
    floats a rank): the reference's lists.

    `a` is a host array (or a tensor), the same on every rank: each rank
    copies only its own row blocks. Returns the dense (n, n) block upper
    bidiagonal B (sigma(B) = sigma(a)) on every rank, or with
    return_band=True the (diag_blocks, super_blocks) lists of host (tile,
    tile) arrays (the last super block None), fetched block by block (one
    broadcast each), identical on every rank. Collective over the mesh."""
    n = _check_bdfac(a, tile, "bdfac_1d")
    mesh = mesh or make_mesh()
    t, nb, dtype, precision, dev = _bdfac_setup(a, tile, precision, mesh)
    p, me = mesh.size(), flat_index(mesh)
    nbl = -(-nb // p)                      # row-block slots a rank
    mine = range(me, nb, p)                # slot s holds global row block mine[s]
    nv = len(mine)
    a = _as_host(a)
    local = torch.zeros((nbl * t, n), dtype=dtype, device=dev)
    if nv:
        local[:nv * t].copy_(_host_or_tensor(a, _block_rows(mine, t), np.arange(n)))
    clog = collective_log if collective_log is not None else []
    slog = schedule_log if schedule_log is not None else []

    def from_owner(get, shape, owner):
        return _from_root(get, shape, owner, me == owner, mesh, dtype, dev)

    for k in range(nb):
        c0, c1 = k * t, (k + 1) * t
        owner, slot = k % p, k // p
        mine_k = me == owner
        own = slice(slot * t, (slot + 1) * t)
        s0, s1 = _first_slot(k, me, p, nv), _first_slot(k + 1, me, p, nv)
        live, body_rows = slice(s0 * t, nv * t), slice(s1 * t, nv * t)
        # QR panel: block column k's live rows, zeros elsewhere (a row
        # permutation of the global panel: the Gram is the same)
        pan = torch.zeros((nbl * t, t), dtype=dtype, device=dev)
        pan[live] = local[live, c0:c1]
        q, r_mat = _cholqr_adaptive(pan, precision=precision, psum_mesh=mesh, global_m=n - c0)
        clog.append(("qr_gram", k, t * t))
        q1 = from_owner(lambda: q[own], (t, t), owner)
        clog.append(("qr_q1", k, t * t))
        # the Yamamoto reflector, E's rows on the owner
        sigma, w, _, s = _yamamoto_reflector(q, q1, e_rows=own if mine_k else slice(0, 0))
        # panel columns -> E Sigma R on the owner; finished rows keep theirs
        local[live, c0:c1] = 0
        if mine_k:
            local[own, c0:c1] = sigma[:, None] * r_mat
        if k == nb - 1:
            break
        st = s.T
        trail = local[live, c1:]
        w1 = (_matmul(w[live], trail, ta=True, precision=precision) if s0 < nv
              else torch.zeros((t, n - c1), dtype=dtype, device=dev))
        sum_over_mesh(w1, mesh)
        clog.append(("qr_w1", k, t * (n - c1)))
        sw1 = _matmul(st, w1, precision=precision)
        do_lq = nb - k - 1 >= 2
        if lookahead and do_lq:
            # critical path first: row block k (the LQ panel's one input)
            slog.append(("strip", k))
            if mine_k:
                strip = local[own, c1:]
                _sub_matmul(strip, w[own], sw1, precision=precision, out=strip)
        else:
            slog.append(("qr_bulk", k))
            if s0 < nv:
                _sub_matmul(trail, w[live], sw1, precision=precision, out=trail)
        if not do_lq:
            continue  # a single superdiagonal block lands in the band as it is
        slog.append(("lq_panel", k))
        row_pan = from_owner(lambda: local[own, c1:], (t, n - c1), owner)
        clog.append(("lq_rowpan", k, t * (n - c1)))
        # the row-form chain, replicated: every rank has the same bits
        qr_, l_mat = _cholqr_adaptive(row_pan, rows=True, precision=precision)
        sig_r, wr, _, s_row = _yamamoto_reflector(qr_.T, qr_[:, :t].T)
        wr = wr.T
        body = local[body_rows, c1:]
        if lookahead:
            # the deferred bulk update: the live rows but row block k
            slog.append(("qr_bulk", k))
            if s1 < nv:
                _sub_matmul(body, w[body_rows], sw1, precision=precision, out=body)
        slog.append(("lq_body", k))
        if s1 < nv:
            u1 = _matmul(body, wr, tb=True, precision=precision)
            _sub_matmul(body, _matmul(u1, s_row, precision=precision), wr, precision=precision,
                        out=body)
        if mine_k:  # row block k -> [L Sigma_r | 0]
            row = local[own, c1:]
            row.zero_()
            row[:, :t] = l_mat * sig_r[None, :]

    if return_band:
        diags, sups = [], []
        for j in range(nb):
            s = j // p
            hi = min((j + 2) * t, n)
            win = from_owner(lambda: local[s * t:(s + 1) * t, j * t:hi], (t, hi - j * t),
                             j % p).cpu().numpy()
            diags.append(win[:, :t])
            sups.append(win[:, t:] if j + 1 < nb else None)
        return diags, sups
    out = torch.zeros((n, n), dtype=dtype, device=dev)
    for s, j in enumerate(mine):
        out[j * t:(j + 1) * t] = local[s * t:(s + 1) * t]
    del local
    return sum_over_mesh(out, mesh)


def bdfac_2d(a, mesh: Optional[DeviceMesh] = None, *, tile: int = 256, precision=None,
             lookahead: bool = True, return_band: bool = False,
             collective_log: Optional[list] = None, schedule_log: Optional[list] = None):
    """Block bidiagonalization over an (r x c) mesh with 2-D block-cyclic
    tiles (global block (i, j) on mesh rank (i mod r, j mod c)): the
    mesh-scalable form of `bdfac_1d`, each collective (tile, tile) or
    O(tile * n / mesh dim) floats a rank.

    QR phase of step k: the chain's Grams all_reduced over the mesh
    (``qr_gram``; mesh column k mod c holds the panel, the others add
    zeros), the top block broadcast from its owner (``qr_q1``), the
    reflector W broadcast along the cols axis from mesh column k mod c
    (``qr_wbcast``, n_loc_r * tile), Wᵀ·trailing all_reduced over the rows
    axis (``qr_w1``, tile * (n_loc_c - c1s)), then a local update. LQ
    phase: the mirror (``lq_gram``, ``lq_q1``; W_r broadcast along the rows
    axis from mesh row k mod r, ``lq_wrbcast``; body·W_rᵀ all_reduced over
    the cols axis, ``lq_u1``). The updates run over the reference's
    conservative static region (r0s, c1s, r1s, c1b: the slots below them
    are dead on every rank, so the products shrink with progress; the at
    most one stale block a dimension inside it is masked in the small
    operand), through `_matmul`/`_sub_matmul` (the matmul3 kernel under
    compensated, the matmul kernel at "highest"). lookahead, the logs, `a`
    and the results as in `bdfac_1d`. Collective over the mesh."""
    n = _check_bdfac(a, tile, "bdfac_2d")
    mesh = mesh or make_mesh()
    t, nb, dtype, precision, dev = _bdfac_setup(a, tile, precision, mesh)
    rows_ax, cols_ax = mesh.mesh_dim_names
    r, c = mesh.shape
    pi, pj = mesh.get_coordinate()
    nbr, nbc = -(-nb // r), -(-nb // c)
    n_loc_r, n_loc_c = nbr * t, nbc * t
    my_r, my_c = range(pi, nb, r), range(pj, nb, c)
    nvr, nvc = len(my_r), len(my_c)
    a = _as_host(a)
    # local block (s, q) = global block (pi + s*r, pj + q*c), zero past the grid
    local = torch.zeros((n_loc_r, n_loc_c), dtype=dtype, device=dev)
    if nvr and nvc:
        local[:nvr * t, :nvc * t].copy_(
            _host_or_tensor(a, _block_rows(my_r, t), _block_rows(my_c, t)))
    clog = collective_log if collective_log is not None else []
    slog = schedule_log if schedule_log is not None else []

    def slot(k, mine_, m, count):
        return min(max((k - mine_) // m, 0), count - 1)

    def root(i, j):
        return (i % r) * c + j % c

    def from_root(get, i, j, mine_):
        return _from_root(get, (t, t), root(i, j), mine_, mesh, dtype, dev)

    for k in range(nb):
        ok_col, ok_row = pj == k % c, pi == k % r
        s_k, t_k = slot(k, pi, r, nbr), slot(k, pj, c, nbc)
        own_r, own_c = slice(s_k * t, (s_k + 1) * t), slice(t_k * t, (t_k + 1) * t)
        live_r = slice(_first_slot(k, pi, r, nvr) * t, nvr * t)
        # ---- QR phase: block column k ----
        pan = torch.zeros((n_loc_r, t), dtype=dtype, device=dev)
        if ok_col:
            pan[live_r] = local[live_r, own_c]
        q, r_mat = _cholqr_adaptive(pan, precision=precision, psum_mesh=mesh, global_m=n - k * t)
        clog.append(("qr_gram", k, t * t))
        q1 = from_root(lambda: q[own_r], k, k, ok_row and ok_col)
        clog.append(("qr_q1", k, t * t))
        # the Yamamoto column reflector, E's rows on the owner
        sigma, w, _, s = _yamamoto_reflector(q, q1,
                                             e_rows=own_r if ok_row and ok_col else slice(0, 0))
        if ok_col:  # panel column -> E Sigma R on the owner; dead rows keep theirs
            local[live_r, own_c] = 0
            if ok_row:
                local[own_r, own_c] = sigma[:, None] * r_mat
        if k == nb - 1:
            break
        # W broadcast along the cols axis from mesh column k mod c
        my_w = broadcast_along(w, cols_ax, k % c, mesh)
        clog.append(("qr_wbcast", k, n_loc_r * t))
        st = s.T
        # the conservative static region: rows from r0s, columns from c1s
        r0s, c1s = (k // r) * t, ((k + 1) // c) * t
        trail = local[r0s:, c1s:]
        w1 = _matmul(my_w[r0s:], trail, ta=True, precision=precision)
        if r > 1:
            dist.all_reduce(w1, group=mesh.get_group(0))
        clog.append(("qr_w1", k, t * (n_loc_c - c1s)))
        sw1 = _matmul(st, w1, precision=precision)
        # the stale columns (global block <= k) masked in the small operand
        sw1[:, :_first_slot(k + 1, pj, c, nvc) * t - c1s] = 0
        sw1[:, max(nvc * t - c1s, 0):] = 0
        do_lq = nb - k - 1 >= 2
        if lookahead and do_lq:
            # critical path first: row block k alone, then the LQ panel's
            # collectives, then the bulk update
            slog.append(("strip", k))
            if ok_row:
                strip = local[own_r, c1s:]
                _sub_matmul(strip, my_w[own_r], sw1, precision=precision, out=strip)
        else:
            slog.append(("qr_bulk", k))
            _sub_matmul(trail, my_w[r0s:], sw1, precision=precision, out=trail)
        if not do_lq:
            continue  # the single superdiagonal block lands in the band as it is
        # ---- LQ phase: block row k ----
        t_k1 = slot(k + 1, pj, c, nbc)
        ok_col1 = pj == (k + 1) % c
        own_c1 = slice(t_k1 * t, (t_k1 + 1) * t)
        live_c = slice(_first_slot(k + 1, pj, c, nvc) * t, nvc * t)
        slog.append(("lq_panel", k))
        pan_r = torch.zeros((t, n_loc_c), dtype=dtype, device=dev)
        if ok_row:
            pan_r[:, live_c] = local[own_r, live_c]
        qr_, l_mat = _cholqr_adaptive(pan_r, rows=True, precision=precision, psum_mesh=mesh,
                                      global_m=(nb - k - 1) * t)
        clog.append(("lq_gram", k, t * t))
        q1r = from_root(lambda: qr_[:, own_c1], k, k + 1, ok_row and ok_col1)
        clog.append(("lq_q1", k, t * t))
        # the row reflector, broadcast along the rows axis from mesh row k mod r
        sig_r, wr, _, s_row = _yamamoto_reflector(
            qr_.T, q1r.T, e_rows=own_c1 if ok_row and ok_col1 else slice(0, 0))
        my_wr = broadcast_along(wr.T, rows_ax, k % r, mesh)
        clog.append(("lq_wrbcast", k, t * n_loc_c))
        if lookahead:
            # the deferred QR bulk update, without row block k
            slog.append(("qr_bulk", k))
            if ok_row:
                my_w[own_r] = 0
            _sub_matmul(trail, my_w[r0s:], sw1, precision=precision, out=trail)
        slog.append(("lq_body", k))
        r1s, c1b = ((k + 1) // r) * t, ((k + 1) // c) * t
        body = local[r1s:, c1b:]
        u1 = _matmul(body, my_wr[:, c1b:], tb=True, precision=precision)
        # rows of global block <= k (or past the grid) are not body rows
        u1[:_first_slot(k + 1, pi, r, nvr) * t - r1s] = 0
        u1[max(nvr * t - r1s, 0):] = 0
        if c > 1:
            dist.all_reduce(u1, group=mesh.get_group(1))
        clog.append(("lq_u1", k, (n_loc_r - r1s) * t))
        _sub_matmul(body, _matmul(u1, s_row, precision=precision), my_wr[:, c1b:],
                    precision=precision, out=body)
        if ok_row:  # block row k -> [L Sigma_r at block column k+1 | zeros]
            local[own_r, live_c] = 0
            if ok_col1:
                local[own_r, own_c1] = l_mat * sig_r[None, :]

    def blk(i, j):
        return local[(i // r) * t:(i // r + 1) * t, (j // c) * t:(j // c + 1) * t]

    def mine_blk(i, j):
        return pi == i % r and pj == j % c

    if return_band:
        diags, sups = [], []
        for j in range(nb):
            diags.append(from_root(lambda: blk(j, j), j, j, mine_blk(j, j)).cpu().numpy())
            sups.append(from_root(lambda: blk(j, j + 1), j, j + 1, mine_blk(j, j + 1))
                        .cpu().numpy() if j + 1 < nb else None)
        return diags, sups
    out = torch.zeros((n, n), dtype=dtype, device=dev)
    for i in my_r:
        for j in my_c:
            out[i * t:(i + 1) * t, j * t:(j + 1) * t] = blk(i, j)
    del local
    return sum_over_mesh(out, mesh)
