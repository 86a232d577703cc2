"""Mesh-sharded flagship algorithms, with explicit collectives.

Counterpart of numpywren_tpu/parallel/sharded.py. The JAX package jits the
fused single-device schedule with mesh shardings and lets GSPMD insert the
collectives (so it drops the Pallas kernels, which GSPMD cannot split).
PyTorch has no GSPMD: here each rank runs the schedule on its own block and
the data movement is written down, on broadcast and all_reduce only (the
two collectives every backend takes for a CUDA tensor). The local products
go through `_matmul` / `_sub_matmul`, so the GEMM kernels run: matmul3 under
compensated, matmul at "highest".

Every function here is collective over its mesh: each rank of the mesh
calls it with the same arguments (a host array, the same on every rank, of
which each rank copies only its own block; or a DTensor in the expected
layout). Results are DTensors; ``full_tensor()`` (or
``distributed.gather_to_hosts``) fetches one whole.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from numpywren_tpu_torch.compiler.lower import (
    _potrf,
    _rtrsm,
    _sub_matmul,
    _syrk_tril,
    _tsqr_matmul,
    fused_gemm,
    fused_tsqr,
)
from numpywren_tpu_torch.ops.common import check_precision, default_precision
from numpywren_tpu_torch.parallel.fabric import _as_host, broadcast_along
from numpywren_tpu_torch.parallel.mesh import (
    NamedSharding,
    as_dtensor,
    local_block,
    make_mesh,
    sum_over_mesh,
    tile_sharding,
)

# the leaf height of `_syrk_tril`'s recursion, as in compiler/lower.py
_LEAF_ROWS = 4096


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------

def sharded_cholesky(a, tile: int, mesh: Optional[DeviceMesh] = None, *,
                     truncate: int = 0, syrk_depth: int = 3, precision=None):
    """Blocked Cholesky of a flat padded (n, n) array in `tile_sharding`'s
    2-D block layout over `mesh`; returns the lower factor in the same
    layout (a DTensor), the strict upper triangle zero. The factorization
    is in place: a DTensor input (or a tensor on this rank's device) is
    overwritten, as the reference donates its input.

    Each rank's block must hold whole tiles (n divisible by tile times each
    mesh dimension). For each tile column k in turn:
      1. the owner of the diagonal tile factors it (`_potrf`);
      2. the factor is broadcast down the owner's mesh column;
      3. the owners of the panel rows below it solve (`_rtrsm`);
      4. the panel's row blocks are broadcast along the mesh rows, and the
         rows matching each mesh column's range are summed down the mesh
         columns (a masked all_reduce: a broadcast where the mesh is
         square);
      5. every rank updates its trailing blocks locally: a diagonal block
         by the recursive lower-only `_syrk_tril` (`syrk_depth` levels), a
         block below the diagonal by one `_sub_matmul`, a block above it
         not at all.
    truncate > 0 stops after g - truncate tile columns and leaves the
    updated Schur complement in the trailing ones, the strict upper
    triangle as it lies (the reference's prefix run). A diagonal tile that
    is not positive-definite raises torch.linalg.LinAlgError on every rank.
    Collective over the mesh."""
    mesh = mesh or make_mesh()
    n = a.shape[0]
    if a.shape[1] != n or n % tile:
        raise ValueError(f"a must be square with n a multiple of tile {tile}, got "
                         f"{tuple(a.shape)}")
    rr, cc = mesh.shape
    if n % (rr * tile) or n % (cc * tile):
        raise ValueError(f"n {n} must be a multiple of tile {tile} times each mesh "
                         f"dimension {tuple(mesh.shape)}: each rank's block holds whole tiles")
    precision = check_precision(precision or default_precision(a.dtype))
    rows_ax, cols_ax = mesh.mesh_dim_names
    sh = tile_sharding(mesh)
    loc = local_block(_as_host(a), sh)
    p, q = mesh.get_coordinate()
    hr, hc = n // rr, n // cc
    r0, c0 = p * hr, q * hc   # this rank's block: rows [r0, r0 + hr), cols [c0, c0 + hc)
    infos: List[torch.Tensor] = []
    for k in range(n // tile - truncate):
        k0, k1 = k * tile, (k + 1) * tile
        pk, qk = k0 // hr, k0 // hc   # the mesh row and column owning tile (k, k)
        below = max(k1 - r0, 0)       # this rank's first local row below tile k
        if q == qk:
            col = loc[:, k0 - c0:k1 - c0]
            if p == pk:
                ld = _potrf(col[k0 - r0:k1 - r0], infos).contiguous()
                col[k0 - r0:k1 - r0].copy_(ld)
            else:
                ld = loc.new_empty((tile, tile))
            broadcast_along(ld, rows_ax, pk, mesh)
            if below < hr:
                _rtrsm(col[below:], ld, tile, precision)
            prow = torch.zeros((hr, tile), dtype=loc.dtype, device=loc.device)
            prow[below:] = col[below:]
        else:
            prow = loc.new_empty((hr, tile))
        broadcast_along(prow, cols_ax, qk, mesh)  # P_k's rows [r0, r0 + hr), zero above k1
        # P_k's rows [c0, c0 + hc): each mesh row adds its overlap with them
        pcol = torch.zeros((hc, tile), dtype=loc.dtype, device=loc.device)
        lo, hi = max(r0, c0), min(r0 + hr, c0 + hc)
        if lo < hi:
            pcol[lo - c0:hi - c0] = prow[lo - r0:hi - r0]
        if rr > 1:
            dist.all_reduce(pcol, group=mesh.get_group(rows_ax))
        # the trailing update of this rank's block, lower triangle only
        t0 = max(k1, c0)              # first trailing column in this block
        if t0 >= c0 + hc or r0 + hr <= t0:
            continue
        if r0 == c0 and hr == hc:     # a diagonal block
            j = t0 - r0
            _syrk_tril(loc, prow[j:], j, j, hr - j, syrk_depth, tile, precision, _LEAF_ROWS)
        else:
            i0 = max(t0, r0)          # rows above t0 hold only upper-triangle entries
            c_hi = min(c0 + hc, r0 + hr)  # columns past the last row are upper
            blk = loc[i0 - r0:, t0 - c0:c_hi - c0]
            _sub_matmul(blk, prow[i0 - r0:], pcol[t0 - c0:c_hi - c0], tb=True,
                        precision=precision, out=blk)
    bad = torch.zeros(1, dtype=torch.float32, device=loc.device)
    if infos:
        bad += (torch.stack(infos) != 0).any().float()
    if float(sum_over_mesh(bad, mesh)[0]) > 0:
        raise torch.linalg.LinAlgError(
            "sharded_cholesky: a diagonal tile is not positive-definite")
    if truncate == 0:
        loc.tril_(r0 - c0)  # zero where the global column exceeds the row
    return as_dtensor(loc, (n, n), sh)


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

def sharded_gemm(a, b, mesh: Optional[DeviceMesh] = None, *, precision=None):
    """C = A @ B with A row-sharded, B col-sharded, C 2-D sharded: the
    stationary layout where each rank computes its C block from a row
    panel of A and a column panel of B (`_matmul` at the precision), with
    no communication. Collective over the mesh only in that every rank
    calls it."""
    mesh = mesh or make_mesh()
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    precision = check_precision(precision or default_precision(a.dtype))
    a_loc = local_block(_as_host(a), NamedSharding(mesh, (Shard(0), Replicate())))
    b_loc = local_block(_as_host(b), NamedSharding(mesh, (Replicate(), Shard(1))))
    c = fused_gemm(a_loc, b_loc, precision=precision)
    return as_dtensor(c, (a.shape[0], b.shape[1]), tile_sharding(mesh))


# ---------------------------------------------------------------------------
# TSQR
# ---------------------------------------------------------------------------

def sharded_tsqr(a, tile_rows: int, mesh: Optional[DeviceMesh] = None, *,
                 compute_q: bool = False, precision=None):
    """TSQR over the tall axis: the rows are sharded over the whole mesh
    (flattened) when the leaf count divides by its size, else over the mesh
    rows (each row of ranks computing its block's R alike). Each rank runs
    the port's fused TSQR tree on its own rows (leaves of tile_rows where
    they divide its block, else its block as one leaf); the ranks' b x b R
    factors are gathered (a masked all_reduce), stacked in row order and
    factored by ONE QR, whose R is the result (replicated, in fused_tsqr's
    sign convention). With compute_q each rank forms its rows of Q as its
    local Q times its block of the combine's Q. Returns R, or (Q, R), as
    DTensors. Collective over the mesh."""
    mesh = mesh or make_mesh()
    m, b = a.shape
    if m % tile_rows:
        raise ValueError(f"rows {m} not a multiple of tile_rows {tile_rows}")
    precision = check_precision(precision or default_precision(a.dtype))
    n_leaves = m // tile_rows
    flat = n_leaves % mesh.size() == 0
    sh = NamedSharding(mesh, (Shard(0), Shard(0) if flat else Replicate()))
    loc = local_block(_as_host(a), sh)
    p, q = mesh.get_coordinate()
    rr, cc = mesh.shape
    slot, slots = (p * cc + q, rr * cc) if flat else (p, rr)
    rows = loc.shape[0]
    if rows < b:  # QR of [X; 0] has the same R
        loc_qr = torch.cat([loc, loc.new_zeros((b - rows, b))])
    else:
        loc_qr = loc
    leaf = tile_rows if loc_qr.shape[0] % tile_rows == 0 and tile_rows >= b else loc_qr.shape[0]
    out = fused_tsqr(loc_qr, leaf, compute_q=compute_q, precision=precision)
    q_loc, r_loc = out if compute_q else (None, out)
    stack = loc.new_zeros((slots, b, b))
    if flat or q == 0:  # one rank of each row of replicas adds its R
        stack[slot] = r_loc
    sum_over_mesh(stack, mesh)
    q_c, r = torch.linalg.qr(stack.reshape(slots * b, b), mode="reduced")
    r_out = as_dtensor(r, (b, b), NamedSharding(mesh, (Replicate(), Replicate())))
    if not compute_q:
        return r_out
    q_rows = _tsqr_matmul(q_loc[:rows], q_c[slot * b:(slot + 1) * b], precision=precision)
    return as_dtensor(q_rows, (m, b), sh), r_out
