"""Fabric: explicit collectives over a DeviceMesh (the first part).

Counterpart of numpywren_tpu/parallel/fabric.py. There, the panel
broadcast is a ``psum`` of a masked operand along a mesh axis inside
``shard_map``; here it is a ``dist.broadcast`` in the axis's process group,
and the local math runs on each rank's own block (``DTensor.to_local()``)
through the port's GEMM kernels, as the reference's shard_map keeps its
Pallas kernels.

Ported: ``broadcast_along``, ``summa_gemm`` and ``summa_syrk``. The rest of
the reference's fabric raises NotImplementedError naming its ROADMAP item:
the block-cyclic Cholesky, the sharded CholeskyQR and the butterfly TSQR
(Queue 1 #6b), the distributed BDFAC (#6c).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from numpywren_tpu_torch.compiler.lower import _matmul, _sub_matmul
from numpywren_tpu_torch.exceptions import ShapeError
from numpywren_tpu_torch.ops.common import check_precision, default_precision
from numpywren_tpu_torch.parallel.mesh import (
    as_dtensor,
    local_block,
    make_mesh,
    mesh_sharding,
    P,
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
# Not ported yet
# ---------------------------------------------------------------------------

def _not_ported(name: str, item: str):
    raise NotImplementedError(f"parallel.fabric.{name} is not ported yet (ROADMAP Queue 1 {item})")


def cholesky_1d(a, mesh=None, *, panel: int = 512, precision=None, lookahead: bool = True,
                gather: str = "device", schedule_log: Optional[list] = None):
    """Block-cyclic Cholesky over a 1-D mesh (ROADMAP Queue 1 #6b)."""
    _not_ported("cholesky_1d", "#6b")


def cholesky_2d(a, mesh=None, *, panel: int = 512, precision=None, lookahead: bool = True,
                gather: str = "device", schedule_log: Optional[list] = None,
                collective_log: Optional[list] = None):
    """Block-cyclic Cholesky over a 2-D mesh (ROADMAP Queue 1 #6b)."""
    _not_ported("cholesky_2d", "#6b")


def bdfac_1d(a, mesh=None, *, tile: int = 256, precision=None, lookahead: bool = True,
             return_band: bool = False, collective_log: Optional[list] = None,
             schedule_log: Optional[list] = None):
    """Distributed BDFAC over a 1-D mesh (ROADMAP Queue 1 #6c)."""
    _not_ported("bdfac_1d", "#6c")


def bdfac_2d(a, mesh=None, *, tile: int = 256, precision=None, lookahead: bool = True,
             return_band: bool = False, collective_log: Optional[list] = None,
             schedule_log: Optional[list] = None):
    """Distributed BDFAC over a 2-D mesh (ROADMAP Queue 1 #6c)."""
    _not_ported("bdfac_2d", "#6c")


def cholqr2_sharded(a, mesh=None, *, compute_q: bool = False, precision=None):
    """CholeskyQR2 over row shards (ROADMAP Queue 1 #6b)."""
    _not_ported("cholqr2_sharded", "#6b")


def cholqr3s_sharded(a, mesh=None, *, compute_q: bool = False, precision=None):
    """The shifted CholeskyQR chain over row shards (ROADMAP Queue 1 #6b)."""
    _not_ported("cholqr3s_sharded", "#6b")


def tsqr_butterfly(a, mesh=None, *, axis: Optional[str] = None, b_fac: int = 2,
                   _return_stacked: bool = False):
    """Butterfly TSQR across one mesh axis (ROADMAP Queue 1 #6b)."""
    _not_ported("tsqr_butterfly", "#6b")
