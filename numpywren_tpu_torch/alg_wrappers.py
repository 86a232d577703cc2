"""One-call algorithm entry points (counterpart of
numpywren_tpu/alg_wrappers.py; the reference's numpywren/alg_wrappers.py).

Each wrapper allocates output and scratch matrices, compiles the DSL
program (the shared numpywren_tpu.frontend), binds the tile-grid sizes, and
returns (program, output, meta). `run_program` executes it. Only cholesky
and cholesky_solve are ported so far.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from numpywren_tpu import algs
from numpywren_tpu.exceptions import ShapeError
from numpywren_tpu.frontend import lpcompile
from numpywren_tpu.frontend.ir import BoundArg
from numpywren_tpu_torch.matrix_init import shard_matrix
from numpywren_tpu_torch.ops.common import as_tensor, to_numpy
from numpywren_tpu_torch.runtime.executor import run_program  # noqa: F401  (re-export)
from numpywren_tpu_torch.tiled import TiledMatrix, _TiledBase
from numpywren_tpu_torch.trapezoid import TiledTrapezoidMatrix, TrapezoidMatrix

MatLike = Union[np.ndarray, torch.Tensor, _TiledBase, TrapezoidMatrix]

_templates: Dict[str, object] = {}


def _template(name: str):
    if name not in _templates:
        _templates[name] = lpcompile(getattr(algs, name))
    return _templates[name]


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _default_tile(x: MatLike, tile) -> Tuple[int, int]:
    if tile is not None:
        return tuple(tile)
    if _is_array(x):
        t = min(512, *x.shape)
        return (t, t)
    return x.tile


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------

def cholesky(X: MatLike, tile=None, storage: str = "hbm", truncate: int = 0,
             panel: int = 1024, device=None):
    """Blocked Cholesky: returns (program, L_matrix, meta).

    X: SPD matrix (ndarray, tensor, TiledMatrix, or with
    storage="trapezoid" a TrapezoidMatrix). The scratch S holds the trailing
    matrix; version 0 is a copy of X on the device tier.

    storage="trapezoid" binds the half-memory lower-trapezoid column-block
    tier (the fastest path): the fused lowering runs cholesky_trapezoid on
    the column buffers; `panel` is the physical column-block width. Binding
    an existing TrapezoidMatrix hands its buffers to the factorization,
    which overwrites them. `device=None` keeps a tensor where it is and puts
    an ndarray on the current CUDA device (CPU without one)."""
    if storage == "trapezoid":
        return _cholesky_trapezoid_bind(X, tile, truncate, panel, device)
    if storage != "hbm":
        raise NotImplementedError(
            f"storage={storage!r}: the host tier is not ported yet "
            f"(ROADMAP Queue 1: host tier and spill)")
    tile = _default_tile(X, tile)
    if tile[0] != tile[1]:
        raise ShapeError("cholesky requires square tiles")
    x_t = shard_matrix(X, tile=tile, device=device) if _is_array(X) else X
    if x_t.shape[0] != x_t.shape[1]:
        raise ShapeError(f"cholesky requires a square matrix, got {x_t.shape}")
    g = x_t.grid[0]

    o = TiledMatrix(key=x_t.key + ":chol_L", shape=x_t.shape, tile=tile,
                    dtype=x_t.dtype, device=x_t.device)
    s = TiledMatrix(key=x_t.key + ":chol_S", shape=x_t.shape, tile=tile,
                    dtype=x_t.dtype, fill=None, device=x_t.device)
    # S is overwritten by the factorization: it never shares X's buffer
    arr = x_t.to_hbm().array if x_t.storage != "hbm" else x_t.array.clone()
    s.replace_array(_identity_pad_diag(arr, x_t))

    program = _template("cholesky").bind(
        O=o, S=BoundArg(name="S", matrix=s, versioned=True), N=g, truncate=truncate
    )
    meta = {"input": x_t, "scratch": s, "tile": tile, "grid": g}
    return program, o, meta


def _cholesky_trapezoid_bind(X, tile, truncate: int, panel: int, device):
    """Bind a cholesky program over the trapezoid storage tier
    (upstream:numpywren/matrix.py::BigSymmetricMatrix's half-memory store)."""
    if isinstance(X, TiledTrapezoidMatrix):
        s_m = X
        panel = X.trap.panel
    else:
        if isinstance(X, TrapezoidMatrix):
            trap = X
            panel = trap.panel
        elif _is_array(X):
            trap = TrapezoidMatrix.from_array(X, panel=panel, device=device)
        elif hasattr(X, "get_block"):  # a TiledMatrix
            trap = TrapezoidMatrix.from_tiled(X, panel=panel)
        else:
            raise ShapeError(f"cannot bind {type(X).__name__} as trapezoid")
        tile_n = tile[0] if tile is not None else min(512, panel)
        if panel % tile_n != 0:
            raise ShapeError(f"tile {tile_n} must divide panel {panel}")
        s_m = TiledTrapezoidMatrix(trap, tile=tile_n, symmetric=True, key="chol_S")
    g = s_m.grid[0]
    if truncate:
        # prefix runs stop at a physical panel boundary (the factorization
        # is in place per column block): the factored prefix
        # (g - truncate) * tile must cover whole panels
        n_done = (g - truncate) * s_m.tile[0]
        if not 0 < n_done <= s_m.shape[0] or n_done % s_m.trap.panel != 0:
            raise ShapeError(
                f"trapezoid truncate must leave a panel-aligned prefix: "
                f"(grid {g} - truncate {truncate}) * tile {s_m.tile[0]} = "
                f"{n_done} is not a multiple of panel {s_m.trap.panel}; "
                f"choose tile/panel/truncate accordingly")
    # version 0 of S is the input itself: the lower-triangle blocks exist
    for i in range(g):
        s_m._written[i, : i + 1] = True
    o = TiledTrapezoidMatrix(n=s_m.shape[0], tile=s_m.tile[0], panel=panel,
                             dtype=s_m.dtype, symmetric=False, device=s_m.device,
                             key=s_m.key + ":chol_L")
    program = _template("cholesky").bind(
        O=o, S=BoundArg(name="S", matrix=s_m, versioned=True), N=g, truncate=truncate,
    )
    meta = {"input": s_m, "scratch": s_m, "tile": s_m.tile, "grid": g, "panel": panel}
    return program, o, meta


def _identity_pad_diag(arr: torch.Tensor, x_t) -> torch.Tensor:
    """Put 1s on the padded diagonal (in place) so padded potrf tiles stay
    SPD: the factor of diag(A, I) is diag(L, I)."""
    n_log, n_pad = x_t.shape[0], x_t.padded_shape[0]
    if n_pad > n_log:
        idx = torch.arange(n_log, n_pad, device=arr.device)
        arr[idx, idx] += 1
    return arr


def cholesky_solve(l: _TiledBase, b):
    """Solve A x = b given A's lower Cholesky factor `l` (the matrix
    cholesky() returned, after run_program): two triangular solves on l's
    device. `b` is (n,) or (n, k), an ndarray (the result is one too) or a
    tensor."""
    n = l.shape[0]
    want_numpy = not isinstance(b, torch.Tensor)
    l_arr = l.array if l.storage == "hbm" else l.to_hbm().array
    rhs = as_tensor(b, device=l_arr.device, dtype=l_arr.dtype)
    squeeze = rhs.dim() == 1
    if squeeze:
        rhs = rhs[:, None]
    if rhs.shape[0] != n:
        raise ShapeError(f"rhs rows {rhs.shape[0]} != matrix dim {n}")
    # the logical block alone: padding never enters the solve
    l_n = l_arr[:n, :n]
    y = torch.linalg.solve_triangular(l_n, rhs, upper=False)
    x = torch.linalg.solve_triangular(l_n.T, y, upper=True)
    x = x[:, 0] if squeeze else x
    return to_numpy(x) if want_numpy else x
