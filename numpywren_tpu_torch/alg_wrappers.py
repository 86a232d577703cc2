"""One-call algorithm entry points (counterpart of
numpywren_tpu/alg_wrappers.py; the reference's numpywren/alg_wrappers.py).

Each wrapper allocates output and scratch matrices, compiles the DSL
program (the port's own numpywren_tpu_torch.frontend), binds the tile-grid
sizes, and returns (program, output(s), meta). `run_program` executes it.

As in the reference, the device tier ("hbm") materializes version 0 of a
scratch matrix as a copy of the input, while the host tier ("host") keeps
the lazy parent_fn aliasing of the scratch onto the input (matrix.py
parent_fn). `device=None` keeps a tensor where it is and puts an ndarray on
the current CUDA device (a host without one raises: pass device="cpu"); on
the host tier it names the device the tiles are computed on.

The templates are the package's own (`_template`), so their binds defer
the schedule (`ProgramTemplate.defer_schedule`): the fused lowering never
reads it, and a generic executor, a checkpoint or a report builds it at
its first read. An input that the schedule would refuse is checked here
instead (cholesky's `truncate`), so it still raises at bind.

Each entry is a `bind` span (metrics.span) around the compile's
`bind.program` and, in cholesky and tsqr, `bind.store` (wrapping or copying
the input) and `bind.alloc` (the outputs); the program keeps the span's
trace id for run_program's `run` span, under which `bind.schedule` opens
where a generic executor builds the schedule.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from numpywren_tpu_torch import algs
from numpywren_tpu_torch.exceptions import CompilationError, ShapeError
from numpywren_tpu_torch.frontend import lpcompile
from numpywren_tpu_torch.frontend.ir import BoundArg
from numpywren_tpu_torch.matrix_init import shard_matrix
from numpywren_tpu_torch.metrics import new_trace, span
from numpywren_tpu_torch.ops.common import as_tensor, to_numpy
from numpywren_tpu_torch.runtime.executor import run_program  # noqa: F401  (re-export)
from numpywren_tpu_torch.tiled import TiledMatrix, _TiledBase
from numpywren_tpu_torch.utils import cdiv
from numpywren_tpu_torch.trapezoid import TiledTrapezoidMatrix, TrapezoidMatrix

MatLike = Union[np.ndarray, torch.Tensor, _TiledBase, TrapezoidMatrix]

_templates: Dict[str, object] = {}


def _own(template):
    """Mark a template of the package's: its binds defer the schedule."""
    template.defer_schedule = True
    return template


def _template(name: str):
    if name not in _templates:
        _templates[name] = _own(lpcompile(getattr(algs, name)))
    return _templates[name]


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _as_tiled(x: MatLike, tile, storage: str, device) -> _TiledBase:
    return shard_matrix(x, tile=tile, storage=storage, device=device) if _is_array(x) else x


def _zeros_parent(m, i, j):
    return torch.zeros(m.tile, dtype=m.dtype)


def _new(key, shape, tile, like, storage: str, lazy: bool = False) -> TiledMatrix:
    """An output or scratch matrix on `like`'s device and dtype. An unwritten
    block reads as zeros: the device tier's fill (allocated at first use;
    `lazy` leaves it unfilled, so an unwritten read raises) or the host
    tier's parent_fn."""
    if storage == "hbm":
        return TiledMatrix(key=key, shape=shape, tile=tile, dtype=like.dtype,
                           fill=None if lazy else 0.0, device=like.device)
    return TiledMatrix(key=key, shape=shape, tile=tile, dtype=like.dtype, storage=storage,
                       parent_fn=_zeros_parent, device=like.device)


def _bind_span(entry):
    """The entry as one `bind` span under a new trace id, which the
    returned program keeps (`trace_id`) for its `run` span."""
    @functools.wraps(entry)
    def bind(*args, **kw):
        trace = new_trace()
        with span("bind", trace=trace):
            out = entry(*args, **kw)
        out[0].trace_id = trace
        return out

    return bind


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

@_bind_span
def cholesky(X: MatLike, tile=None, storage: str = "hbm", truncate: int = 0,
             panel: int = 1024, device=None):
    """Blocked Cholesky: returns (program, L_matrix, meta).

    X: SPD matrix (ndarray, tensor, TiledMatrix, or with
    storage="trapezoid" a TrapezoidMatrix). The scratch S holds the trailing
    matrix; version 0 is a copy of X on the device tier and a lazy parent_fn
    alias of X on the host tier.

    storage="trapezoid" binds the half-memory lower-trapezoid column-block
    tier (the fastest path): the fused lowering runs cholesky_trapezoid on
    the column buffers; `panel` is the physical column-block width. Binding
    an existing TrapezoidMatrix hands its buffers to the factorization,
    which overwrites them. `device=None` keeps a tensor where it is and puts
    an ndarray on the current CUDA device (a host without one raises: pass
    device="cpu")."""
    if storage == "trapezoid":
        return _cholesky_trapezoid_bind(X, tile, truncate, panel, device)
    tile = _default_tile(X, tile)
    if tile[0] != tile[1]:
        raise ShapeError("cholesky requires square tiles")
    with span("bind.store"):
        x_t = _as_tiled(X, tile, storage, device)
        if x_t.shape[0] != x_t.shape[1]:
            raise ShapeError(f"cholesky requires a square matrix, got {x_t.shape}")
        if storage == "hbm":
            s = TiledMatrix(key=x_t.key + ":chol_S", shape=x_t.shape, tile=tile,
                            dtype=x_t.dtype, fill=None, device=x_t.device)
            # S is overwritten by the factorization: it never shares X's buffer
            arr = x_t.to_hbm().array if x_t.storage != "hbm" else x_t.array.clone()
            s.replace_array(_identity_pad_diag(arr, x_t))
        else:
            s = TiledMatrix(key=x_t.key + ":chol_S", shape=x_t.shape, tile=tile,
                            dtype=x_t.dtype, storage="host", parent_fn=_spd_parent(x_t),
                            device=x_t.device)
    g = x_t.grid[0]

    with span("bind.alloc"):
        # the upper-triangle blocks of L are never written: they read as zeros
        o = _new(x_t.key + ":chol_L", x_t.shape, tile, x_t, storage)

    program = _template("cholesky").bind(
        O=o, S=BoundArg(name="S", matrix=s, versioned=True), N=g, truncate=truncate
    )
    if truncate < 0:
        # the schedule's own refusal: step g would factor S[g, g] at version g
        raise CompilationError(
            f"cholesky: truncate {truncate} < 0 runs past the {g}-tile grid: "
            f"S[{g}, {g}] is read at version {g}, which nothing writes")
    meta = {"input": x_t, "scratch": s, "tile": tile, "grid": g}
    return program, o, meta


def _cholesky_trapezoid_bind(X, tile, truncate: int, panel: int, device):
    """Bind a cholesky program over the trapezoid storage tier
    (upstream:numpywren/matrix.py::BigSymmetricMatrix's half-memory store)."""
    with span("bind.store"):
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
    with span("bind.alloc"):
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


def _spd_parent(x_t):
    """parent_fn of the host-tier S: X's block (X's own tile, read only:
    pinned tiles stay pinned for their copies to the card), with 1s on the
    padded diagonal of an edge diagonal block (a copy; the padded tile stays
    SPD)."""
    def parent(m, i, j):
        blk = x_t.get_block(i, j)
        bm, _ = m.true_block_shape(i, j)
        if i == j and bm < m.tile[0]:
            blk = blk.clone()
            idx = torch.arange(bm, m.tile[0])
            blk[idx, idx] = 1.0
        return blk

    return parent


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


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

@_bind_span
def gemm(A: MatLike, B: MatLike, tile=None, storage: str = "hbm",
         k_chunk: Optional[int] = None, device=None):
    """Blocked GEMM: returns (program, C_matrix, meta) with C = A @ B.

    k_chunk: tiles accumulated serially per chunk before the log-depth
    chunk-reduce tree of the DSL program (reference binops.py's chunking).
    Default bounds scratch at <= 8 partials per output tile
    (k_chunk = cdiv(K, 8)). The fused lowering runs one product and never
    allocates that scratch. `device` as in cholesky."""
    tile = _default_tile(A, tile)
    a_t = _as_tiled(A, tile, storage, device)
    b_t = _as_tiled(B, tile, storage, device)
    if a_t.shape[1] != b_t.shape[0]:
        raise ShapeError(f"gemm shape mismatch: {a_t.shape} @ {b_t.shape}")
    if a_t.tile[1] != b_t.tile[0]:
        raise ShapeError("gemm requires matching inner tile sizes")
    if a_t.device != b_t.device:
        raise ShapeError(f"gemm operands on {a_t.device} and {b_t.device}")
    m, k = a_t.grid
    _, n = b_t.grid
    c_tile = (a_t.tile[0], b_t.tile[1])
    if k_chunk is None:
        k_chunk = max(1, cdiv(k, 8))
    q = max(1, min(int(k_chunk), k))
    nc = cdiv(k, q)
    depth, live = 0, nc
    while live > 1:
        live = cdiv(live, 2)
        depth += 1

    c = _new("gemm_C", (a_t.shape[0], b_t.shape[1]), c_tile, a_t, storage)
    # lazy: the fused runner never touches the partials
    p = _new("gemm_P", (m * n * c_tile[0], nc * c_tile[1]), c_tile, a_t, storage, lazy=True)
    program = _template("gemm").bind(
        A=a_t, B=b_t, C=c, P=BoundArg(name="P", matrix=p, versioned=True),
        M=m, N=n, K=k, NC=nc, Q=q, L=depth,
    )
    return program, c, {"tile": tile, "grid": (m, n, k),
                        "k_chunk": q, "chunks": nc, "tree_depth": depth}


# ---------------------------------------------------------------------------
# TSQR
# ---------------------------------------------------------------------------

def _template_tsqr_kary(b_fac: int):
    """Generated k-ary TSQR template (R path): the `reducer` construct with
    branching factor b_fac > 2, generated per b_fac because the reducer
    expansion is static."""
    name = f"tsqr_b{b_fac}"
    if name not in _templates:
        src = (
            f"def {name}(A, Q0, R, N, L):\n"
            f"    for i in range(0, N):\n"
            f"        Q0[i, 0], R[i, 0] = qr_leaf(A[i, 0])\n"
            f"    reducer(R, qr_combine_r, copy, N, L, b_fac={b_fac})\n"
        )
        _templates[name] = _own(lpcompile(src))
    return _templates[name]


@_bind_span
def tsqr(X: MatLike, tile_rows: int = 4096, storage: str = "hbm",
         compute_q: bool = False, method: str = "tree", b_fac: int = 2, device=None):
    """Tall-skinny QR via tree reduction (reference alg_wrappers.tsqr).

    X: (m, b) with m >> b; row blocks of `tile_rows` rows form the leaves.
    Returns (program, outputs, meta): outputs["R"] holds the final (b, b) R
    at block outputs["R_block"], outputs["Q"] (if compute_q) the thin Q.
    method: "tree" (Householder combine tree), "cholqr2" or "cholqr3s"
    (see compiler.lower.fused_tsqr). b_fac is the combine tree's branching
    factor; compute_q needs b_fac=2 (the DSL template's Q sweep is binary).
    `device` as in cholesky."""
    if _is_array(X):
        m, b = X.shape
        tile_rows = min(tile_rows, m)
        with span("bind.store"):
            a_t = shard_matrix(X, tile=(tile_rows, b), storage=storage, device=device)
    else:
        a_t = X
        m, b = a_t.shape
        tile_rows = a_t.tile[0]
    if a_t.grid[1] != 1:
        raise ShapeError("tsqr expects a single tile column (m x b, b == tile width)")
    if b_fac < 2:
        raise ValueError(f"b_fac must be >= 2, got {b_fac}")
    if b_fac != 2 and compute_q:
        raise ShapeError("compute_q requires b_fac=2 on the DSL path")
    n_leaves = a_t.grid[0]
    depth, m_live = 0, n_leaves
    while m_live > 1:  # depth = ceil(log_b n_leaves), exactly
        m_live = cdiv(m_live, b_fac)
        depth += 1

    def new(key, shape, tile):
        # allocated at first use: the fused lowering writes only R (and Q)
        return _new(key, shape, tile, a_t, storage)

    half = (max(1, cdiv(n_leaves, 2)) * b, max(1, depth) * b)
    with span("bind.alloc"):
        q0 = new("tsqr_Q0", (n_leaves * tile_rows, b), (tile_rows, b))
        r = new("tsqr_R", (n_leaves * b, (depth + 1) * b), (b, b))
        if b_fac == 2:
            qt, qb = new("tsqr_QT", half, (b, b)), new("tsqr_QB", half, (b, b))
        if b_fac == 2 and compute_q:
            z = new("tsqr_Z", (n_leaves * b, (depth + 1) * b), (b, b))
            q = new("tsqr_Q", (n_leaves * tile_rows, b), (tile_rows, b))
    outputs = {"R": r, "R_block": (0, depth), "Q0": q0}
    if b_fac != 2:
        program = _template_tsqr_kary(b_fac).bind(A=a_t, Q0=q0, R=r, N=n_leaves, L=depth)
    elif compute_q:
        program = _template("tsqr_q").bind(
            A=a_t, Q0=q0, R=r, QT=qt, QB=qb, Z=z, Q=q, N=n_leaves, L=depth)
        outputs["Q"] = q
    else:
        program = _template("tsqr").bind(A=a_t, Q0=q0, R=r, QT=qt, QB=qb, N=n_leaves, L=depth)
    program.fused_options = {"tsqr_method": method, "b_fac": b_fac}
    meta = {"n_leaves": n_leaves, "depth": depth, "tile_rows": tile_rows, "b": b,
            "logical_m": m, "b_fac": b_fac}
    return program, outputs, meta


# ---------------------------------------------------------------------------
# BDFAC (block bidiagonalization)
# ---------------------------------------------------------------------------

@_bind_span
def bdfac(X: MatLike, tile=None, storage: str = "hbm", device=None):
    """Block bidiagonalization: returns (program, B_matrix, meta).

    B is block upper bidiagonal with the singular values of X (orthogonal
    QR/LQ sweeps, reference alg_wrappers.bdfac). Requires a square tile
    grid. run_program's "auto" runs it through the fused lowering
    (compiler.lower.fused_bdfac); "jax", "spill" and "local" run the
    generic schedule. `device` as in cholesky."""
    tile = _default_tile(X, tile)
    if tile[0] != tile[1]:
        raise ShapeError("bdfac requires square tiles")
    x_t = _as_tiled(X, tile, storage, device)
    gm, gn = x_t.grid
    if gm != gn:
        raise ShapeError(f"bdfac requires a square tile grid, got {x_t.grid}")
    n, t, dt, dev = gm, tile[0], x_t.dtype, x_t.device

    def new(key, grid):
        return _new(x_t.key + ":" + key, (grid[0] * t, grid[1] * t), tile, x_t, storage)

    # S starts as a copy of X (version 0); the sweeps rewrite it in place
    if storage == "hbm":
        s = TiledMatrix(key=x_t.key + ":bd_S", shape=x_t.shape, tile=tile, dtype=dt,
                        fill=None, device=dev)
        s.replace_array(x_t.to_hbm().array if x_t.storage != "hbm" else x_t.array.clone())
    else:
        s = TiledMatrix(key=x_t.key + ":bd_S", shape=x_t.shape, tile=tile, dtype=dt,
                        storage="host", parent_fn=lambda m, i, j: x_t.get_block(i, j),
                        device=dev)
    b = new("bd_B", (n, n))
    scr = {"RA": new("bd_RA", (n, 1)), "LA": new("bd_LA", (n, 1)),
           "CA": new("bd_CA", (n, n)), "DA": new("bd_DA", (n, n))}
    for q in ("QTT", "QTB", "QBT", "QBB", "PTT", "PTB", "PBT", "PBB"):
        scr[q] = new("bd_" + q, (n, n))
    program = _template("bdfac").bind(
        S=BoundArg(name="S", matrix=s, versioned=True),
        B=b,
        RA=BoundArg(name="RA", matrix=scr["RA"], versioned=True),
        CA=BoundArg(name="CA", matrix=scr["CA"], versioned=True),
        LA=BoundArg(name="LA", matrix=scr["LA"], versioned=True),
        DA=BoundArg(name="DA", matrix=scr["DA"], versioned=True),
        QTT=scr["QTT"], QTB=scr["QTB"], QBT=scr["QBT"], QBB=scr["QBB"],
        PTT=scr["PTT"], PTB=scr["PTB"], PBT=scr["PBT"], PBB=scr["PBB"],
        N=n,
    )
    meta = {"input": x_t, "scratch": scr, "tile": tile, "grid": n}
    return program, b, meta


def tsqr_r_factor(outputs) -> np.ndarray:
    """The final R as numpy (upper-triangular b x b)."""
    i, l = outputs["R_block"]
    return to_numpy(outputs["R"].get_block(i, l))
