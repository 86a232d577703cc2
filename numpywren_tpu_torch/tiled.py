"""TiledMatrix: the tiled-array store on PyTorch tensors.

Counterpart of numpywren_tpu/tiled.py (itself a rebuild of the reference's
numpywren/matrix.py BigMatrix). A matrix lives on one device as ONE padded
tensor, so tile (i, j) is the view ``data[i*Tm:(i+1)*Tm, j*Tn:(j+1)*Tn]``
and a contiguous tile region is a strided view: the lowering reads and
writes whole panels in place, with no gather or scatter.

Tensors are mutable, so put_block writes into the array directly where the
JAX store stages tiles for one batched scatter, and get_block returns a
view (do not write through it).

Two tiers, named as in the JAX package:

- ``storage="hbm"``: the device tier, one padded tensor on ``device``.
- ``storage="host"``: a dict of CPU tiles with the reference store's sparse
  semantics (a missing block falls back to ``parent_fn`` or raises
  BlockNotFoundError). It is the spill tier of the executors: ``device``
  names the device its tiles are computed on (the card by default), and the
  tiles are pinned when that device is CUDA, so copies to and from it can
  run asynchronously.

``TiledSymmetricMatrix`` keeps the lower triangle on the host tier and
mirrors both triangles on the device tier.

API parity with BigMatrix: get_block / put_block / delete_block /
block_idxs / block_idxs_exist / block_idxs_not_exist / blocks / numpy() /
submatrix / .T / free, plus parent_fn lazy aliasing.
"""

from __future__ import annotations

import itertools
import threading
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from numpywren_tpu_torch.exceptions import BlockNotFoundError, ShapeError
from numpywren_tpu_torch.utils import cdiv, hash_key
from numpywren_tpu_torch.ops.common import as_tensor, default_device, np_dtype, to_numpy, torch_dtype

Idx = Tuple[int, int]

_anon_counter = itertools.count(1)  # next() is atomic under the GIL


def _anon_key(prefix: str) -> str:
    n = next(_anon_counter)
    return f"{prefix}-{n}-{hash_key(prefix, n)}"


class _TiledBase:
    """Shared interface for TiledMatrix and its views (transpose/submatrix)."""

    key: str
    shape: Tuple[int, int]
    tile: Tuple[int, int]
    dtype: torch.dtype

    # ---- derived geometry -------------------------------------------------
    @property
    def grid(self) -> Tuple[int, int]:
        """Number of tiles along each dim (BigMatrix num blocks analog)."""
        return (cdiv(self.shape[0], self.tile[0]), cdiv(self.shape[1], self.tile[1]))

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return (self.grid[0] * self.tile[0], self.grid[1] * self.tile[1])

    def true_block_shape(self, i: int, j: int) -> Tuple[int, int]:
        """Unpadded shape of edge blocks (stored zero/identity padded)."""
        gm, gn = self.grid
        m = self.tile[0] if i < gm - 1 else self.shape[0] - i * self.tile[0]
        n = self.tile[1] if j < gn - 1 else self.shape[1] - j * self.tile[1]
        return (m, n)

    def _check_idx(self, i: int, j: int):
        gm, gn = self.grid
        if not (0 <= i < gm and 0 <= j < gn):
            raise ShapeError(f"block index ({i},{j}) outside grid {self.grid} of {self.key}")

    # ---- enumeration (parity: block_idxs / blocks) -------------------------
    @property
    def block_idxs(self) -> List[Idx]:
        gm, gn = self.grid
        return [(i, j) for i in range(gm) for j in range(gn)]

    @property
    def blocks(self) -> List[Tuple[slice, slice]]:
        """Element-space slices per block (logical, cropped at edges)."""
        out = []
        for (i, j) in self.block_idxs:
            m, n = self.true_block_shape(i, j)
            out.append((slice(i * self.tile[0], i * self.tile[0] + m),
                        slice(j * self.tile[1], j * self.tile[1] + n)))
        return out

    @property
    def block_idxs_exist(self) -> List[Idx]:
        return [idx for idx in self.block_idxs if self.block_exists(*idx)]

    @property
    def block_idxs_not_exist(self) -> List[Idx]:
        return [idx for idx in self.block_idxs if not self.block_exists(*idx)]

    # ---- abstract ----------------------------------------------------------
    def get_block(self, i: int, j: int):
        raise NotImplementedError

    def put_block(self, arr, i: int, j: int):
        raise NotImplementedError

    def delete_block(self, i: int, j: int):
        raise NotImplementedError

    def block_exists(self, i: int, j: int) -> bool:
        raise NotImplementedError

    # ---- views --------------------------------------------------------------
    @property
    def T(self) -> "_TiledBase":
        return TransposeView(self)

    def submatrix(self, row_blocks, col_blocks) -> "_TiledBase":
        """View over a block-index range (BigMatrix.submatrix analog)."""
        return SubmatrixView(self, _as_range(row_blocks, self.grid[0]),
                             _as_range(col_blocks, self.grid[1]))

    # ---- validation -----------------------------------------------------------
    def assert_finite(self, label: str = ""):
        """Raise if any existing block holds NaN/Inf."""
        for (i, j) in self.block_idxs_exist:
            if not bool(torch.isfinite(self.get_block(i, j)).all()):
                raise FloatingPointError(
                    f"{label or self.key}: non-finite values in block ({i},{j}) "
                    f"(non-SPD input to cholesky? singular panel?)")
        return self

    # ---- materialization ------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """Materialize to a local numpy array of the logical shape."""
        out = np.zeros(self.shape, dtype=np_dtype(self.dtype))
        for (i, j) in self.block_idxs:
            m, n = self.true_block_shape(i, j)
            blk = to_numpy(self.get_block(i, j))[:m, :n]
            out[i * self.tile[0]:i * self.tile[0] + m, j * self.tile[1]:j * self.tile[1] + n] = blk
        return out

    def __repr__(self):
        return (f"{type(self).__name__}(key={self.key!r}, shape={self.shape}, "
                f"tile={self.tile}, grid={self.grid}, dtype={self.dtype})")


def _as_range(r, n: int) -> range:
    if isinstance(r, range):
        return r
    if isinstance(r, slice):
        return range(*r.indices(n))
    if isinstance(r, int):
        return range(r, r + 1)
    return range(r[0], r[1])


class TiledMatrix(_TiledBase):
    """A tiled (M, N) matrix on the device tier (one padded tensor on
    `device`) or the host tier (a dict of CPU tiles computed on `device`).

    Parameters mirror BigMatrix.__init__(key, shape, shard_sizes, dtype,
    parent_fn) where they apply. On the device tier reads are dense: an
    unwritten block reads back as ``fill`` or via ``parent_fn``, but
    ``block_exists`` means *computed* (only put_block / replace_array mark
    a block), the reference's block_idxs_exist resume contract;
    ``fill=None`` makes a read of an unwritten block without parent_fn raise
    BlockNotFoundError, and the padded tensor is allocated at first use. On
    the host tier a block exists once it is put; a missing one falls back
    to parent_fn (not stored) or raises BlockNotFoundError."""

    def __init__(
        self,
        key: Optional[str] = None,
        shape: Tuple[int, int] = None,
        tile: Tuple[int, int] = (512, 512),
        dtype=torch.float32,
        storage: str = "hbm",
        parent_fn: Optional[Callable] = None,
        fill: Optional[float] = 0.0,
        device=None,
    ):
        if shape is None:
            raise ShapeError("shape is required")
        if storage not in ("hbm", "host"):
            raise ValueError(f"unknown storage tier {storage!r}")
        self.key = key or _anon_key("tm")
        self.shape = tuple(int(s) for s in shape)
        self.tile = tuple(int(t) for t in tile)
        self.dtype = torch_dtype(dtype)
        self.device = torch.device(device) if device is not None else default_device()
        self.storage = storage
        self.parent_fn = parent_fn
        self._lock = threading.Lock()
        if storage == "host":
            self._tiles: Dict[Idx, torch.Tensor] = {}
            return
        # _written = "computed"; _cached = parent_fn results staged into the
        # array for fast re-reads, which do NOT exist for resume purposes
        self._written = np.zeros(self.grid, dtype=bool)
        self._cached = np.zeros(self.grid, dtype=bool)
        self._fill = fill
        self._data: Optional[torch.Tensor] = None

    @property
    def array(self) -> torch.Tensor:
        """The padded flat tensor (device tier). Fused executors overwrite
        it in place or commit a new one with replace_array()."""
        if self.storage != "hbm":
            raise ValueError("array only available for hbm storage; use to_hbm()")
        if self._data is None:
            self._data = torch.full(self.padded_shape, self._fill or 0.0,
                                    dtype=self.dtype, device=self.device)
        return self._data

    def replace_array(self, new_array: torch.Tensor, mark_written: bool = True):
        if self.storage != "hbm":
            raise ValueError("replace_array only for hbm storage")
        if tuple(new_array.shape) != self.padded_shape:
            raise ShapeError(f"expected padded shape {self.padded_shape}, "
                             f"got {tuple(new_array.shape)}")
        self._data = new_array
        self.dtype, self.device = new_array.dtype, new_array.device
        if mark_written:
            self._written[:] = True
            self._cached[:] = False

    def _tile_view(self, i: int, j: int) -> torch.Tensor:
        ti, tj = self.tile
        return self.array[i * ti:(i + 1) * ti, j * tj:(j + 1) * tj]

    # ------------------------------------------------------------- get/put
    def get_block(self, i: int, j: int) -> torch.Tensor:
        """Tile (i, j), always full tile-shaped (edge blocks padded): a view
        of the device tier's tensor, or the host tier's CPU tile.

        Reference behavior (matrix.py::get_block): on a miss, delegate to
        parent_fn (lazy aliasing of scratch onto inputs), else error."""
        self._check_idx(i, j)
        if self.storage == "host":
            with self._lock:
                blk = self._tiles.get((i, j))
            if blk is None:
                blk = self._padded(self._fallback(i, j), i, j, torch.device("cpu"))
            return blk
        if not (self._written[i, j] or self._cached[i, j]):
            if self.parent_fn is not None:
                # stage the fallback so repeated reads hit, but do NOT mark
                # the block computed (parent_fn reads never write back)
                self._tile_view(i, j).copy_(self._padded(self.parent_fn(self, i, j), i, j))
                self._cached[i, j] = True
            elif self._fill is None:
                raise BlockNotFoundError(
                    f"block ({i},{j}) of {self.key} does not exist and no parent_fn")
        return self._tile_view(i, j)

    def _fallback(self, i: int, j: int):
        if self.parent_fn is not None:
            return self.parent_fn(self, i, j)
        raise BlockNotFoundError(f"block ({i},{j}) of {self.key} does not exist and no parent_fn")

    def _padded(self, arr, i: int, j: int, device=None) -> torch.Tensor:
        device = device if device is not None else self.device
        blk = as_tensor(arr, device=device, dtype=self.dtype)
        ti, tj = self.tile
        if tuple(blk.shape) == (ti, tj):
            return blk
        m, n = self.true_block_shape(i, j)
        if tuple(blk.shape) != (m, n):
            accepted = f"{(ti, tj)}" if (m, n) == (ti, tj) else f"{(ti, tj)} or edge shape {(m, n)}"
            raise ShapeError(f"block ({i},{j}) of {self.key}: expected {accepted}, "
                             f"got {tuple(blk.shape)}")
        out = torch.zeros((ti, tj), dtype=self.dtype, device=device)
        out[:m, :n] = blk
        return out

    def _host_tile(self, arr, i: int, j: int) -> torch.Tensor:
        """An owned CPU copy of `arr` as tile (i, j), pinned when the tier
        computes on a CUDA device."""
        src = arr.device if isinstance(arr, torch.Tensor) else torch.device("cpu")
        blk = self._padded(arr, i, j, src)
        out = torch.empty(self.tile, dtype=self.dtype, pin_memory=self.device.type == "cuda")
        return out.copy_(blk)

    def put_block(self, arr, i: int, j: int):
        """Store tile (i, j). Accepts full-tile or true-edge-shaped arrays;
        idempotent (deterministic location), like the reference's S3 puts."""
        self._check_idx(i, j)
        if self.storage == "host":
            blk = self._host_tile(arr, i, j)
            with self._lock:
                self._tiles[(i, j)] = blk
            return (i, j)
        self._tile_view(i, j).copy_(self._padded(arr, i, j))
        self._written[i, j] = True
        return (i, j)

    def adopt_block(self, blk: torch.Tensor, i: int, j: int):
        """Store the CPU tensor `blk` itself as tile (i, j) of the host tier,
        with no copy: a full tile of the store's dtype (a contiguous view of
        a larger pinned buffer is fine) that the store owns from here on.
        The out-of-core Cholesky's writer adopts views of one pinned slab a
        panel instead of pinning each tile apart."""
        self._check_idx(i, j)
        if (self.storage != "host" or blk.device.type != "cpu" or tuple(blk.shape) != self.tile
                or blk.dtype != self.dtype or not blk.is_contiguous()):
            raise ShapeError(f"adopt_block({i},{j}) of {self.key}: needs a contiguous CPU "
                             f"{self.dtype} tile {self.tile} on the host tier, got "
                             f"{blk.device} {blk.dtype} {tuple(blk.shape)}")
        with self._lock:
            self._tiles[(i, j)] = blk
        return (i, j)

    def delete_block(self, i: int, j: int):
        self._check_idx(i, j)
        if self.storage == "host":
            with self._lock:
                self._tiles.pop((i, j), None)
            return
        was = self._written[i, j] or self._cached[i, j]
        self._written[i, j] = False
        self._cached[i, j] = False
        if was and self._fill is not None and self._data is not None:
            self._tile_view(i, j).fill_(self._fill)  # a dense read sees the fill

    def block_exists(self, i: int, j: int) -> bool:
        if self.storage == "host":
            return (i, j) in self._tiles
        return bool(self._written[i, j])

    def free(self):
        """Drop the storage (BigMatrix.free/delete analog)."""
        if self.storage == "host":
            with self._lock:
                self._tiles.clear()
            return
        self._data = None
        self._written[:] = False
        self._cached[:] = False

    # --------------------------------------------------------- tier moves
    def to_hbm(self) -> "TiledMatrix":
        """A copy on the device tier of `device` (spill-in). Blocks that do
        not exist are staged from parent_fn (not marked computed)."""
        out = TiledMatrix(key=self.key + ":hbm", shape=self.shape, tile=self.tile,
                          dtype=self.dtype, device=self.device, parent_fn=self.parent_fn,
                          fill=self._fill if self.storage == "hbm" else 0.0)
        if self.storage == "hbm":
            out.replace_array(self.array.clone())
            out._written = self._written.copy()
            out._cached = self._cached.copy()
            return out
        ti, tj = self.tile
        arr = torch.zeros(self.padded_shape, dtype=self.dtype, device=self.device)
        with self._lock:
            tiles = dict(self._tiles)
        for (i, j), blk in tiles.items():
            arr[i * ti:(i + 1) * ti, j * tj:(j + 1) * tj].copy_(blk, non_blocking=True)
        out.replace_array(arr, mark_written=False)
        for (i, j) in tiles:
            out._written[i, j] = True
        if self.parent_fn is not None:  # the copy reads what this tier reads
            for (i, j) in self.block_idxs:
                if (i, j) not in tiles:
                    out.get_block(i, j)
        return out

    def to_host(self) -> "TiledMatrix":
        """A copy on the host tier (spill-out): the computed blocks."""
        out = TiledMatrix(key=self.key + ":host", shape=self.shape, tile=self.tile,
                          dtype=self.dtype, storage="host", parent_fn=self.parent_fn,
                          device=self.device)
        if self.storage == "host":
            with self._lock:
                out._tiles = dict(self._tiles)
            return out
        for (i, j) in self.block_idxs:
            if self._written[i, j]:
                out._tiles[(i, j)] = out._host_tile(self._tile_view(i, j), i, j)
        return out


class TiledSymmetricMatrix(TiledMatrix):
    """Symmetric matrix keeping only the lower triangle on the host tier
    (BigSymmetricMatrix parity: (i, j) -> (j, i) with a transpose on read).
    The device tier mirrors writes into both triangles so region ops can
    slice either side, at 2x the memory of the half-memory trapezoid tier
    (``storage="trapezoid"`` on the alg_wrappers), which a one-time
    UserWarning points to."""

    _hbm_warned = False

    def __init__(self, key=None, shape=None, tile=(512, 512), dtype=torch.float32,
                 storage="host", **kw):
        if shape is None or shape[0] != shape[1]:
            raise ShapeError("symmetric matrix must be square")
        if tile[0] != tile[1]:
            raise ShapeError("symmetric matrix requires square tiles")
        if storage == "hbm" and not TiledSymmetricMatrix._hbm_warned:
            TiledSymmetricMatrix._hbm_warned = True
            warnings.warn(
                "TiledSymmetricMatrix(storage='hbm') mirrors both triangles (2x memory). "
                "For SPD factorizations use the half-memory trapezoid tier instead: "
                "alg_wrappers.cholesky(..., storage='trapezoid').", UserWarning, stacklevel=2)
        super().__init__(key=key, shape=shape, tile=tile, dtype=dtype, storage=storage, **kw)

    @staticmethod
    def _canonical(i: int, j: int) -> Tuple[int, int, bool]:
        return (i, j, False) if i >= j else (j, i, True)

    def get_block(self, i: int, j: int):
        ci, cj, flip = self._canonical(i, j)
        blk = super().get_block(ci, cj)
        return blk.T if flip else blk

    def put_block(self, arr, i: int, j: int):
        ci, cj, flip = self._canonical(i, j)
        blk = as_tensor(arr, device=arr.device if isinstance(arr, torch.Tensor) else "cpu")
        blk = blk.T if flip else blk
        super().put_block(blk, ci, cj)
        if self.storage == "hbm" and ci != cj:
            # mirror into the upper triangle so the flat array is truly symmetric
            super().put_block(blk.T, cj, ci)
        return (ci, cj)

    def adopt_block(self, blk: torch.Tensor, i: int, j: int):
        ci, cj, flip = self._canonical(i, j)
        if flip:  # an upper tile lands transposed in the lower triangle: a copy
            return self.put_block(blk, i, j)
        return super().adopt_block(blk, ci, cj)

    def block_exists(self, i: int, j: int) -> bool:
        ci, cj, _ = self._canonical(i, j)
        return super().block_exists(ci, cj)

    def delete_block(self, i: int, j: int):
        ci, cj, _ = self._canonical(i, j)
        super().delete_block(ci, cj)
        if self.storage == "hbm" and ci != cj:
            super().delete_block(cj, ci)


class TransposeView(_TiledBase):
    """Zero-copy transpose view (BigMatrix.T analog)."""

    def __init__(self, parent: _TiledBase):
        self.parent = parent
        self.key = parent.key + ".T"
        self.shape = (parent.shape[1], parent.shape[0])
        self.tile = (parent.tile[1], parent.tile[0])
        self.dtype = parent.dtype
        self.device = parent.device

    def get_block(self, i, j):
        self._check_idx(i, j)
        return self.parent.get_block(j, i).T

    def put_block(self, arr, i, j):
        self._check_idx(i, j)
        return self.parent.put_block(arr.T, j, i)

    def delete_block(self, i, j):
        return self.parent.delete_block(j, i)

    def block_exists(self, i, j):
        return self.parent.block_exists(j, i)

    @property
    def T(self):
        return self.parent


class SubmatrixView(_TiledBase):
    """Block-range view (BigMatrix.submatrix analog; block-index space)."""

    def __init__(self, parent: _TiledBase, rows: range, cols: range):
        self.parent = parent
        self.rows = rows
        self.cols = cols
        self.key = f"{parent.key}[{rows.start}:{rows.stop},{cols.start}:{cols.stop}]"
        self.tile = parent.tile
        # logical shape: full tiles except possibly the parent's edge tiles
        m = sum(parent.true_block_shape(i, cols.start)[0] for i in rows)
        n = sum(parent.true_block_shape(rows.start, j)[1] for j in cols)
        self.shape = (m, n)
        self.dtype = parent.dtype
        self.device = parent.device

    def _map(self, i, j):
        return self.rows.start + i, self.cols.start + j

    def get_block(self, i, j):
        self._check_idx(i, j)
        return self.parent.get_block(*self._map(i, j))

    def put_block(self, arr, i, j):
        self._check_idx(i, j)
        return self.parent.put_block(arr, *self._map(i, j))

    def delete_block(self, i, j):
        return self.parent.delete_block(*self._map(i, j))

    def block_exists(self, i, j):
        return self.parent.block_exists(*self._map(i, j))
