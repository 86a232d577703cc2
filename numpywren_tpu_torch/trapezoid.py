"""TrapezoidMatrix: lower-trapezoid column-block storage for SPD and
lower-triangular matrices, on PyTorch tensors.

Counterpart of numpywren_tpu/trapezoid.py. Each column super-panel's
at/below-diagonal region lives in its own tensor, so a trailing update is
one GEMM per later column block written into that block's buffer in place,
and symmetric data costs half the memory of a dense square (the reference's
BigSymmetricMatrix plays the same trick with lower-only S3 blocks).

JAX donates the column buffers to one jitted program; here the
factorization runs eagerly and writes into the buffers it is given.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from numpywren_tpu_torch.exceptions import ShapeError
from numpywren_tpu_torch.utils import cdiv
from numpywren_tpu_torch.ops.common import (
    as_tensor,
    check_precision,
    default_device,
    default_precision,
    to_numpy,
    torch_dtype,
)
from numpywren_tpu_torch.tiled import TiledMatrix, _anon_key, _TiledBase


class TrapezoidMatrix:
    """Column-block lower-trapezoid storage: block c holds rows
    [c*panel, n_pad) of columns [c*panel, (c+1)*panel) as one tensor."""

    def __init__(self, cols: Sequence[torch.Tensor], n: int, panel: int):
        self.n = int(n)
        self.panel = int(panel)
        self.nb = cdiv(self.n, self.panel)
        self.n_pad = self.nb * self.panel
        cols = list(cols)
        if len(cols) != self.nb:
            raise ShapeError(f"expected {self.nb} column blocks, got {len(cols)}")
        for c, arr in enumerate(cols):
            want = (self.n_pad - c * self.panel,
                    min(self.panel, self.n_pad - c * self.panel))
            if tuple(arr.shape) != want:
                raise ShapeError(f"column block {c}: expected {want}, got {tuple(arr.shape)}")
        self.cols = cols
        self.dtype = cols[0].dtype if cols else torch.float32
        self.device = cols[0].device if cols else torch.device("cpu")

    # ------------------------------------------------------------ builders
    @classmethod
    def from_array(cls, a, panel: int = 1024, *, device=None) -> "TrapezoidMatrix":
        """Copy the lower trapezoid out of a square ndarray or tensor (only
        the at/below-diagonal region is kept; `a` is left as it was)."""
        a = as_tensor(a, device=device)
        n = a.shape[0]
        if a.dim() != 2 or a.shape[1] != n:
            raise ShapeError(f"need a square array, got {tuple(a.shape)}")
        nb = cdiv(n, panel)
        n_pad = nb * panel
        if n_pad != n:
            pad = torch.zeros((n_pad, n_pad), dtype=a.dtype, device=a.device)
            pad[:n, :n] = a
            # identity on the padded diagonal keeps SPD inputs factorable
            idx = torch.arange(n, n_pad, device=a.device)
            pad[idx, idx] = 1
            a = pad
        cols = [a[c * panel:, c * panel:(c + 1) * panel].clone() for c in range(nb)]
        return cls(cols, n, panel)

    @classmethod
    def from_tiled(cls, m, panel: int = 1024) -> "TrapezoidMatrix":
        """From a TiledMatrix or TiledTrapezoidMatrix."""
        arr = m.array if m.storage == "hbm" else m.to_hbm().array
        return cls.from_array(arr[: m.shape[0], : m.shape[1]], panel=panel)

    @classmethod
    def from_block_fn(cls, block_fn: Callable, n: int, panel: int = 1024,
                      dtype=torch.float32, device=None) -> "TrapezoidMatrix":
        """Build from `block_fn(i, c) -> (panel, panel) array or tensor`,
        block row i of block column c (i >= c: only the lower trapezoid is
        asked for). Operands larger than half the card's memory can only be
        made this way: no flat (n, n) array ever exists."""
        nb = cdiv(n, panel)
        dtype = torch_dtype(dtype)
        cols = [torch.cat([as_tensor(block_fn(i, c), device=device, dtype=dtype)
                           for i in range(c, nb)], dim=0)
                for c in range(nb)]
        return cls(cols, n, panel)

    # ----------------------------------------------------------- accessors
    def to_array(self) -> torch.Tensor:
        """The flat (n, n) lower-triangular/trapezoid tensor."""
        out = torch.zeros((self.n_pad, self.n_pad), dtype=self.dtype, device=self.device)
        for c in range(self.nb):
            out[c * self.panel:, c * self.panel:c * self.panel + self.cols[c].shape[1]] = self.cols[c]
        # the diagonal blocks' strictly-upper region is dead storage
        return out.tril_()[: self.n, : self.n]

    def numpy(self) -> np.ndarray:
        return to_numpy(self.to_array())

    @property
    def nbytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self.cols)

    def block(self, c: int) -> torch.Tensor:
        return self.cols[c]

    def __repr__(self):
        return (f"TrapezoidMatrix(n={self.n}, panel={self.panel}, nb={self.nb}, "
                f"dtype={self.dtype}, device={self.device})")


class TiledTrapezoidMatrix(_TiledBase):
    """The trapezoid buffers behind the TiledMatrix block API
    (``storage == "trapezoid"``), so DSL programs bind the fastest tier
    directly (``cholesky(X, storage="trapezoid")``).

    With ``symmetric=True`` upper-triangle reads mirror-transpose the lower
    storage; with ``symmetric=False`` (a lower-triangular factor) they read
    as zeros. Tiles address the logical (i, j) grid of square ``tile``
    blocks; ``panel``, the physical column-block width, is a multiple of it.
    get_block returns a view of the buffer for lower-triangle tiles."""

    def __init__(
        self,
        trap: Optional[TrapezoidMatrix] = None,
        *,
        key: Optional[str] = None,
        n: Optional[int] = None,
        tile: int = 512,
        panel: int = 1024,
        dtype=torch.float32,
        symmetric: bool = False,
        device=None,
    ):
        if trap is None:
            if n is None:
                raise ShapeError("need either a TrapezoidMatrix or n")
            nb = cdiv(int(n), panel)
            n_pad = nb * panel
            dev = torch.device(device) if device is not None else default_device()
            cols = [torch.zeros((n_pad - c * panel, min(panel, n_pad - c * panel)),
                                dtype=torch_dtype(dtype), device=dev)
                    for c in range(nb)]
            trap = TrapezoidMatrix(cols, int(n), panel)
        self.trap = trap
        t = int(tile)
        if trap.panel % t != 0:
            raise ShapeError(f"tile {t} must divide panel {trap.panel}")
        self.key = key or _anon_key("trz")
        self.shape = (trap.n, trap.n)
        self.tile = (t, t)
        self.dtype = trap.dtype
        self.device = trap.device
        self.storage = "trapezoid"
        self.symmetric = symmetric
        self.parent_fn = None
        self._written = np.zeros(self.grid, dtype=bool)

    # -------------------------------------------------------- addressing
    def _locate(self, i: int, j: int):
        t = self.tile[0]
        c = (j * t) // self.trap.panel
        return c, i * t - c * self.trap.panel, j * t - c * self.trap.panel

    def get_block(self, i: int, j: int) -> torch.Tensor:
        self._check_idx(i, j)
        if i < j:
            if self.symmetric:
                return self.get_block(j, i).T
            return torch.zeros(self.tile, dtype=self.dtype, device=self.device)
        c, r0, c0 = self._locate(i, j)
        t = self.tile[0]
        return self.trap.cols[c][r0:r0 + t, c0:c0 + t]

    def put_block(self, arr, i: int, j: int):
        self._check_idx(i, j)
        if i < j:
            if self.symmetric:
                return self.put_block(as_tensor(arr, device=self.device).T, j, i)
            raise ShapeError(f"upper-triangle write ({i},{j}) to non-symmetric trapezoid tier")
        t = self.tile[0]
        blk = as_tensor(arr, device=self.device, dtype=self.dtype)
        if tuple(blk.shape) != (t, t):
            m, n = self.true_block_shape(i, j)
            if tuple(blk.shape) != (m, n):
                raise ShapeError(f"block ({i},{j}) of {self.key}: expected {(t, t)} or "
                                 f"{(m, n)}, got {tuple(blk.shape)}")
            full = torch.zeros((t, t), dtype=self.dtype, device=self.device)
            full[:m, :n] = blk
            blk = full
        c, r0, c0 = self._locate(i, j)
        self.trap.cols[c][r0:r0 + t, c0:c0 + t].copy_(blk)
        self._written[i, j] = True
        return (i, j)

    def delete_block(self, i: int, j: int):
        self._check_idx(i, j)
        if i >= j:
            self._written[i, j] = False
        elif self.symmetric:
            self._written[j, i] = False

    def block_exists(self, i: int, j: int) -> bool:
        if i >= j:
            return bool(self._written[i, j])
        return self.symmetric and bool(self._written[j, i])

    # ------------------------------------------------------------ lifecycle
    def adopt(self, trap: TrapezoidMatrix, written: bool = True,
              written_tile_cols: Optional[int] = None):
        """Take ownership of freshly computed column buffers (the fused
        cholesky_trapezoid commit path). written_tile_cols marks only the
        first so-many tile columns as computed (a truncate/prefix run: the
        trailing columns hold the Schur complement but do not "exist" for
        block_idxs_exist/resume purposes)."""
        if (trap.n, trap.panel) != (self.trap.n, self.trap.panel):
            raise ShapeError(f"adopt geometry mismatch: {(trap.n, trap.panel)} vs "
                             f"{(self.trap.n, self.trap.panel)}")
        self.trap = trap
        self.dtype, self.device = trap.dtype, trap.device
        if written:
            gm, _ = self.grid
            jmax = gm if written_tile_cols is None else int(written_tile_cols)
            for i in range(gm):
                self._written[i, : min(i + 1, jmax)] = True

    def free(self):
        self.trap.cols = [None] * self.trap.nb
        self._written[:] = False

    # ---------------------------------------------------------- conversions
    def to_array(self) -> torch.Tensor:
        """Flat logical (n, n) tensor: the lower factor (tril) or the mirrored
        full symmetric matrix."""
        lower = self.trap.to_array()
        if not self.symmetric:
            return lower
        return lower + lower.tril(-1).T

    def numpy(self) -> np.ndarray:
        return to_numpy(self.to_array())

    def to_hbm(self, sharding=None) -> TiledMatrix:
        """A flat device-tier TiledMatrix copy, laid out by `sharding` (a
        parallel.mesh.NamedSharding: each rank keeps its own block of the
        flat array that this device's tier assembles)."""
        out = TiledMatrix(key=self.key + ":hbm", shape=self.shape, tile=self.tile,
                          dtype=self.dtype, fill=None, device=self.device)
        arr = self.to_array()
        pm, pn = out.padded_shape
        if tuple(arr.shape) != (pm, pn):
            pad = torch.zeros((pm, pn), dtype=arr.dtype, device=arr.device)
            pad[: arr.shape[0], : arr.shape[1]] = arr
            if self.symmetric:  # keep the padded diagonal factorable
                idx = torch.arange(self.shape[0], pm, device=arr.device)
                pad[idx, idx] = 1
            arr = pad
        if sharding is not None:
            from numpywren_tpu_torch.parallel.mesh import as_dtensor, local_block

            arr = as_dtensor(local_block(arr, sharding).clone(), arr.shape, sharding)
        out.replace_array(arr, mark_written=False)
        out._written = (np.ones(out.grid, dtype=bool) if self.symmetric
                        else np.tril(np.ones(out.grid, dtype=bool)))
        return out

    @property
    def nbytes(self) -> int:
        return self.trap.nbytes


def _trapezoid_chol_fn(panel: int, tile: int, precision: str,
                       stop_panels: Optional[int] = None) -> Callable[[List[torch.Tensor]], None]:
    """The in-place factorization over a list of column buffers (the
    chol_cols schedule of compiler/lower.py run on the trapezoid buffers:
    no flat array ever exists).

    stop_panels < nb runs a PREFIX factorization (the reference's truncate,
    upstream:numpywren/algs.py cholesky): panels [0, stop_panels) are
    factored, later panels receive their trailing updates and keep the
    Schur complement, the LAPACK-style state a resume continues from."""
    from numpywren_tpu_torch.compiler.lower import _chol_columns

    def chol(cols: List[torch.Tensor]) -> None:
        _chol_columns(cols, panel, tile, precision, stop=stop_panels)

    return chol


def cholesky_trapezoid(t: TrapezoidMatrix, *, precision: Optional[str] = None,
                       stop_panels: Optional[int] = None) -> TrapezoidMatrix:
    """In-place blocked Cholesky over trapezoid storage: no flat
    conversions, one GEMM per trailing column block. CONSUMES `t`: its
    buffers become the result's, and `t.cols` is emptied.

    stop_panels runs a prefix factorization (reference truncate): panels
    beyond it come back holding the updated Schur complement."""
    precision = check_precision(precision or default_precision(t.dtype))
    tile = min(128, t.panel)  # TPU-measured; kept until measured on the GPU
    cols = list(t.cols)
    if any(c is None for c in cols):
        raise ValueError("TrapezoidMatrix was already consumed by a factorization")
    t.cols = [None] * t.nb
    _trapezoid_chol_fn(t.panel, tile, precision, stop_panels)(cols)
    return TrapezoidMatrix(cols, t.n, t.panel)
