"""Blockwise binary ops, the pre-DSL path (counterpart of
numpywren_tpu/binops.py; the reference's numpywren/binops.py).

The reference submits blockwise map/reduce jobs through a pywren executor:
``gemm(pwex, A, B)`` maps ``block_matmul`` over (i, j, chunked-k) triples.
The same two-level API here:

- ``BlockExecutor`` stands in for the pywren executor (``pwex``): a thread
  pool with a futures-style ``map``/``wait``.
- Device-tier operands collapse to ONE op on the flat padded tensors (no
  per-block traffic): ``gemm`` is the port's ``ops.gemm.matmul`` (the
  matmul kernel's routing), the elementwise ops are torch ops.
- Host-tier operands run the blockwise map for real, block by block, on
  the CPU tiles: the out-of-device path.

Output keys use generate_key_name_binop, the reference's deterministic
output naming (numpywren/matrix_utils.py).
"""

from __future__ import annotations

import concurrent.futures
from typing import Callable, List, Optional, Sequence

import numpy as np

from numpywren_tpu_torch.exceptions import ShapeError
from numpywren_tpu_torch.ops.common import to_numpy
from numpywren_tpu_torch.tiled import TiledMatrix, _TiledBase
from numpywren_tpu_torch.utils import chunk, generate_key_name_binop, generate_key_name_uop


class BlockExecutor:
    """Thread-pool stand-in for the reference's pywren executor.

    ``map(fn, args)`` returns futures; ``wait(futures)`` blocks (the
    reference uses pywren.wait). num_workers mirrors Lambda fan-out width."""

    def __init__(self, num_workers: int = 8):
        self.num_workers = num_workers
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=num_workers)

    def map(self, fn: Callable, args: Sequence) -> List[concurrent.futures.Future]:
        return [self._pool.submit(fn, a) for a in args]

    @staticmethod
    def wait(futures: Sequence[concurrent.futures.Future]):
        done, not_done = concurrent.futures.wait(futures)
        for f in done:
            f.result()  # re-raise worker exceptions
        return done, not_done

    def shutdown(self):
        self._pool.shutdown(wait=True)


def default_executor(num_workers: int = 8) -> BlockExecutor:
    """Analog of pywren.default_executor()."""
    return BlockExecutor(num_workers=num_workers)


def _both_hbm(*mats: _TiledBase) -> bool:
    return all(getattr(m, "storage", None) == "hbm" for m in mats)


def _map_blocks(pwex: Optional[BlockExecutor], task, items, size: int):
    own = pwex is None
    pwex = pwex or default_executor()
    try:
        BlockExecutor.wait(pwex.map(task, list(chunk(items, max(1, size)))))
    finally:
        if own:
            pwex.shutdown()


def _host_out(key, shape, tile, like) -> TiledMatrix:
    return TiledMatrix(key=key, shape=shape, tile=tile, dtype=like.dtype, storage="host",
                       device=like.device)


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

def gemm(pwex: Optional[BlockExecutor], a: _TiledBase, b: _TiledBase, tasks_per_job: int = 1,
         out_key: Optional[str] = None, storage: Optional[str] = None) -> TiledMatrix:
    """C = A @ B, blockwise (reference binops.gemm(pwex, A, B, tasks_per_job)).

    Device tier: one matmul over the flat padded tensors. Host tier: the
    (i, j) output blocks are mapped over the executor, each task summing its
    full k-range in fp64 (tasks_per_job batches (i, j) pairs per task)."""
    if a.shape[1] != b.shape[0]:
        raise ShapeError(f"gemm shape mismatch: {a.shape} @ {b.shape}")
    if a.tile[1] != b.tile[0]:
        raise ShapeError(f"gemm tile mismatch: {a.tile} vs {b.tile}")
    key = out_key or generate_key_name_binop(a.key, b.key, "gemm")
    c_shape = (a.shape[0], b.shape[1])
    c_tile = (a.tile[0], b.tile[1])
    if storage is None:
        storage = "hbm" if _both_hbm(a, b) else "host"

    if storage == "hbm" and _both_hbm(a, b):
        from numpywren_tpu_torch.ops.gemm import matmul

        c = TiledMatrix(key=key, shape=c_shape, tile=c_tile, dtype=a.dtype, fill=None,
                        device=a.device)
        c.replace_array(matmul(a.array, b.array))
        return c

    c = _host_out(key, c_shape, c_tile, a)
    gk = a.grid[1]

    def block_matmul(pairs):
        for (i, j) in pairs:
            acc = None
            for k in range(gk):
                p = (to_numpy(a.get_block(i, k)).astype(np.float64)
                     @ to_numpy(b.get_block(k, j)).astype(np.float64))
                acc = p if acc is None else acc + p
            c.put_block(acc, i, j)  # cast to C's dtype on the way in

    pairs = [(i, j) for i in range(a.grid[0]) for j in range(b.grid[1])]
    _map_blocks(pwex, block_matmul, pairs, tasks_per_job)
    return c


# ---------------------------------------------------------------------------
# Elementwise binary / unary ops
# ---------------------------------------------------------------------------

def _elemwise_binop(pwex, a, b, np_op, torch_op, name: str, out_key=None) -> TiledMatrix:
    if a.shape != b.shape or a.tile != b.tile:
        raise ShapeError(f"{name}: operands must match, got {a.shape}/{a.tile} vs "
                         f"{b.shape}/{b.tile}")
    key = out_key or generate_key_name_binop(a.key, b.key, name)
    if _both_hbm(a, b):
        c = TiledMatrix(key=key, shape=a.shape, tile=a.tile, dtype=a.dtype, fill=None,
                        device=a.device)
        c.replace_array(torch_op(a.array, b.array))
        return c
    c = _host_out(key, a.shape, a.tile, a)

    def task(idxs):
        for (i, j) in idxs:
            c.put_block(np_op(to_numpy(a.get_block(i, j)), to_numpy(b.get_block(i, j))), i, j)

    _map_blocks(pwex, task, a.block_idxs, 8)
    return c


def add(pwex, a, b, **kw) -> TiledMatrix:
    import torch

    return _elemwise_binop(pwex, a, b, np.add, torch.add, "add", **kw)


def sub(pwex, a, b, **kw) -> TiledMatrix:
    import torch

    return _elemwise_binop(pwex, a, b, np.subtract, torch.sub, "sub", **kw)


def elemwise_uop(pwex, a, np_op, torch_op=None, name: str = "uop", out_key=None) -> TiledMatrix:
    """Apply an elementwise unary function blockwise (reference uops):
    `torch_op` on the device tier's flat tensor when given, else `np_op`
    block by block on the host tier."""
    key = out_key or generate_key_name_uop(a.key, name)
    if _both_hbm(a) and torch_op is not None:
        c = TiledMatrix(key=key, shape=a.shape, tile=a.tile, dtype=a.dtype, fill=None,
                        device=a.device)
        c.replace_array(torch_op(a.array))
        return c
    c = _host_out(key, a.shape, a.tile, a)

    def task(idxs):
        for (i, j) in idxs:
            c.put_block(np_op(to_numpy(a.get_block(i, j))), i, j)

    _map_blocks(pwex, task, a.block_idxs, 8)
    return c
