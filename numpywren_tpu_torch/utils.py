"""Small shared helpers (analog of numpywren/utils.py + matrix_utils.py).

The reference's matrix_utils is mostly S3 key plumbing (list_all_keys,
key_exists, generate_key_name_binop). Here keys are in-process names; the
helpers that survive are name generation, index-space chunking, and
rounding/padding math used everywhere in the tiled layer.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def chunk(seq: Sequence, size: int) -> Iterator[List]:
    """Split a sequence into chunks of at most `size` (matrix_utils.chunk analog)."""
    it = iter(seq)
    while True:
        block = list(itertools.islice(it, size))
        if not block:
            return
        yield block


def hash_key(*parts) -> str:
    h = hashlib.sha1(repr(parts).encode()).hexdigest()[:16]
    return h


def generate_key_name_binop(a_key: str, b_key: str, op: str) -> str:
    """Deterministic output name for a binary op (matrix_utils analog)."""
    return f"{op}({a_key},{b_key})-{hash_key(a_key, b_key, op)}"


def generate_key_name_uop(a_key: str, op: str) -> str:
    return f"{op}({a_key})-{hash_key(a_key, op)}"


def block_key(base: str, idx: Tuple[int, ...]) -> str:
    """Per-block key codec (BigMatrix.__block_key__ analog)."""
    return base + "/" + "_".join(str(i) for i in idx)


def product_range(bounds: Iterable[Tuple[int, int]]) -> Iterator[Tuple[int, ...]]:
    """Cartesian product over [lo, hi) ranges."""
    ranges = [range(lo, hi) for lo, hi in bounds]
    return itertools.product(*ranges)


class LRUCache:
    """Bytes-capped LRU cache (the reference worker's per-process block cache,
    upstream:numpywren/job_runner.py cache_size — there it avoids S3
    re-reads; here the spill executor uses it to avoid host->HBM re-uploads
    of L panel strips)."""

    def __init__(self, max_bytes: int, size_fn=None):
        import collections

        self.max_bytes = max_bytes
        self.size_fn = size_fn or (lambda v: getattr(v, "nbytes", 0))
        self._d = collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key, value):
        size = self.size_fn(value)
        if size > self.max_bytes:
            return  # larger than the whole cache: don't thrash
        old = self._d.pop(key, None)
        if old is not None:
            self._bytes -= self.size_fn(old)
        self._d[key] = value
        self._bytes += size
        while self._bytes > self.max_bytes and self._d:
            _, ev = self._d.popitem(last=False)
            self._bytes -= self.size_fn(ev)

    def __len__(self):
        return len(self._d)

    @property
    def nbytes(self):
        return self._bytes


class MmapArray:
    """A numpy array backed by an on-disk memory map (reference
    matrix_utils.MmapArray): the landing buffer for matrices larger than
    host RAM when materializing a tiled matrix locally. Create, fill via
    `[...]` assignment, `flush()`, reopen later with `load()`."""

    def __init__(self, path: str, shape: Tuple[int, ...], dtype=np.float32,
                 mode: str = "w+"):
        self.path = str(path)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._arr = np.memmap(self.path, dtype=self.dtype, mode=mode,
                              shape=self.shape)

    @classmethod
    def load(cls, path: str, shape: Tuple[int, ...], dtype=np.float32):
        return cls(path, shape, dtype, mode="r+")

    def __getitem__(self, idx):
        return self._arr[idx]

    def __setitem__(self, idx, value):
        self._arr[idx] = value

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._arr)
        return a.astype(dtype) if dtype is not None else a

    def flush(self):
        self._arr.flush()

    @property
    def nbytes(self):
        return self._arr.nbytes


def get_local_matrix(m, out=None, mmap_path: str = None):
    """Materialize a tiled matrix into local memory block by block
    (reference matrix_utils.get_local_matrix): `out` may be any
    array-assignable buffer (e.g. an MmapArray for larger-than-RAM
    matrices, created automatically when `mmap_path` is given)."""
    from numpywren_tpu_torch.ops.common import np_dtype, to_numpy

    if out is None:
        dtype = np_dtype(m.dtype)
        out = (MmapArray(mmap_path, m.shape, dtype) if mmap_path
               else np.zeros(m.shape, dtype=dtype))
    tm, tn = m.tile
    for (i, j) in m.block_idxs:
        blk = to_numpy(m.get_block(i, j))  # a tile on any device
        # edge blocks come back full-tile (zero padded); crop to the logical
        # shape before assigning into the logically-shaped out buffer
        bm, bn = m.true_block_shape(i, j)
        out[i * tm : i * tm + bm, j * tn : j * tn + bn] = blk[:bm, :bn]
    if hasattr(out, "flush"):
        out.flush()
    return out


@functools.lru_cache(maxsize=1)
def host_gflops() -> float:
    """Measured host fp64 GEMM throughput in GFLOP/s (one ~20 ms probe,
    cached for the process; NPW_HOST_GFLOPS overrides — set it in tests
    or on hosts where a startup probe is unwelcome).

    Consumers use it to SCALE host-LAPACK cost estimates that were
    calibrated on the 1-core reference host (~15 GF/s dgemm; e.g. dense
    gesdd ~520 s at n=8192): a threaded-LAPACK host then shifts routing
    crossovers instead of silently inheriting 1-core defaults
    (models.svd._route_default_method)."""
    import os
    import time

    env = os.environ.get("NPW_HOST_GFLOPS")
    if env:
        return float(env)
    import numpy as np

    k = 384
    a = np.random.default_rng(0).standard_normal((k, k))
    a @ a  # BLAS warmup / page-in
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        a @ a
        best = min(best, time.perf_counter() - t0)
    return 2.0 * k ** 3 / best / 1e9
