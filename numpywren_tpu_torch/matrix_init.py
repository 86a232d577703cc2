"""Creating TiledMatrices from local data (counterpart of
numpywren_tpu/matrix_init.py; the reference's matrix_init.shard_matrix puts
each block to S3, here the device tier is one padded transfer and the host
tier a dict of CPU tiles)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from numpywren_tpu_torch.ops.common import as_tensor, default_device, torch_dtype
from numpywren_tpu_torch.tiled import TiledMatrix, TiledSymmetricMatrix


def shard_matrix(
    arr,
    tile: Tuple[int, int] = (512, 512),
    key: Optional[str] = None,
    storage: str = "hbm",
    symmetric: bool = False,
    dtype=None,
    device=None,
    sharding=None,
) -> TiledMatrix:
    """A TiledMatrix holding `arr` (an ndarray or a tensor), zero-padded to
    whole tiles. `device=None` keeps a tensor where it is and puts an
    ndarray on the current CUDA device (a host without one raises: pass
    device="cpu"); on the host tier `device` is where the tiles are
    computed. symmetric=True gives a TiledSymmetricMatrix: the lower
    triangle's tiles on the host tier, both triangles mirrored (and an
    identity on the padded diagonal) on the device tier.

    `sharding` (a parallel.mesh.NamedSharding) lays the device tier out over
    a mesh: each rank copies only its own block of `arr` (the same array on
    every rank) to its device; on the host tier it is the layout to_hbm()
    gives by default."""
    cls = TiledSymmetricMatrix if symmetric else TiledMatrix
    if storage == "host":
        if device is None:
            device = arr.device if isinstance(arr, torch.Tensor) else default_device()
        t = as_tensor(arr, device="cpu", dtype=dtype)
        out = cls(key=key, shape=tuple(t.shape), tile=tile, dtype=t.dtype, storage="host",
                  fill=None, device=device, sharding=sharding)
        for (i, j) in out.block_idxs:
            if symmetric and j > i:
                continue
            m, n = out.true_block_shape(i, j)
            out.put_block(t[i * tile[0]:i * tile[0] + m, j * tile[1]:j * tile[1] + n], i, j)
        return out
    if sharding is not None:
        return _shard_over_mesh(cls, arr, tile, key, symmetric, dtype, sharding)
    t = as_tensor(arr, device=device, dtype=dtype)
    out = cls(key=key, shape=tuple(t.shape), tile=tile, dtype=t.dtype,
              storage=storage, fill=None, device=t.device)
    pm, pn = out.padded_shape
    if tuple(t.shape) != (pm, pn):
        pad = torch.zeros((pm, pn), dtype=t.dtype, device=t.device)
        pad[: t.shape[0], : t.shape[1]] = t
        if symmetric:  # keep the padded matrix SPD-compatible
            idx = torch.arange(t.shape[0], pm, device=t.device)
            pad[idx, idx] = 1.0
        t = pad
    elif t is arr or (isinstance(arr, np.ndarray) and t.device.type == "cpu"):
        t = t.clone()  # the store owns its buffer: fused runs overwrite it
    out.replace_array(t)
    return out


def _shard_over_mesh(cls, arr, tile, key, symmetric, dtype, sharding) -> TiledMatrix:
    """The device tier of `arr` over a mesh, each rank building only its own
    block of the padded array."""
    from numpywren_tpu_torch.parallel.mesh import as_dtensor, local_box, mesh_device

    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    dev = mesh_device(sharding.mesh)
    dtype = torch_dtype(dtype if dtype is not None else arr.dtype)
    m, n = arr.shape
    out = cls(key=key, shape=(m, n), tile=tile, dtype=dtype, storage="hbm", fill=None,
              sharding=sharding)
    (r0, rs), (c0, cs) = local_box(out.padded_shape, sharding)
    loc = torch.zeros((rs, cs), dtype=dtype, device=dev)
    r1, c1 = min(r0 + rs, m), min(c0 + cs, n)
    if r0 < r1 and c0 < c1:
        loc[:r1 - r0, :c1 - c0] = as_tensor(arr[r0:r1, c0:c1], device=dev, dtype=dtype)
    if symmetric:  # the identity on the padded diagonal, where this block holds it
        for d in range(max(m, r0, c0), min(r0 + rs, c0 + cs)):
            loc[d - r0, d - c0] = 1.0
    out.replace_array(as_dtensor(loc, out.padded_shape, sharding))
    return out


def local_numpy_init(arr, tile: Tuple[int, int] = (512, 512), **kw) -> TiledMatrix:
    """Reference-parity alias (matrix_init.local_numpy_init)."""
    return shard_matrix(arr, tile=tile, **kw)


def random_spd(n: int, seed: int = 0, dtype=np.float32, jitter: float = None) -> np.ndarray:
    """A well-conditioned random SPD matrix for tests (numpy, fp64 product).

    Mirrors the reference tests' pattern (A = X Xᵀ/n + 2I on random X). It is
    O(n³) on the host: build large operands on the device instead."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n)).astype(np.float64)
    a = x @ x.T / n + np.eye(n) * (jitter if jitter is not None else 2.0)
    return a.astype(dtype)
