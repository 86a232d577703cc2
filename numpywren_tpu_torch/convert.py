"""Carrying state between the JAX package and the port.

This system has no model weights: its state is matrices. `from_reference`
turns a numpywren_tpu store object into the port's counterpart, reading it
through ``np.asarray`` only, so the port never imports jax. `to_numpy` is
the other direction: the logical matrix as an ndarray, which the JAX
package takes in (``TrapezoidMatrix.from_array``, ``shard_matrix``).
"""

from __future__ import annotations

import numpy as np
import torch

from numpywren_tpu_torch.ops.common import default_device
from numpywren_tpu_torch.ops.common import to_numpy as _tensor_to_numpy
from numpywren_tpu_torch.tiled import TiledMatrix, TiledSymmetricMatrix, _TiledBase
from numpywren_tpu_torch.trapezoid import TiledTrapezoidMatrix, TrapezoidMatrix


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)  # np.array copies: owned buffer


def from_reference(obj, device=None, sharding=None):
    """The port's counterpart of a numpywren_tpu TrapezoidMatrix,
    TiledTrapezoidMatrix, TiledMatrix or TiledSymmetricMatrix, on `device`
    (default: the current CUDA device; a host without one raises, so pass
    device="cpu"), on the same tier: a host-tier matrix stays a dict of
    host tiles computed on `device`.

    Stored state carries over exactly, including what a factorization has
    left behind: the stale strict upper of diagonal blocks, the
    computed-block mask and the host tier's set of existing blocks. A
    parent_fn (a Python closure over the JAX package's objects) does not
    carry over.

    `sharding` (a parallel.mesh.NamedSharding) lays a device-tier
    TiledMatrix out over a mesh, each rank keeping its own block of the
    reference's values (on a host-tier one it is to_hbm()'s default
    layout); it applies to TiledMatrix and TiledSymmetricMatrix only."""
    if sharding is not None and type(obj).__name__ not in ("TiledMatrix", "TiledSymmetricMatrix"):
        raise ValueError(f"sharding= applies to a TiledMatrix, not a {type(obj).__name__}")
    if sharding is not None and obj.storage == "hbm":
        from numpywren_tpu_torch.parallel.mesh import as_dtensor, local_block, mesh_device

        device = mesh_device(sharding.mesh)
    device = torch.device(device) if device is not None else default_device()
    kind = type(obj).__name__
    if kind == "TrapezoidMatrix":
        return TrapezoidMatrix([_tensor(c, device) for c in obj.cols], obj.n, obj.panel)
    if kind == "TiledTrapezoidMatrix":
        out = TiledTrapezoidMatrix(from_reference(obj.trap, device), key=obj.key,
                                   tile=obj.tile[0], symmetric=obj.symmetric)
        out._written = np.array(obj._written)
        return out
    if kind in ("TiledMatrix", "TiledSymmetricMatrix"):
        cls = TiledSymmetricMatrix if kind == "TiledSymmetricMatrix" else TiledMatrix
        if obj.storage == "host":
            out = cls(key=obj.key, shape=obj.shape, tile=obj.tile, dtype=np.dtype(obj.dtype),
                      storage="host", device=device, sharding=sharding)
            for (i, j), blk in obj._tiles.items():  # the stored (canonical) tiles
                out._tiles[(i, j)] = out._host_tile(np.array(blk), i, j)
            return out
        out = cls(key=obj.key, shape=obj.shape, tile=obj.tile, dtype=np.dtype(obj.dtype),
                  storage="hbm", fill=obj._fill, device=device)
        if sharding is None:
            out.replace_array(_tensor(obj.array, device), mark_written=False)
        else:
            arr = np.asarray(obj.array)
            out.replace_array(as_dtensor(local_block(arr, sharding), arr.shape, sharding),
                              mark_written=False)
        out._written = np.array(obj._written)
        out._cached = np.array(obj._cached)
        return out
    raise TypeError(f"no port counterpart for {type(obj).__module__}.{kind}")


def to_numpy(obj) -> np.ndarray:
    """The logical matrix of a port store object (or a tensor) as an ndarray."""
    if isinstance(obj, (TrapezoidMatrix, _TiledBase)):
        return obj.numpy()
    return _tensor_to_numpy(obj)
