"""Device mesh construction and sharding helpers, on torch.distributed.

Counterpart of numpywren_tpu/parallel/mesh.py. PyTorch runs one process
per device, each a rank of the default process group, so a mesh is a
``DeviceMesh`` over ranks (``make_mesh(devices=...)`` takes a list of ranks
where the reference takes devices), and tile (i, j) of a mesh-sharded
matrix lives on the rank at mesh position (i mod R, j mod C) of the block
layout.

A sharding is ``NamedSharding(mesh, placements)``: DTensor placements, one
per mesh axis. ``mesh_sharding(mesh, P(...))`` maps the reference's
partition specs onto them:

    P("rows", "cols")      -> (Shard(0), Shard(1))
    P("rows", None)        -> (Shard(0), Replicate())
    P(None, "cols")        -> (Replicate(), Shard(1))
    P(("rows", "cols"), None) -> (Shard(0), Shard(0))
    P()                    -> (Replicate(), Replicate())

A dimension that its mesh axes do not divide splits as ``torch.chunk``
does (DTensor's rule): chunks of ceil(n / k), the last ones shorter or
empty (6 rows over 4 ranks: 2, 2, 2, 0). The JAX package refuses such a
layout (``device_put`` raises ValueError), so the two agree wherever the
reference runs; the tests and chip_smoke.py use shapes that divide.

Each rank holds only its own block: ``local_block`` cuts it out of a host
array or a global tensor, and ``as_dtensor`` wraps it with the global shape,
without moving data.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from numpywren_tpu_torch.config import default_config
from numpywren_tpu_torch.ops.common import default_device


def _factor_2d(n: int) -> Tuple[int, int]:
    """Most-square factorization r*c = n with r <= c."""
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


class P(tuple):
    """A partition spec, as jax.sharding.PartitionSpec: one entry per array
    dimension, each a mesh axis name, a tuple of names or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout over a mesh: one DTensor placement per mesh axis."""

    mesh: DeviceMesh
    placements: Tuple


def make_mesh(
    devices: Optional[Sequence[int]] = None,
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Optional[Tuple[str, str]] = None,
    device=None,
) -> DeviceMesh:
    """A 2-D (rows, cols) mesh over the given ranks (default: every rank of
    the default process group), on the current CUDA device of each rank;
    device="cpu" asks for the CPU, and a host without a card raises unless
    it is given.

    shape/axis_names default to NpwConfig.mesh_shape / mesh_axis_names
    (NPW_MESH_SHAPE=RxC env override), falling back to the most-square
    factorization of the rank count. Collective: every rank of the default
    group calls it, also the ranks that the mesh leaves out (they create
    its groups too). Needs an initialized process group
    (parallel.distributed.initialize)."""
    device_type = "cpu" if device is not None and torch.device(device).type == "cpu" \
        else default_device().type
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "numpywren_tpu_torch.parallel.distributed.initialize() first (NPW_COORDINATOR, "
            "NPW_NUM_PROCESSES, NPW_PROCESS_ID, or torchrun's variables)")
    cfg = default_config()
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if shape is None:
        shape = cfg.mesh_shape
        if shape is not None and shape[0] * shape[1] != len(ranks):
            shape = None  # configured shape is for a different rank count
    if shape is None:
        shape = _factor_2d(len(ranks))
    if axis_names is None:
        axis_names = tuple(cfg.mesh_axis_names)
    r, c = shape
    if r * c != len(ranks):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(ranks)} ranks")
    return DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int64).reshape(r, c),
                      mesh_dim_names=tuple(axis_names))


def _placements(mesh: DeviceMesh, spec) -> Tuple:
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, part in enumerate(spec)
                if part == name or (isinstance(part, tuple) and name in part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def mesh_sharding(mesh: DeviceMesh, spec=None) -> NamedSharding:
    """A sharding over both mesh axes from a partition spec (default: the
    2-D block layout)."""
    if spec is None:
        spec = P(*mesh.mesh_dim_names)
    return NamedSharding(mesh, _placements(mesh, spec))


def tile_sharding(mesh: DeviceMesh) -> NamedSharding:
    """The canonical layout for a flat padded TiledMatrix array: rows of
    tiles block-sharded over mesh rows, columns over mesh cols."""
    return NamedSharding(mesh, (Shard(0), Shard(1)))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, (Replicate(), Replicate()))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks of `mesh` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_box(shape, sharding: NamedSharding):
    """(offset, size) per array dimension of this rank's block, by DTensor's
    rule: each sharded mesh axis, in order, splits the current range as
    torch.chunk does. A rank outside the mesh gets None."""
    coord = sharding.mesh.get_coordinate()
    if coord is None:
        return None
    box = [[0, int(s)] for s in shape]
    for axis, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            off, size = box[pl.dim]
            k = sharding.mesh.size(axis)
            step = -(-size // k)
            lo = min(coord[axis] * step, size)
            box[pl.dim] = [off + lo, min(step, size - lo)]
    return [tuple(b) for b in box]


def is_primary(sharding: NamedSharding) -> bool:
    """True on the one rank of each group of replicas that contributes its
    block to a sum over the mesh: index 0 along every replicated axis."""
    coord = sharding.mesh.get_coordinate()
    return coord is not None and all(
        c == 0 for c, pl in zip(coord, sharding.placements) if not isinstance(pl, Shard))


def sum_over_mesh(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """all_reduce(SUM) of `x` over the whole mesh, in place: one all_reduce
    per mesh axis. Collective over the mesh."""
    for axis in range(mesh.ndim):
        if mesh.size(axis) > 1:
            dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def flat_index(mesh: DeviceMesh) -> int:
    """This rank's index on the mesh flattened row-major (the reference's
    ``mesh.devices.reshape(-1)``): pi * c + pj."""
    coord = mesh.get_coordinate()
    return int(np.ravel_multi_index(tuple(coord), tuple(mesh.shape)))


def broadcast_flat(x: torch.Tensor, root: int, mesh: DeviceMesh) -> torch.Tensor:
    """Broadcast into `x` (in place, and returned) the `x` of the rank at
    flat index `root`, with the mesh's own axis groups (creating a group of
    the flattened mesh would be collective over the whole world): along
    the cols axis within the root's mesh row, then along the rows axis from
    that row. Collective over the mesh: every rank calls it with the same
    root and a tensor of the same shape and dtype."""
    rows, cols = mesh.shape
    r0, c0 = divmod(int(root), cols)
    pi, pj = mesh.get_coordinate()
    if cols > 1 and pi == r0:
        dist.broadcast(x, src=int(mesh.mesh[r0, c0]), group=mesh.get_group(1))
    if rows > 1:
        dist.broadcast(x, src=int(mesh.mesh[r0, pj]), group=mesh.get_group(0))
    return x


def flat_rows(mesh: DeviceMesh) -> NamedSharding:
    """Rows split over the mesh flattened row-major (the reference's
    ``P("d", None)`` on ``Mesh(devices.reshape(-1), ("d",))``)."""
    return NamedSharding(mesh, (Shard(0),) * mesh.ndim)


def box_slices(box) -> tuple:
    return tuple(slice(o, o + s) for o, s in box)


def local_block(x, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of `x` on the mesh's device: a DTensor laid out by
    `sharding` gives its local tensor; an ndarray (or a tensor on another
    device) gives a copy of the block alone; a tensor on the mesh's device
    gives a view of it, which a computation in place then writes."""
    if isinstance(x, DTensor):
        if x.device_mesh != sharding.mesh or tuple(x.placements) != tuple(sharding.placements):
            raise ValueError(f"a DTensor laid out as {tuple(x.placements)} where "
                             f"{tuple(sharding.placements)} is needed")
        return x.to_local()
    sl = box_slices(local_box(x.shape, sharding))
    dev = mesh_device(sharding.mesh)
    if isinstance(x, torch.Tensor):
        return x[sl].to(dev)
    return torch.as_tensor(np.array(np.asarray(x)[sl]), device=dev)  # a copy of the block alone


def as_dtensor(local: torch.Tensor, shape, sharding: NamedSharding) -> DTensor:
    """Wrap this rank's block as the global array of `shape` (no data moves)."""
    shape = torch.Size(int(s) for s in shape)
    stride = tuple(int(math.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local, sharding.mesh, list(sharding.placements), run_check=False,
                              shape=shape, stride=stride)
