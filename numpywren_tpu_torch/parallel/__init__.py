"""Multi-device parallel layer: device mesh and sharded tiled algorithms.

Counterpart of numpywren_tpu/parallel. The JAX package runs XLA SPMD over
a jax.sharding.Mesh; the port runs one process per device over
torch.distributed: a DeviceMesh of ranks, DTensors whose blocks each rank
holds, and explicit collectives (parallel.fabric) where GSPMD inserts
them in the reference. Start the ranks with ``distributed.initialize()``.
"""

from numpywren_tpu_torch.parallel import distributed
from numpywren_tpu_torch.parallel.mesh import make_mesh, mesh_sharding, tile_sharding
from numpywren_tpu_torch.parallel.fabric import (
    bdfac_1d,
    bdfac_2d,
    cholesky_1d,
    cholesky_2d,
    cholqr2_sharded,
    cholqr3s_sharded,
    summa_gemm,
    tsqr_butterfly,
)
from numpywren_tpu_torch.parallel.sharded import (
    sharded_cholesky,
    sharded_gemm,
    sharded_tsqr,
)

__all__ = [
    "bdfac_1d",
    "bdfac_2d",
    "distributed",
    "make_mesh",
    "mesh_sharding",
    "tile_sharding",
    "sharded_cholesky",
    "sharded_gemm",
    "sharded_tsqr",
    "summa_gemm",
    "tsqr_butterfly",
    "cholesky_1d",
    "cholesky_2d",
    "cholqr2_sharded",
    "cholqr3s_sharded",
]
