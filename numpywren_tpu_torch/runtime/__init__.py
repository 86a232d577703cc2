"""Runtime: the program object, its node state machine, and the executors
(counterpart of numpywren_tpu/runtime).

``run_program`` runs a compiled ``TiledProgram`` through the fused lowering
or one of the generic executors: ``LocalExecutor`` (threads and numpy
kernels, the reference's worker loop with fault injection),
``TorchTaskExecutor`` (``JaxTaskExecutor``, the JAX package's name for it:
one gather, batched op and scatter per schedule group on the device) and
``SpillTaskExecutor`` (the same schedule over host-tier tiles).
``out_of_core_cholesky`` (runtime/spill.py) streams a host-tier Cholesky
through the device panel by panel; run_program takes it for a host-tier
matrix too large for the device.
"""

from numpywren_tpu_torch.runtime.program import NS, PS, TiledProgram
from numpywren_tpu_torch.runtime.executor import (
    JaxTaskExecutor,
    LocalExecutor,
    SpillTaskExecutor,
    TorchTaskExecutor,
    run_program,
)
from numpywren_tpu_torch.runtime.spill import out_of_core_cholesky

__all__ = [
    "NS", "PS", "TiledProgram", "LocalExecutor", "JaxTaskExecutor",
    "SpillTaskExecutor", "out_of_core_cholesky", "run_program",
]
