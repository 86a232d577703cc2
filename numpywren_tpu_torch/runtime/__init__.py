"""Runtime: the program object, its node state machine, and the executors
(counterpart of numpywren_tpu/runtime).

``run_program`` runs a compiled ``TiledProgram`` through the fused lowering
or one of the generic executors: ``LocalExecutor`` (threads and numpy
kernels, the reference's worker loop with fault injection),
``TorchTaskExecutor`` (``JaxTaskExecutor``, the JAX package's name for it:
one gather, batched op and scatter per schedule group on the device) and
``SpillTaskExecutor`` (the same schedule over host-tier tiles).

The JAX package also exports ``out_of_core_cholesky``; it arrives with the
port of ``runtime/spill.py`` (ROADMAP Queue 1 #1).
"""

from numpywren_tpu_torch.runtime.program import NS, PS, TiledProgram
from numpywren_tpu_torch.runtime.executor import (
    JaxTaskExecutor,
    LocalExecutor,
    SpillTaskExecutor,
    TorchTaskExecutor,
    run_program,
)

__all__ = [
    "NS", "PS", "TiledProgram", "LocalExecutor", "JaxTaskExecutor",
    "SpillTaskExecutor", "run_program",
]
