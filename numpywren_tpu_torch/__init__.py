"""numpywren_tpu_torch: the PyTorch/CUDA port of numpywren_tpu.

The JAX package (numpywren_tpu) stays the reference; this package mirrors
its module paths. Plain tensor code is eager PyTorch, and the TPU's Pallas
kernels on the ported path are hand-written CUDA C++ for Hopper
(``csrc/``, built at first use). The layers without jax in them (the DSL
frontend, algs, the schedule compiler, the program state machine, config,
exceptions, utils) are imported from numpywren_tpu, not copied.

Ported so far: the blocked-Cholesky main path, from ``cholesky`` /
``run_program`` and ``cholesky_trapezoid`` down to the two GEMM kernels
(``ops.gemm.matmul``, ``ops.gemm3.matmul3``). See ROADMAP.md for the rest.
"""

from numpywren_tpu.config import NpwConfig, default_config
from numpywren_tpu_torch.alg_wrappers import cholesky, cholesky_solve
from numpywren_tpu_torch.runtime.executor import run_program
from numpywren_tpu_torch.tiled import TiledMatrix
from numpywren_tpu_torch.trapezoid import (
    TiledTrapezoidMatrix,
    TrapezoidMatrix,
    cholesky_trapezoid,
)

__all__ = [
    "TiledMatrix",
    "TrapezoidMatrix",
    "TiledTrapezoidMatrix",
    "cholesky_trapezoid",
    "cholesky",
    "cholesky_solve",
    "run_program",
    "NpwConfig",
    "default_config",
]
