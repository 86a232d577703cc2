"""numpywren_tpu_torch: the PyTorch/CUDA port of numpywren_tpu.

The JAX package (numpywren_tpu) stays the reference; this package mirrors
its module paths and imports nothing of it. Plain tensor code is eager
PyTorch, and the TPU's Pallas kernels on the ported paths are hand-written
CUDA C++ for Hopper (``csrc/``, built at first use). The backend-neutral
layers (the DSL frontend, algs, the schedule compiler and its native core,
the program state machine, config, exceptions, utils, the numpy reference
kernels) are the port's own copies.

Entry points run on the current CUDA device; a host without one raises
unless the caller passes ``device="cpu"`` (or CPU tensors), which runs the
kernels' plain PyTorch versions.

The port covers everything the JAX package does: ``cholesky`` /
``cholesky_trapezoid`` / ``cholesky_solve``, ``gemm``, ``tsqr`` and
``bdfac`` through ``run_program`` with the fused lowering and the generic
executors ("jax", "local", "spill"), on the device tier and the host
tier; the out-of-core Cholesky and BDFAC (``runtime.spill``); the models
(``models``: least squares, PCA, the SVD family on TSQR, Jacobi, BDFAC and
QDWH); the DSL ops (``ops.TORCH_KERNELS``), ``binops`` and
``checkpoint``; down to the GEMM kernels (``ops.gemm``, ``ops.gemm3``) and
the factorization kernels (``ops.pallas_factor``); the multi-device layer
(``parallel``, whole: the mesh, the process group, the sharded store, the
sharded and block-cyclic Cholesky, GEMM, TSQR, CholeskyQR and BDFAC,
SUMMA, the dry run, on torch.distributed); and the aux modules
(``metrics``: per-level step records, a torch.profiler trace, a flop meter
on CUDA events; ``cli`` and ``python -m numpywren_tpu_torch info|doctor``).

``__all__`` holds the reference's names and, beside them, the entry points
that the JAX package loads lazily without listing them: ``cholesky``,
``cholesky_solve``, ``bdfac``, ``gemm``, ``tsqr``, ``tsqr_r_factor`` and
``run_program``.
"""

from numpywren_tpu_torch import exceptions, kernels
from numpywren_tpu_torch.config import NpwConfig, default_config
from numpywren_tpu_torch.alg_wrappers import (
    bdfac,
    cholesky,
    cholesky_solve,
    gemm,
    tsqr,
    tsqr_r_factor,
)
from numpywren_tpu_torch.runtime.executor import run_program
from numpywren_tpu_torch.tiled import TiledMatrix, TiledSymmetricMatrix
from numpywren_tpu_torch.trapezoid import (
    TiledTrapezoidMatrix,
    TrapezoidMatrix,
    cholesky_trapezoid,
)

__version__ = "0.1.0"

__all__ = [
    "TiledMatrix",
    "TiledSymmetricMatrix",
    "TrapezoidMatrix",
    "TiledTrapezoidMatrix",
    "cholesky_trapezoid",
    "cholesky",
    "cholesky_solve",
    "bdfac",
    "gemm",
    "tsqr",
    "tsqr_r_factor",
    "run_program",
    "NpwConfig",
    "default_config",
    "kernels",
    "exceptions",
    "__version__",
]


def __getattr__(name):
    # binops and lpcompile load at first use, as in the JAX package
    if name == "binops":
        import importlib

        return importlib.import_module("numpywren_tpu_torch.binops")
    if name == "lpcompile":
        from numpywren_tpu_torch.frontend import lpcompile

        return lpcompile
    raise AttributeError(f"module 'numpywren_tpu_torch' has no attribute {name!r}")
