"""Compiler: the static schedule (DSL loop-nest IR -> wavefront levels) and
the fused lowering of compiled programs onto the CUDA store
(``compiler.lower``: Cholesky, GEMM, TSQR, BDFAC)."""

from numpywren_tpu_torch.compiler.schedule import compile_schedule

__all__ = ["compile_schedule"]
