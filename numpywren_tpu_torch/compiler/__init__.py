"""Lowering of compiled DSL programs onto the CUDA store (fused Cholesky)."""
