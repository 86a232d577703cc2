"""CUDA kernel layer: the hand-written GEMM kernels and their plain PyTorch
versions (``gemm.matmul`` / ``matmul_ref``, ``gemm3.matmul3`` /
``matmul3_ref``). The kernels build from ``numpywren_tpu_torch/csrc`` at
first launch (``ops/_build.py``)."""
