"""CUDA kernel layer: the hand-written kernels and their plain PyTorch
versions (``gemm.matmul`` / ``matmul_ref``, ``gemm3.matmul3`` /
``matmul3_ref``, and in ``pallas_factor`` the potrf, potrf_inv, trtri and
CholeskyQR2-chain kernels). The kernels build from
``numpywren_tpu_torch/csrc`` at first launch (``ops/_build.py``)."""

from numpywren_tpu_torch.ops.pallas_factor import potrf_pallas, trsm_pallas, trtri_pallas

__all__ = ["potrf_pallas", "trsm_pallas", "trtri_pallas"]
