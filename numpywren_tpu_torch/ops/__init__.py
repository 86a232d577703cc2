"""CUDA kernel layer: the hand-written kernels and their plain PyTorch
versions (``gemm.matmul`` / ``matmul_ref``, ``gemm3.matmul3`` /
``matmul3_ref``, and in ``pallas_factor`` the potrf, potrf_inv, trtri,
CholeskyQR2-chain and blocked-Householder QR kernels), the library tile ops
around them (``factor``) and the name -> op table the executors dispatch on
(``dispatch.TORCH_KERNELS``). The kernels build from
``numpywren_tpu_torch/csrc`` at first launch (``ops/_build.py``).

The names exported here are the JAX package's, so ``ops.gemm`` is the
registry's function, as ``numpywren_tpu.ops.gemm`` is; the module (its
``LAUNCHES`` counter) is
``importlib.import_module("numpywren_tpu_torch.ops.gemm")``."""

from numpywren_tpu_torch.ops.gemm import matmul, gemm, gemm_nt, gemm_tn, gemm_acc, syrk_update
from numpywren_tpu_torch.ops.factor import (
    potrf,
    trsm,
    qr_leaf,
    qr_combine,
    qr_r,
    lq_leaf,
    small_qr_apply,
)
from numpywren_tpu_torch.ops.pallas_factor import potrf_pallas, trsm_pallas, trtri_pallas
from numpywren_tpu_torch.ops.dispatch import TORCH_KERNELS, torch_kernel

__all__ = [
    "matmul",
    "gemm",
    "gemm_nt",
    "gemm_tn",
    "gemm_acc",
    "syrk_update",
    "potrf",
    "potrf_pallas",
    "trsm",
    "trsm_pallas",
    "trtri_pallas",
    "qr_leaf",
    "qr_combine",
    "qr_r",
    "lq_leaf",
    "small_qr_apply",
    "TORCH_KERNELS",
    "torch_kernel",
]
