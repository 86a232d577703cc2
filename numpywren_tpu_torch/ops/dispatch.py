"""Kernel dispatch: name -> device implementation.

Counterpart of numpywren_tpu/ops/dispatch.py. Executors look kernels up by
name, so one compiled tiled program runs on the LocalExecutor (the numpy
reference kernels, kernels.KERNELS) or on the card (these). Names and
signatures are kernels.py's.
"""

from __future__ import annotations

import torch

from numpywren_tpu_torch.kernels import MAX_REDUCER_ARITY
from numpywren_tpu_torch.ops import factor
from numpywren_tpu_torch.ops.gemm import gemm, gemm_acc, gemm_nt, gemm_tn, syrk_update


def _add(a, b):
    return a + b


def _sub(a, b):
    return a - b


def _identity(a):
    return torch.eye(a.shape[0], a.shape[1], dtype=a.dtype, device=a.device)


def _copy(a):
    return a


def _transpose(a):
    return a.T


TORCH_KERNELS = {
    "potrf": factor.potrf,
    "trsm": factor.trsm,
    "syrk": syrk_update,
    "gemm": gemm,
    "gemm_nt": gemm_nt,
    "gemm_tn": gemm_tn,
    "gemm_acc": gemm_acc,
    "add": _add,
    "sub": _sub,
    "identity": _identity,
    "copy": _copy,
    "transpose": _transpose,
    "qr_leaf": factor.qr_leaf,
    "qr_combine": factor.qr_combine,
    "qr_r": factor.qr_r,
    "lq_leaf": factor.lq_leaf,
    "small_qr_apply": factor.small_qr_apply,
    "qr_factor2": factor.qr_factor2,
    "qr_apply2": factor.qr_apply2,
    "lq_factor2": factor.lq_factor2,
    "lq_apply2": factor.lq_apply2,
    # the k-ary reducer combine family (the numpy registry's arities)
    **{f"qr_combine_r{m}": factor._make_qr_combine_r(m)
       for m in range(2, MAX_REDUCER_ARITY + 1)},
}


def torch_kernel(name: str):
    return TORCH_KERNELS[name]
