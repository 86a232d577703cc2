"""Shared helpers for the CUDA kernel layer.

Precision names mirror ``jax.lax.Precision`` as strings:

=============  ===========================================================
``"high"``     fp32 default. ``torch.matmul`` in true FP32, or the bf16x3
               ``matmul3`` kernel when ``NpwConfig.compensated`` is on.
``"highest"``  the hand-written ``matmul`` kernel: fp32 operands as a
               bf16x6 split on the tensor cores, as the TPU computes HIGHEST.
``"default"``  bf16 default: the ``matmul`` kernel, one bf16 product, fp32 sums.
=============  ===========================================================

TF32 policy: off. TF32 keeps about three decimal digits, the one-pass mode
that a factorization cannot use (its residual would be ~1e-3, not ~1e-6),
so importing the port pins both PyTorch switches that would enable it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from numpywren_tpu_torch.utils import cdiv  # noqa: F401  (re-exported for the kernel layer)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRECISIONS = ("default", "high", "highest")


def on_cuda(t: torch.Tensor) -> bool:
    """True when `t` lies on a CUDA device: its op then launches the CUDA
    kernel (or raises). A CPU tensor takes the plain PyTorch version."""
    return t.device.type == "cuda"


def default_precision(dtype) -> str:
    """fp32 inputs default to "high"; bf16 inputs to the one-pass "default"."""
    return "high" if torch_dtype(dtype) == torch.float32 else "default"


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision


def default_device() -> torch.device:
    """Where numpy inputs go when no device is named: the current CUDA
    device. A host without one raises: the port runs on the CPU only when
    the caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (or CPU tensors) to run the port's "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")


def torch_dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(d, torch.dtype):
        return d
    name = d if isinstance(d, str) else np.dtype(d).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {d!r}")
    return out


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor from an ndarray or a tensor. `device=None` keeps a tensor
    where it is and puts an ndarray on default_device()."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=torch_dtype(dtype) if dtype is not None else x.dtype)
    arr = np.asarray(x)
    dev = torch.device(device) if device is not None else default_device()
    return torch.as_tensor(arr, device=dev,
                           dtype=torch_dtype(dtype) if dtype is not None else None)


def to_numpy(x) -> np.ndarray:
    """Host copy of a tensor (bf16 widens to fp32, which numpy lacks)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def np_dtype(d: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor of dtype `d` converts to (see to_numpy)."""
    return np.dtype(np.float32) if d == torch.bfloat16 else torch.empty(0, dtype=d).numpy().dtype


def leading_dim(t: torch.Tensor) -> Optional[int]:
    """Row stride of a 2-D tensor with unit column stride (what the kernels
    take as their leading dimension), or None when the layout is another."""
    if t.dim() != 2:
        return None
    rows, cols = t.shape
    if cols > 1 and t.stride(1) != 1:
        return None
    ld = t.stride(0) if rows > 1 else max(cols, 1)
    return ld if ld >= cols else None
