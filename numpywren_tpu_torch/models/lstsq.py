"""Least-squares model family (tall overdetermined systems).

Counterpart of numpywren_tpu/models/lstsq.py. Two paths:

- `least_squares(..., method="qr")` (default): the adaptive shifted
  CholeskyQR chain of A (`compiler.lower.fused_tsqr`, method "cholqr3s",
  one leaf), then x = R⁻¹ Qᵀ b. Its applies run the matmul3 kernel in
  compensated mode, its factors the potrf_inv kernel under
  NPW_PALLAS_FACTOR=1 and passes 1-2 the chain kernel under
  NPW_PALLAS_CHAIN=1 (inside their envelopes).
- `method="normal"`: the Gram G = AᵀA, then a Cholesky solve: half the
  flops of QR but squares the condition number.

The models' own products are torch.matmul in true FP32, as the
reference's ``jnp.matmul`` runs outside any Pallas kernel. A non-SPD
normal matrix raises torch.linalg.LinAlgError (the reference returns
NaNs). Inputs: a tensor stays where it is, an ndarray goes to `device`
(else the current CUDA device); b follows A. Results are ndarrays.
"""

from __future__ import annotations

import numpy as np
import torch

from numpywren_tpu_torch.ops.common import as_tensor, to_numpy

__all__ = ["least_squares", "ridge_regression"]


def _solve_upper(r, y):
    """x = R⁻¹ y on device (R upper triangular)."""
    return torch.linalg.solve_triangular(r, y, upper=True)


def _cholesky_solve(g, atb):
    """(G)⁻¹ AᵀB by the Cholesky factor of the symmetrized G."""
    l = torch.linalg.cholesky(0.5 * (g + g.T))
    y = torch.linalg.solve_triangular(l, atb, upper=False)
    return torch.linalg.solve_triangular(l.T, y, upper=True)


def _operands(a, b, device):
    ad = as_tensor(a, device)
    bd = as_tensor(b, ad.device, ad.dtype)
    squeeze = bd.dim() == 1
    return ad, (bd[:, None] if squeeze else bd), squeeze


def least_squares(a, b, method: str = "qr", device=None) -> np.ndarray:
    """argmin_x ||A x - b||_2 for tall A (m, n), b (m,) or (m, k)."""
    from numpywren_tpu_torch.compiler.lower import fused_tsqr

    ad, bd, squeeze = _operands(a, b, device)
    if ad.dim() != 2 or ad.shape[0] < ad.shape[1]:
        raise ValueError(f"least_squares expects tall A, got {tuple(ad.shape)}")
    if bd.shape[0] != ad.shape[0]:
        raise ValueError(f"b rows {bd.shape[0]} != A rows {ad.shape[0]}")
    if method == "qr":
        q, r = fused_tsqr(ad, tile_rows=ad.shape[0], compute_q=True, method="cholqr3s")
        x = _solve_upper(r, q.T @ bd)
    elif method == "normal":
        x = _cholesky_solve(ad.T @ ad, ad.T @ bd)
    else:
        raise ValueError(f"unknown method {method!r}")
    x = to_numpy(x)
    return x[:, 0] if squeeze else x


def ridge_regression(a, b, alpha: float, device=None) -> np.ndarray:
    """argmin_x ||A x - b||² + alpha ||x||² via the regularized normal
    equations (AᵀA + alpha I) x = Aᵀb, SPD by construction. alpha > 0."""
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    ad, bd, squeeze = _operands(a, b, device)
    g = ad.T @ ad
    g = g + alpha * torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    x = to_numpy(_cholesky_solve(g, ad.T @ bd))
    return x[:, 0] if squeeze else x
