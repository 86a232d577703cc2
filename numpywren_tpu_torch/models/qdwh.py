"""QDWH polar decomposition and the SVD on it, on PyTorch tensors.

Counterpart of the two JAX modules the JAX package's `models.svd._qdwh_svd`
runs (jax._src.tpu.linalg.qdwh and jax._src.tpu.linalg.svd), kept here as
the port's own copy of the algorithm:

- `qdwh`: the QR-based dynamically weighted Halley iteration
  (Nakatsukasa, Bai and Gygi, SIAM J. Matrix Anal. Appl. 31(5), 2010):
  x = u h with u orthonormal, h symmetric positive semidefinite. The
  coefficient schedule is host Python on floats, its length fixed by eps
  (float32: two QR steps while c > 100, then two Cholesky steps), then
  Halley steps (a, b, c = 3, 1, 3) until the iterate stops moving, at most
  max_iterations in all, then one Newton-Schulz step.
- `svd`: the thin SVD by a polar decomposition and a symmetric eigensolve
  of h (Nakatsukasa and Higham, SIAM J. Sci. Comput. 35(3), 2013): the
  wide flip, a QR pre-reduction when m > 1.15 n, eigh of h, the descending
  sort, u = u_p v, and the re-orthonormalization of u when the input is
  numerically rank-deficient.

The eigensolve is `torch.linalg.eigh` (cuSOLVER's syevd on the card, in
float64 up to order 512: `_eigh`): the JAX module calls `lax.linalg.eigh`,
a library routine that lowers to a spectral divide-and-conquer only on a
TPU and to LAPACK syevd elsewhere.

The JAX modules run under float32 matmul precision (HIGHEST on a TPU); the
port's counterpart is the matmul kernel at three bf16 planes
(precision="highest", `compiler.lower._matmul`): the Grams uᵀu, q1 q2ᵀ
with the e u epilogue, the Newton-Schulz product, h = uᵀx, u_p v and the
tall case's q u. The library routines map to their torch counterparts:
QR to `torch.linalg.qr`, Cholesky to `cholesky_ex` written to NaN where it
fails (as JAX's cholesky returns), the triangular solves to
`solve_triangular`. On a CPU tensor every product is torch.matmul in fp32
(the kernel's plain version).

Host reads: one of the convergence flag after the Cholesky-coefficient
steps and one per extra Halley step (JAX's fori_loop carries the flag,
and only the last Cholesky step's test decides), one of the rank test in
`svd`, and eigh's own status check. The dynamic_shape padding of the JAX
module is not ported: the JAX package never passes it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from numpywren_tpu_torch.compiler.lower import _cholesky_nan, _matmul
from numpywren_tpu_torch.ops.gemm import matmul as kernel_matmul

__all__ = ["qdwh", "svd"]

_HI = "highest"
_CHOLESKY_CUTOFF = 100  # c above it takes a QR step: x = c uᵀu + I is too ill-conditioned


def _f32(v: float) -> float:
    """v rounded to float32: the JAX module casts its coefficients to the
    input's dtype before they meet a tensor."""
    return float(np.float32(v))


def _use_qr(u: torch.Tensor, params) -> torch.Tensor:
    """One QR-based step: e u + ((a - e)/sqrt(c)) q1 q2ᵀ, where
    [sqrt(c) u; I] = [q1; q2] r."""
    a_minus_e_by_sqrt_c, sqrt_c, e = params
    m, n = u.shape
    y = torch.cat([sqrt_c * u, torch.eye(n, dtype=u.dtype, device=u.device)])
    q, _ = torch.linalg.qr(y, mode="reduced")
    return kernel_matmul(q[:m], q[m:], u, tb=True, alpha=a_minus_e_by_sqrt_c, beta=e,
                         precision=_HI)


def _use_cholesky(u: torch.Tensor, params) -> torch.Tensor:
    """One Cholesky-based step: e u + (a - e) u x⁻¹ with x = c uᵀu + I,
    by x = y yᵀ and two triangular solves. A factorization that fails
    comes out NaN."""
    a_minus_e, c, e = params
    x = c * _matmul(u, u, ta=True, precision=_HI)
    x.diagonal().add_(1.0)
    y = _cholesky_nan(x)
    z = torch.linalg.solve_triangular(y.T, u, upper=True, left=False)   # u y⁻ᵀ
    z = torch.linalg.solve_triangular(y, z, upper=False, left=False)    # u x⁻¹
    return e * u + a_minus_e * z


def _schedule(eps: float, max_iterations: int):
    """The QDWH coefficients (a, b, c) of each step while the lower bound l
    of the scaled iterate's smallest singular value is below 1, as
    (qr_params, chol_params): host Python on floats."""
    l, tol_l = eps, 10.0 * eps / 2.0
    qr_coefs, chol_coefs = [], []
    k = 0
    while l + tol_l < 1 and k < max_iterations:
        k += 1
        l2 = l * l
        dd = (4 * (1 / l2 - 1) / l2) ** (1 / 3)
        sqd = (1.0 + dd) ** (1 / 2)
        a = sqd + (2 - dd + 2 * (2 - l2) / (l2 * sqd)) ** (1 / 2)
        b = (a - 1) ** 2 / 4
        c = a + b - 1
        l = l * (a + b * l2) / (1 + c * l2)
        e = b / c
        if c > _CHOLESKY_CUTOFF:
            qr_coefs.append(tuple(map(_f32, ((a - e) / c ** 0.5, c ** 0.5, e))))
        else:
            chol_coefs.append(tuple(map(_f32, (a - e, c, e))))
    return qr_coefs, chol_coefs


def _qdwh(x: torch.Tensor, max_iterations: int, eps: float):
    one_norm = torch.linalg.matrix_norm(x, ord=1)
    inf_norm = torch.linalg.matrix_norm(x, ord=float("inf"))
    alpha_inverse = torch.where(one_norm == 0, torch.ones_like(one_norm),
                                torch.rsqrt(one_norm) * torch.rsqrt(inf_norm))
    u = x * alpha_inverse
    tol_norm = (10.0 * eps / 2.0) ** (1 / 3)
    qr_coefs, chol_coefs = _schedule(eps, max_iterations)
    for params in qr_coefs:
        u = _use_qr(u, params)
    is_not_converged = True
    for i, params in enumerate(chol_coefs):
        u_prev = u
        u = _use_cholesky(u, params)
        if i == len(chol_coefs) - 1:  # the one test the JAX loop keeps
            is_not_converged = bool(torch.linalg.norm(u - u_prev) > tol_norm)
    # l has converged: Halley's method (a, b, c = 3, 1, 3) until u has too
    num_iters = len(qr_coefs) + len(chol_coefs)
    halley = tuple(map(_f32, (3 - 1 / 3, 3, 1 / 3)))
    while is_not_converged and num_iters < max_iterations:
        u_prev = u
        u = _use_cholesky(u, halley)
        is_not_converged = bool(torch.linalg.norm(u - u_prev) > tol_norm)
        num_iters += 1
    # one Newton-Schulz step for accuracy: 1.5 u - 0.5 u (uᵀu)
    u = kernel_matmul(u, _matmul(u, u, ta=True, precision=_HI), u, alpha=-0.5, beta=1.5,
                      precision=_HI)
    h = _matmul(u, x, ta=True, precision=_HI)
    h = (h + h.T) / 2
    return u, h, num_iters, not is_not_converged


def qdwh(x: torch.Tensor, *, is_hermitian: bool = False, max_iterations: Optional[int] = None,
         eps: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor, int, bool]:
    """Polar decomposition x = u h of an M x N tensor (M >= N) by QDWH, on
    x's device: (u, h, the number of iterations, whether the iterate
    converged within max_iterations, default 10). eps (default: the
    dtype's) sets the schedule and the test ||u_k - u_k-1||_F <
    (5 eps)^(1/3). is_hermitian is accepted and unused, as in the JAX
    module."""
    del is_hermitian
    if x.dim() != 2 or x.shape[0] < x.shape[1]:
        raise ValueError(f"The input matrix of shape M x N must have M >= N, got "
                         f"{tuple(x.shape)}")
    max_iterations = 10 if max_iterations is None else int(max_iterations)
    if eps is None:
        eps = float(torch.finfo(x.dtype).eps)
    return _qdwh(x, max_iterations, eps)


def _eigh(h: torch.Tensor):
    """(eigenvalues, eigenvectors) of the symmetric h by torch.linalg.eigh.
    On a CUDA device PyTorch solves a float32 matrix of order 32 to 512 by
    cuSOLVER's Jacobi solver (syevj), whose eigenvectors came out 9.9e-5
    (order 256) and 2.4e-4 (order 512) off orthonormal on an H100, against
    1.2e-6 by syevd at 513 (experiments/eigh_f32.py); a float32 matrix of
    order up to 512 is therefore solved in float64 (syevd) and rounded
    back, a larger one by syevd in float32."""
    if h.dtype == torch.float32 and h.shape[0] <= 512:
        s, v = torch.linalg.eigh(h.double())
        return s.float(), v.float()
    return torch.linalg.eigh(h)


def _svd_tall_and_square_input(a: torch.Tensor, compute_uv: bool, max_iterations: int):
    """SVD of an m x n tensor, m >= n: (u, s, v) with a = (u s) vᵀ and s
    descending, or s alone."""
    u_p, h, _, _ = qdwh(a, max_iterations=max_iterations)
    # eigh raises on a non-finite matrix where JAX's returns NaN: a
    # non-finite h is replaced by 0 here and the results by NaN below
    finite = torch.isfinite(h).all()
    s, v = _eigh(torch.where(finite, h, torch.zeros_like(h)))
    s = torch.where(finite, s.clamp_min(0.0), torch.full_like(s, float("nan")))
    sort_idx = torch.argsort(s, descending=True, stable=True)
    s_out = s[sort_idx]
    if not compute_uv:
        return s_out
    v_out = v[:, sort_idx]
    u_out = _matmul(u_p, v_out, precision=_HI)
    # a numerically rank-deficient a leaves u_p short of orthonormal
    # (Nakatsukasa and Higham, section 5.5): one QR, signs from diag(r)
    eps = float(torch.finfo(a.dtype).eps)
    if bool(s_out[-1] <= a.shape[1] * eps * s_out[0]):
        u_out, r = torch.linalg.qr(u_out, mode="reduced")
        d = torch.diagonal(r)
        u_out = u_out * torch.where(d >= 0, torch.ones_like(d), -torch.ones_like(d))
    return u_out, s_out, v_out


def svd(a: torch.Tensor, full_matrices: bool = False, compute_uv: bool = True,
        max_iterations: int = 10):
    """Thin SVD of a tensor by QDWH, on a's device: (u, s, vh) with
    a = (u s) vh, s descending, or s alone when compute_uv=False. A
    non-finite input gives NaN factors. Only the thin form is ported
    (full_matrices=False): the JAX package asks for no other."""
    if full_matrices:
        raise ValueError("svd(full_matrices=True) is not ported: the JAX package asks "
                         "only for the thin SVD")
    if a.dim() != 2:
        raise ValueError(f"svd expects a matrix, got {tuple(a.shape)}")
    m, n = a.shape
    is_flip = m < n
    if is_flip:
        a = a.T
        m, n = n, m
    reduce_to_square = m > 1.15 * n
    if reduce_to_square:
        q, a = torch.linalg.qr(a, mode="reduced")
    if not compute_uv:
        return _svd_tall_and_square_input(a, False, max_iterations)
    u_out, s_out, v_out = _svd_tall_and_square_input(a, True, max_iterations)
    if reduce_to_square:
        u_out = _matmul(q, u_out, precision=_HI)
    finite = torch.isfinite(a).all()
    nan = float("nan")
    u_out, s_out, v_out = (torch.where(finite, t, torch.full_like(t, nan))
                           for t in (u_out, s_out, v_out))
    if is_flip:
        return v_out, s_out, u_out.T
    return u_out, s_out, v_out.T
