"""Factorization tile ops: potrf / trsm / QR / LQ on the device.

Counterpart of numpywren_tpu/ops/factor.py. The reference hands the
sequential triangular cores to XLA's library routines (cholesky,
triangular_solve, qr); here they are the torch.linalg equivalents
(cuSOLVER on the card, LAPACK on the CPU), and the gemm-shaped
``small_qr_apply`` goes through the port's ``ops.gemm.matmul``. The one
kernel is opt-in: ``NPW_PALLAS_QR=1``, read at each call, sends
``qr_leaf`` to ``pallas_factor.qr_pallas`` (csrc/qr.cu) for tiles inside its
envelope.

Tile in, tile out, dtype-preserving, with the numpy reference kernels'
conventions (kernels.py). The full-Q pairwise ops (``qr_factor2`` ...)
batch over leading axes.
"""

from __future__ import annotations

import os

import torch


def potrf(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of an SPD tile (or a stack of them). As
    lax.linalg.cholesky: the input is symmetrized, and a matrix that is not
    positive definite gives NaNs in the lower triangle, not an error."""
    l, info = torch.linalg.cholesky_ex((a + a.mT) * 0.5)
    return torch.where((info == 0)[..., None, None], l, torch.tril(torch.full_like(l, float("nan"))))


def trsm(a: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Solve X Lᵀ = A for X (the Cholesky panel op)."""
    return torch.linalg.solve_triangular(l.mT, a, upper=True, left=False)


def qr_leaf(a: torch.Tensor):
    """Thin QR of a (tall) tile: (Q, R). NPW_PALLAS_QR=1 opts into the
    blocked-Householder kernel (pallas_factor.qr_pallas) for tiles inside
    its envelope, as in the reference."""
    if os.environ.get("NPW_PALLAS_QR", "0") == "1":
        from numpywren_tpu_torch.ops.pallas_factor import qr_pallas

        return qr_pallas(a)
    return torch.linalg.qr(a, mode="reduced")


def qr_combine(r_top: torch.Tensor, r_bot: torch.Tensor):
    """QR of stacked [R_top; R_bot] (TSQR tree node): (Q_top, Q_bot, R)."""
    n = r_top.shape[-2]
    q, r = torch.linalg.qr(torch.cat([r_top, r_bot], dim=-2), mode="reduced")
    return q[..., :n, :], q[..., n:, :], r


def qr_r(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(a, mode="r")[1]


def _make_qr_combine_r(m: int):
    """R of the QR of m stacked R tiles (k-ary `reducer` tree node; matches
    kernels.qr_combine_r{m} semantics)."""
    def f(*rs):
        return qr_r(torch.cat(rs, dim=-2))

    f.__name__ = f"qr_combine_r{m}"
    return f


def lq_leaf(a: torch.Tensor):
    """Thin LQ of a (wide) tile: (L, Q)."""
    q, r = torch.linalg.qr(a.mT, mode="reduced")
    return r.mT, q.mT


def small_qr_apply(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """qᵀ @ a."""
    from numpywren_tpu_torch.ops.gemm import matmul

    return matmul(q, a, ta=True)


# ---------------------------------------------------------------------------
# Full-Q pairwise ops (BDFAC flat-tree sweeps; see kernels.py docstrings)
# ---------------------------------------------------------------------------

def qr_factor2(top: torch.Tensor, bot: torch.Tensor):
    """Complete QR of [top; bot]: (qtt, qtb, qbt, qbb, r)."""
    t = top.shape[-2]
    q, r = torch.linalg.qr(torch.cat([top, bot], dim=-2), mode="complete")
    return (q[..., :t, :t], q[..., :t, t:], q[..., t:, :t], q[..., t:, t:], r[..., :t, :])


def qr_apply2(qtt, qtb, qbt, qbb, yt, yb):
    new_t = qtt.mT @ yt + qbt.mT @ yb
    new_b = qtb.mT @ yt + qbb.mT @ yb
    return new_t, new_b


def lq_factor2(left: torch.Tensor, right: torch.Tensor):
    """Complete LQ of [left right]: (qtt, qtb, qbt, qbb, l)."""
    t = left.shape[-2]
    qc, rc = torch.linalg.qr(torch.cat([left, right], dim=-1).mT, mode="complete")
    q = qc.mT
    l = rc[..., :t, :].mT
    return (q[..., :t, :t], q[..., :t, t:], q[..., t:, :t], q[..., t:, t:], l)


def lq_apply2(qtt, qtb, qbt, qbb, yl, yr):
    new_l = yl @ qtt.mT + yr @ qtb.mT
    new_r = yl @ qbt.mT + yr @ qbb.mT
    return new_l, new_r
