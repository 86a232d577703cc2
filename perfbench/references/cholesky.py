"""Plain reference of the trapezoid Cholesky: a right-looking blocked
Cholesky in float64 over the operand's column blocks, in PyTorch alone
(torch.linalg.cholesky on each diagonal block, a triangular solve for the
panel below it, one product per later column block).

compare() judges a factor L that the program wrote:

    l_err  ‖L − L_ref‖_F / ‖L_ref‖_F over every column block, in float64
"""

from __future__ import annotations

import math

import torch


def factor(cols, panel: int) -> None:
    """In place: the float64 column blocks of A become those of its lower
    Cholesky factor (A's lower triangle is read)."""
    nb = len(cols)
    for p in range(nb):
        d = cols[p][:panel]
        low = d.tril()
        ld = torch.linalg.cholesky(low + low.tril(-1).T)
        d.copy_(ld)
        b = cols[p][panel:]
        if b.shape[0] == 0:
            continue
        # b ← b L⁻ᵀ
        b.copy_(torch.linalg.solve_triangular(ld.T, b, upper=True, left=False))
        for c in range(p + 1, nb):
            off = (c - p - 1) * panel
            cols[c].addmm_(b[off:], b[off:off + panel].T, alpha=-1.0)


def compare(operand, output: dict, entry: dict) -> dict:
    """{"l_err": ...} of output["L"] (fp32 column blocks) against the
    reference factor of `operand` (the column blocks the program was
    given)."""
    ref = [c.double() for c in operand]
    factor(ref, entry["panel"])
    num = den = 0.0
    for got, want in zip(output["L"], ref):
        num += float((got.double() - want).square().sum())
        den += float(want.square().sum())
    del ref
    return {"l_err": math.sqrt(num / den)}
