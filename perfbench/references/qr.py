"""Plain reference of tall-skinny QR: Householder QR in float64
(torch.linalg.qr, reduced), in PyTorch alone.

compare() judges the thin Q and R that the program wrote. QR is unique up
to the signs of R's rows, so the program's columns of Q and rows of R
are first given the reference's signs (sign(diag R_ref)·sign(diag R)):

    r_err  ‖R − R_ref‖_F / ‖R_ref‖_F, in float64
    q_err  ‖Q − Q_ref‖_F / ‖Q_ref‖_F, in float64, a block of rows at a time
"""

from __future__ import annotations

import math

import torch

ROWS = 1 << 16  # rows of Q compared at a time


def compare(operand, output: dict, entry: dict) -> dict:
    q_ref, r_ref = torch.linalg.qr(operand.double())
    r = output["R"].double()
    flip = torch.sign(torch.diagonal(r_ref)) * torch.sign(torch.diagonal(r))
    flip[flip == 0] = 1.0
    r_err = float(torch.linalg.norm(flip[:, None] * r - r_ref) / torch.linalg.norm(r_ref))
    q = output["Q"]
    num = den = 0.0
    for i in range(0, q.shape[0], ROWS):
        want = q_ref[i:i + ROWS]
        num += float((q[i:i + ROWS].double() * flip - want).square().sum())
        den += float(want.square().sum())
    return {"r_err": r_err, "q_err": math.sqrt(num / den)}
