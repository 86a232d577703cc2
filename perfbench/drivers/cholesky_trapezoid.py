"""Driver of the trapezoid Cholesky: a user's call of
numpywren_tpu_torch.cholesky(X, storage="trapezoid") on a TrapezoidMatrix,
then run_program(program) (executor "auto": the fused lowering).

The entry factors its operand's column buffers in place, so each request
first restores them from the benchmark's pristine copy on the device.

Work: n³/3 operations a factorization, whatever method computes it.
"""

from __future__ import annotations

import math

import torch


def work(shape: dict) -> float:
    return shape["n"] ** 3 / 3


def make_operand(shape: dict, entry: dict, seed: int, device):
    """The trapezoid column blocks (fp32) of an SPD A = S + 2I, S a symmetric
    random matrix whose entries below the diagonal are N(0, 2s²), s =
    0.5/sqrt(n), and whose diagonal entries are N(0, 4s²): S's spectral
    radius is about 2·sqrt(n·2s²) = sqrt(2), below the shift of 2, so κ(A)
    is about 6. This is bench_torch.py's blockwise_columns operand (A[i, j]
    = s (R(i, j) + R(j, i)ᵀ) + 2I[i == j]), frozen here, with the same
    distribution drawn one column block a call instead of one panel² block
    a call: column block c holds rows [c·panel, n) of columns
    [c·panel, (c + 1)·panel)."""
    n, panel = shape["n"], entry["panel"]
    if n % panel:
        raise ValueError(f"n={n} must be a multiple of panel={panel}")
    s = 0.5 / math.sqrt(n)
    gen = torch.Generator(device=device).manual_seed(seed)
    cols = []
    for c in range(n // panel):
        col = torch.randn(n - c * panel, panel, generator=gen, device=device)
        col.mul_(s * math.sqrt(2.0))
        d = col[:panel]
        d.copy_((d + d.T) / math.sqrt(2.0))
        d.diagonal().add_(2.0)
        cols.append(col)
    return cols


class Driver:
    """One user's loop over `operands` (each a list of column blocks)."""

    def __init__(self, shape: dict, entry: dict, operands, device):
        import numpywren_tpu_torch as npw

        self.npw = npw
        self.n, self.entry = shape["n"], entry
        self.operands = operands
        # the matrix the user hands the entry: its buffers are factored in place
        self.work = [torch.empty_like(c) for c in operands[0]]
        self.prog = self.factor = None
        self.held = []

    def allocate_holders(self, count: int) -> None:
        self.held = [[torch.empty_like(c) for c in self.work] for _ in range(count)]

    def restore(self, k: int) -> None:
        self.prog = self.factor = None
        for w, p in zip(self.work, self.operands[k]):
            w.copy_(p)

    def bind(self, k: int) -> None:
        t = self.npw.TrapezoidMatrix(self.work, self.n, self.entry["panel"])
        # no tile: the entry binds its default, as a user's call does
        self.prog, self.factor, _ = self.npw.cholesky(
            t, storage="trapezoid", panel=self.entry["panel"])

    def run(self) -> None:
        self.npw.run_program(self.prog)

    def hold(self, slot: int) -> None:
        """Copy the factor that the last request wrote (the column buffers
        the program's L holds) into holder `slot`."""
        for h, c in zip(self.held[slot], self.factor.trap.cols):
            h.copy_(c)

    def held_output(self, slot: int) -> dict:
        return {"L": self.held[slot]}

    def free(self) -> None:
        """Drop the program's state: its matrices and the user's buffers."""
        self.prog = self.factor = None
        self.work = []
