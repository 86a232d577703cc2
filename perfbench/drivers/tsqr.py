"""Driver of tall-skinny QR: a user's call of numpywren_tpu_torch.tsqr(X,
tile_rows=..., method=..., compute_q=True) on a tall fp32 tensor, then
run_program(program) (executor "auto": the fused lowering).

The entry copies X into its own store, so a request needs no restore.

Work: LAPACK's geqrf + orgqr, 4mb² − 4b³/3 operations, since the user gets
both R and the thin Q, whatever method computes them.
"""

from __future__ import annotations

import torch


def work(shape: dict) -> float:
    m, b = shape["m"], shape["b"]
    return 4 * m * b * b - 4 * b ** 3 / 3


def make_operand(shape: dict, entry: dict, seed: int, device):
    """X = 0.1·N(0, 1), m x b fp32, in one call (bench_torch.py's
    bench_tsqr operand, frozen here): κ about (1 + sqrt(b/m))/(1 − sqrt(b/m))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape["m"], shape["b"], generator=gen, device=device).mul_(0.1)


class Driver:
    """One user's loop over `operands` (each an m x b tensor)."""

    def __init__(self, shape: dict, entry: dict, operands, device):
        import numpywren_tpu_torch as npw

        self.npw = npw
        self.m, self.b = shape["m"], shape["b"]
        self.entry = entry
        self.operands = operands
        self.prog = self.out = None
        self.held = []

    def allocate_holders(self, count: int) -> None:
        dev = self.operands[0].device
        self.held = [{"Q": torch.empty(self.m, self.b, device=dev),
                      "R": torch.empty(self.b, self.b, device=dev)} for _ in range(count)]

    def restore(self, k: int) -> None:
        # the last request's program and outputs go, as in a user's loop
        self.prog = self.out = None

    def bind(self, k: int) -> None:
        self.prog, self.out, _ = self.npw.tsqr(
            self.operands[k], tile_rows=self.entry["tile_rows"], method=self.entry["method"],
            compute_q=True)

    def run(self) -> None:
        self.npw.run_program(self.prog)

    def hold(self, slot: int) -> None:
        """Copy the Q and R that the last request wrote into holder `slot`."""
        q = self.out["Q"].array[:self.m, :self.b]
        r = self.out["R"].get_block(*self.out["R_block"])
        self.held[slot]["Q"].copy_(q)
        self.held[slot]["R"].copy_(r)

    def held_output(self, slot: int) -> dict:
        return self.held[slot]

    def free(self) -> None:
        self.prog = self.out = None
