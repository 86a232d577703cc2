"""The one traffic generator: a traffic file's parameters and a seed give
the sequence of requests a run sends.

A traffic file (perfbench/traffic/<name>.json) holds:

    loop           "closed": one client sends its next request when the
                   previous one has completed (the way a solver is called
                   from a user's program)
    clients        1
    shape          the operand's sizes, handed to the configuration's driver
    operands       how many distinct operands the run makes; request i
                   solves operand order[i % operands], order a permutation
                   drawn from the seed
    check_samples  how many of the window's answers are kept and compared
                   with the reference once the window has closed: a uniform
                   sample of all requests (reservoir sampling), drawn from
                   the seed
    warmup         requests run in set-up, before the window
    trace_seconds  the length of a traced run's stretch

Every seed gives the same sizes and the same number of operands: only the
values and the order change, so runs of two seeds do the same work.
"""

from __future__ import annotations

import random

import numpy as np

FIELDS = ("loop", "clients", "shape", "operands", "check_samples", "warmup", "trace_seconds")


def validate(traffic: dict) -> dict:
    """The traffic file's parameters, checked."""
    missing = [k for k in FIELDS if k not in traffic]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("this generator sends a closed loop of one client")
    for k in ("operands", "check_samples", "warmup"):
        if not (isinstance(traffic[k], int) and traffic[k] >= 1):
            raise ValueError(f"{k} must be a whole number >= 1")
    if not traffic["trace_seconds"] > 0:
        raise ValueError("trace_seconds must be > 0")
    return traffic


def substream(seed: int, *key: int) -> int:
    """A 63-bit seed for the stream `key` of run `seed` (any whole seed,
    also one past 32 bits)."""
    words = np.random.SeedSequence([int(seed) & (2**128 - 1), *key]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


class Schedule:
    """The requests of one run: which operand each solves, the operands'
    seeds, and which answers are kept for the check."""

    def __init__(self, traffic: dict, seed: int):
        validate(traffic)
        self.shape = dict(traffic["shape"])
        self.warmup = traffic["warmup"]
        self.samples = traffic["check_samples"]
        self.trace_seconds = float(traffic["trace_seconds"])
        n_ops = traffic["operands"]
        self.operand_seeds = [substream(seed, 0, j) for j in range(n_ops)]
        self.order = list(range(n_ops))
        random.Random(substream(seed, 1)).shuffle(self.order)
        self._pick = random.Random(substream(seed, 2))

    def operand(self, i: int) -> int:
        """The operand of request i (warm-up requests count from 0 apart)."""
        return self.order[i % len(self.order)]

    def sample_slot(self, i: int):
        """The holder slot that request i's answer goes to, or None: after
        all requests, the slots hold a uniform sample of them (Algorithm R).
        Call once for each request, in order."""
        if i < self.samples:
            return i
        j = self._pick.randrange(i + 1)
        return j if j < self.samples else None
