"""The control on the card: the program's readings stay within each cell's
limit, and the control's (the program with TF32 switched on, control.py's
"tf32" mode) fail it, on three seeds, at a size that a test run holds (N=8192
for the Cholesky cell, 131,072x512 for TSQR; the cells' own sizes are in
PERF.md).

    python -m pytest perfbench/tests -q -m card
"""

import pytest

import control

SIZES = {
    "chol-n65536": {"traffic": {"shape": {"n": 8192}}},
    "tsqr-m1048576-b512": {"traffic": {"shape": {"m": 131072, "b": 512}}},
}
SEEDS = [2**31 + 11, 2**31 + 12, 2**31 + 13]


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_fails_where_the_program_passes(name, cuda):
    rows = control.readings(name, SEEDS, ["program", "tf32"], cuda, overrides=SIZES[name])
    for row in rows:
        within = all(v <= row["limits"][k] for k, v in row["values"].items())
        assert within == (row["mode"] == "program"), row
