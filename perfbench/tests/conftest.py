"""The benchmark's own tests. CPU tests run the harness at tiny sizes on
the port's plain paths; tests marked `card` need a CUDA device and skip
without one (the decision is made in the `cuda` fixture, never at import).

    python -m pytest perfbench/tests -q                  # here
    python -m pytest perfbench/tests -q -m card          # on the card
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny sizes for the CPU: every entry's arguments scaled down, the code path kept
TINY = {
    "chol-n65536": {"config": {"entry": {"panel": 64}},
                    "traffic": {"shape": {"n": 256}, "trace_seconds": 0.2}},
    "tsqr-m1048576-b512": {"config": {"entry": {"tile_rows": 256}},
                           "traffic": {"shape": {"m": 2048, "b": 32}, "trace_seconds": 0.2}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
