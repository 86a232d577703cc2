"""The benchmark of numpywren_tpu_torch, one cell a process:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with as many CUDA devices as
the cell asks for (BENCHMARK.json). The run makes its operands on the device
from the seed, warms up its cell's shapes (set-up), sends its requests for
--seconds, compares the answers it kept with the plain reference, and
prints one JSON line as the last line of stdout:

    {"correct", "attempted", "failed", "metrics", "device", ...,
     "checks": {name: {"value", "limit"}}}

--trace 0 reports the cell's end-to-end metrics; --trace 1 its per-layer
metrics, with the device's busy time, the traced window and a breakdown
from torch.profiler. The numbers compared are also the last lines of
stderr. Without a CUDA device, with fewer than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits 1.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # the port, at the checkout's root

import harness  # noqa: E402


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def finite(x):
    """The result with every NaN or infinity as null: the line stays JSON."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.apply_env(cell)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"needs {cell.chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"forbidden modules loaded: {bad}")
        return 1
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
