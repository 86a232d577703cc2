"""Readings that the limits of `correct` are set from, in one process:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--modes program,tf32] [--out FILE]

For each seed and mode: a new run of the cell makes its operand from the
seed, warms up, sends one request through the timed path (the entry, then
run_program), keeps its answer, and compares it with the plain reference
as a run does. Modes:

    program    the configuration as stated (the lower reading)
    tf32       the control: the program with its TF32 path switched on and
               compensated products off, so every product runs in TF32,
               the precision below the configuration's fp32

One JSON line a reading on stdout (and appended to --out).
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import harness  # noqa: E402

MODES = ("program", "tf32")


def set_mode(mode: str, compensated: bool) -> None:
    import torch

    from numpywren_tpu_torch.config import default_config

    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    default_config().compensated = compensated and mode != "tf32"
    torch.backends.cuda.matmul.allow_tf32 = mode != "program"


def reading(cell, seed: int, mode: str, device) -> dict:
    """One request of `cell` on the operand of `seed` under `mode`, and its
    comparison with the reference."""
    import torch

    from numpywren_tpu_torch.config import NpwConfig

    set_mode(mode, NpwConfig.from_env().compensated)
    run = harness.Run(cell, seed, device)
    run.setup()
    t0 = time.perf_counter()
    run.stretch(0.0)  # one request, its answer kept
    seconds = time.perf_counter() - t0
    set_mode("program", NpwConfig.from_env().compensated)
    checks, ok = run.check()
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"workload": cell.name, "seed": seed, "mode": mode, "seconds": seconds,
            "values": {k: c["value"] for k, c in checks.items()},
            "limits": {k: c["limit"] for k, c in checks.items()}, "within": ok}


def readings(name: str, seeds, modes, device, overrides=None, out=None):
    """Every (seed, mode) reading of cell `name`; one operand, one kept
    answer and one warm-up request a reading."""
    over = dict(overrides or {})
    over["traffic"] = {**over.get("traffic", {}), "operands": 1, "check_samples": 1,
                       "warmup": 1}
    cell = harness.load_cell(name, overrides=over)
    harness.apply_env(cell)
    rows = []
    for seed in seeds:
        for mode in modes:
            row = reading(cell, seed, mode, device)
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(line + "\n")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program,tf32")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 1
    readings(args.workload, [int(s) for s in args.seeds.split(",")], args.modes.split(","),
             torch.device("cuda", 0), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
