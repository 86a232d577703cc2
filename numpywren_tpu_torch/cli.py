"""Command-line interface: environment inspection and smoke-level
verification of the port.

    python -m numpywren_tpu_torch info [--device cpu]     # devices, mesh, memory
    python -m numpywren_tpu_torch doctor [--device cpu]   # store + kernel + program + models
    python -m numpywren_tpu_torch bench ...               # runs the repo's bench_torch.py

The counterpart of numpywren_tpu/cli.py. `info` and `doctor` run on the
current CUDA device and exit 1 on a host without one unless given
`--device cpu`. The doctor's kernel check runs `matmul` at "highest", the
hand-written split GEMM (csrc/gemm_split.cu), and on a card also checks
that the kernel was launched.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "bench_torch.py")


def _device(args):
    """args.device as a torch.device; None, with the reason on stderr, when
    "cuda" is asked for on a host without a CUDA device."""
    from numpywren_tpu_torch.ops.common import default_device

    if args.device == "cpu":
        return torch.device("cpu")
    try:
        return default_device()
    except RuntimeError as e:
        print(f"numpywren_tpu_torch {args.cmd}: {e}", file=sys.stderr)
        return None


def _expect(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(what)


def cmd_info(args) -> int:
    from numpywren_tpu_torch.parallel.mesh import _factor_2d

    device = _device(args)
    if device is None:
        return 1
    if device.type == "cuda":
        devs = [{"id": i, "kind": torch.cuda.get_device_name(i), "platform": "gpu"}
                for i in range(torch.cuda.device_count())]
    else:
        devs = [{"id": 0, "kind": "cpu", "platform": "cpu"}]
    info = {
        "backend": "gpu" if device.type == "cuda" else "cpu",
        "devices": devs,
        "default_mesh": _factor_2d(len(devs)),
    }
    if device.type == "cuda":
        info["hbm_bytes_limit"] = torch.cuda.get_device_properties(device).total_memory
        info["hbm_bytes_in_use"] = torch.cuda.memory_allocated(device)
    print(json.dumps(info, indent=2))
    return 0


def cmd_doctor(args) -> int:
    """Smoke: store round-trip, one split-GEMM kernel call, one fused
    program, the models; each on args.device."""
    import numpy as np

    device = _device(args)
    if device is None:
        return 1
    failures = []

    def check(name, fn):
        try:
            fn()
            print(f"ok   {name}")
        except Exception as e:  # noqa: BLE001 - doctor reports, not raises
            failures.append(name)
            print(f"FAIL {name}: {e!r}")

    def store():
        from numpywren_tpu_torch.matrix_init import shard_matrix

        a = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
        m = shard_matrix(a, tile=(32, 32), device=device)
        _expect(np.array_equal(m.numpy(), a), "round-trip differs")

    def kernel():
        gemm = importlib.import_module("numpywren_tpu_torch.ops.gemm")

        x = torch.ones((256, 256), dtype=torch.float32, device=device)
        launches = gemm.LAUNCHES
        y = float(gemm.matmul(x, x, precision="highest")[0, 0])
        _expect(y == 256.0, y)
        if device.type == "cuda":
            _expect(gemm.LAUNCHES == launches + 1,
                    f"matmul kernel launches {gemm.LAUNCHES - launches}, expected 1")

    def program():
        import numpywren_tpu_torch as npw
        from numpywren_tpu_torch.matrix_init import random_spd

        a = random_spd(128, seed=0)
        prog, l, _ = npw.cholesky(a, tile=(32, 32), device=device)
        npw.run_program(prog)
        ln = l.numpy()
        resid = np.linalg.norm(a - ln @ ln.T) / np.linalg.norm(a)
        _expect(resid < 1e-4, resid)

    def model():
        from numpywren_tpu_torch import models

        rng = np.random.default_rng(0)
        x = rng.standard_normal((96, 96)).astype(np.float32)
        s = models.singular_values(x, tile=32, device=device)
        s_ref = np.linalg.svd(x.astype(np.float64), compute_uv=False)
        _expect(abs(s[0] - s_ref[0]) / s_ref[0] < 1e-3, (s[0], s_ref[0]))
        a = rng.standard_normal((128, 8)).astype(np.float32)
        beta = rng.standard_normal(8).astype(np.float32)
        sol = models.least_squares(a, a @ beta, device=device)
        _expect(np.linalg.norm(sol - beta) / np.linalg.norm(beta) < 1e-3, sol)

    check("tiled store round-trip", store)
    check("device matmul kernel", kernel)
    check("fused cholesky program", program)
    check("models (svd + least squares)", model)
    return 1 if failures else 0


def cmd_bench(rest) -> int:
    """Delegate to the repo-root bench_torch.py when present, passing every
    argument after `bench` through as it is."""
    import subprocess

    if os.path.exists(BENCH):
        return subprocess.call([sys.executable, BENCH] + list(rest))
    print("bench_torch.py not found", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="numpywren_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, help_ in (("info", "show devices / mesh / device memory"),
                        ("doctor", "smoke-test store, kernels, programs")):
        s = sub.add_parser(name, help=help_)
        s.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="run on the current CUDA device (default) or the CPU")
    sub.add_parser("bench", help="run bench_torch.py with the arguments that follow",
                   add_help=False)
    if argv[:1] == ["bench"]:  # bench's options are bench_torch.py's, not parsed here
        return cmd_bench(argv[1:])
    args = p.parse_args(argv)
    return {"info": cmd_info, "doctor": cmd_doctor}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
