#!/usr/bin/env python3
"""The matmul kernel's slice depth, measured: 64-deep slices (128-byte
swizzle, two 96 KB stages at three planes; what csrc/gemm_split.cu ships)
against 32-deep ones (64-byte swizzle, four 48 KB stages).

    python3 numpywren_tpu_torch/experiments/gemm_slice_depth.py   # with a GPU

Copies the port twice under _checkout/ (git-ignored), the second copy with
the 32-deep constants, and times the trailing update c - a bᵀ (31744x1024
by 1024ᵀ) in each, in turns (64, 32, 32, 64), each in its own process that
builds its own kernels; also the error against fp64 at K = 1024 and 8192.
Prints one JSON line a run, then the card's name and power limit.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout's root
WORK = ROOT / "_checkout" / "slice_depth"

# (old, new) edits that turn the shipped 64-deep kernel into the 32-deep one
SHALLOW = {
    "numpywren_tpu_torch/csrc/gemm_split.cu": [
        ("BN = 128, BK = 64;", "BN = 128, BK = 32;"),
        ("(uint64_t)(1024 >> 4) << 32;", "(uint64_t)(512 >> 4) << 32;"),
        ("(uint64_t)1 << 62;", "(uint64_t)2 << 62;"),
        ("cw * 64 * 128)", "cw * 64 * 64)"),
        ("CU_TENSOR_MAP_SWIZZLE_128B", "CU_TENSOR_MAP_SWIZZLE_64B"),
    ],
    "numpywren_tpu_torch/ops/gemm.py": [("SLICE = 64 ", "SLICE = 32 ")],
}

TIMING = r"""
import importlib, json, sys
import torch
g = importlib.import_module("numpywren_tpu_torch.ops.gemm")
gen = torch.Generator(device="cuda").manual_seed(0)

def ms(fn, iters=20):
    fn(); torch.cuda.synchronize()
    s, t = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    t.record(); t.synchronize()
    return s.elapsed_time(t) / iters

m, k, n = 31744, 1024, 1024
a, b, c = (torch.randn(*s, device="cuda", generator=gen) for s in ((m, k), (n, k), (m, n)))
run = lambda: g.matmul(a, b, c, tb=True, alpha=-1.0, beta=1.0, precision="highest")
errs = {}
for kk in (1024, 8192):
    x, y, z = (torch.randn(*s, device="cuda", generator=gen) for s in ((4096, kk), (1024, kk), (4096, 1024)))
    e = z.double() - x.double() @ y.double().T
    r = g.matmul(x, y, z, tb=True, alpha=-1.0, beta=1.0, precision="highest")
    errs[kk] = float((r.double() - e).norm() / e.norm())
print(json.dumps({"slice": g.SLICE, "plan": g.split_plan(3), "ms": [ms(run), ms(run)],
                  "rel_err_vs_fp64": errs}), flush=True)
"""


def copy(depth: int) -> Path:
    dst = WORK / f"slice{depth}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "numpywren_tpu_torch", dst / "numpywren_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "*.so"))
    for rel, edits in (SHALLOW.items() if depth == 32 else ()):
        path = dst / rel
        text = path.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{rel}: {old!r} not found; the kernel changed")
            text = text.replace(old, new)
        path.write_text(text)
    return dst


def main() -> int:
    trees = {d: copy(d) for d in (64, 32)}
    for depth in (64, 32, 32, 64):
        proc = subprocess.run([sys.executable, "-c", TIMING], cwd=trees[depth],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
