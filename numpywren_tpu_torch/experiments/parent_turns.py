#!/usr/bin/env python3
"""This checkout against another tree of the port (an earlier commit's,
unpacked with `git archive`), in turns on one card.

    git archive <commit> | tar -x -C _checkout/parent      # _checkout/ is git-ignored
    python3 numpywren_tpu_torch/experiments/parent_turns.py _checkout/parent          # with a GPU
    python3 numpywren_tpu_torch/experiments/parent_turns.py _checkout/parent --smoke  # + chip_smoke.py

Runs the timing below in each tree in turns (other, this, this, other),
each in its own process that builds that tree's kernels and imports only
its package, through names both trees have (gemm3.matmul3,
TrapezoidMatrix, cholesky_trapezoid, cholesky, shard_matrix, run_program,
NpwConfig.compensated):
- matmul3's mean ms a call (CUDA events, 20 warm calls) at chip_smoke.py
  P1's cases: the trailing update 31744x1024 by 1024ᵀ with -c, rtrsm_512,
  leaf_128 and ragged;
- the compensated Cholesky of chip_smoke.py P2's operand (N=32768, panel
  1024; A = X Xᵀ/N + 2I, X from a seeded generator on the card) through
  cholesky_trapezoid: device seconds (CUDA events) of two runs, TFLOP/s
  (N³/3 flops) and the residual ||A - L Lᵀ||_F / ||A||_F in fp64;
- P5's flat compensated Cholesky (N=16384, storage tile 512) through
  cholesky(shard_matrix(A)) + run_program: device seconds of two runs;
- the CholeskyQR2 chain (pallas_factor.cholqr2_chain_pallas) at
  chip_smoke.py P7's 1,048,576 x 256, kappa 10, in both forms: mean ms a
  call (CUDA events, 10 warm calls) and one warm call's device ms under
  torch.profiler by this checkout's chip_smoke.chain_split (in both
  trees): step 0 (every launch before the apply), the apply's pack and
  mainloop (csrc/gemm_split.cu) or its one FFMA launch (csrc/gemm.cu,
  trees before the bf16x6 apply), the launches recorded, the profiled
  call's ms by CUDA events and the profiler's span of its launches.
With --smoke, then each tree's own chip_smoke.py in turns, printing its
P2-P5, P7, P9, P10 and P12 lines and its kernels line. Prints one JSON
line a run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # this checkout's root

TIMING = r"""
import json, sys
import torch
import numpywren_tpu_torch as npw
from numpywren_tpu_torch.ops import gemm3

n, panel = int(sys.argv[1]), 1024
gen = torch.Generator(device="cuda").manual_seed(0)

def ms(fn, iters=20):
    fn(); torch.cuda.synchronize()
    s, t = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    t.record(); t.synchronize()
    return s.elapsed_time(t) / iters

row = {"tree": sys.argv[2], "ms": {}}
for name, m, k, nn, with_c in (("trailing", 31744, 1024, 1024, True),
                               ("rtrsm_512", 31744, 512, 512, False),
                               ("leaf_128", 31744, 128, 128, False),
                               ("ragged", 1000, 300, 777, True)):
    a, b = (torch.randn(*s, device="cuda", generator=gen) for s in ((m, k), (nn, k)))
    c = torch.randn(m, nn, device="cuda", generator=gen) if with_c else None
    row["ms"][name] = ms(lambda: gemm3.matmul3(a, b, c, tb=True))
    del a, b, c

cfg = npw.default_config()
cfg.compensated = True
w = torch.randn(2048, 2048, device="cuda", generator=gen)
npw.cholesky_trapezoid(npw.TrapezoidMatrix.from_array(w @ w.T / 2048 + 2 * torch.eye(
    2048, device="cuda"), panel=panel))
x = torch.randn(n, n, device="cuda", generator=gen)
a = (x @ x.T / n).tril_()
del x
a.diagonal().add_(2.0)
a += a.tril(-1).T  # symmetric: the lower triangle the factorization reads
secs = []
for _ in range(2):
    t = npw.TrapezoidMatrix.from_array(a, panel=panel)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    l = npw.cholesky_trapezoid(t)
    e.record(); e.synchronize()
    secs.append(s.elapsed_time(e) / 1e3)
    del t
f = l.to_array().double()
del l
num = den = 0.0
for j0 in range(0, n, 2048):
    aj = a[:, j0:j0 + 2048].double()
    r = aj - f @ f[j0:j0 + 2048].T
    num += float((r * r).sum()); den += float((aj * aj).sum())
row.update(n=n, cholesky_seconds=secs, tflops=[n ** 3 / 3 / v / 1e12 for v in secs],
           residual=(num / den) ** 0.5)
del a, f, aj, r

from numpywren_tpu_torch.matrix_init import shard_matrix
n5 = n // 2
x = torch.randn(n5, n5, device="cuda", generator=gen)
a5 = (x @ x.T / n5).tril_()
del x
a5.diagonal().add_(2.0)
a5 += a5.tril(-1).T
secs5 = []
for _ in range(2):
    prog, o5, _ = npw.cholesky(shard_matrix(a5, tile=(512, 512)))
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    npw.run_program(prog)
    e.record(); e.synchronize()
    secs5.append(s.elapsed_time(e) / 1e3)
    del prog, o5
row.update(n_flat=n5, flat_seconds=secs5)
del a5

import importlib.util
from numpywren_tpu_torch.ops import pallas_factor as pf

# this checkout's chip_smoke.py (not the tree's own): one chain_split for both trees
spec = importlib.util.spec_from_file_location("chip_smoke_here", sys.argv[3])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)

m, b = 1 << 20, 256
u, _ = torch.linalg.qr(torch.randn(m, b, device="cuda", generator=gen))
v, _ = torch.linalg.qr(torch.randn(b, b, device="cuda", generator=gen))
base = (u * torch.logspace(0, -1, b, device="cuda")) @ v.T
del u
row["chain_ms"], row["chain_device_ms"] = {}, {}
for form, rows in (("cols", False), ("rows", True)):
    p = base.T.contiguous() if rows else base
    g = p @ p.T if rows else p.T @ p
    kw = smoke.chain_kw(m, b, rows)
    fn = lambda: pf.cholqr2_chain_pallas(g, p, **kw)
    row["chain_ms"][form] = ms(fn, iters=10)
    prof = smoke.chain_split(torch, fn)
    row["chain_device_ms"][form] = dict(prof["device_ms_by_part"],
                                        launches=prof["profiled_launches"],
                                        profiled_call_ms=prof["profiled_call_ms"],
                                        device_span_ms=prof["device_span_ms"])
    del p, g
print(json.dumps(row), flush=True)
"""

SMOKE_PHASES = ("P2", "P2_profile", "P3", "P4", "P5", "P7", "P9", "P10", "P12")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the other tree")
    ap.add_argument("--n", type=int, default=32768, help="the Cholesky's size (flat: half)")
    ap.add_argument("--smoke", action="store_true", help="then each tree's chip_smoke.py")
    args = ap.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": ROOT}
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, "-c", TIMING, str(args.n), name,
                               str(ROOT / "chip_smoke.py")],
                              cwd=trees[name], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip(), flush=True)
    for name in ("other", "this", "this", "other") if args.smoke else ():
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=trees[name],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else {}
            if row.get("phase") in SMOKE_PHASES or "kernels" in row:
                print(json.dumps({"tree": name, **row}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
