#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's blocked-Cholesky main path once on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from numpywren_tpu_torch/csrc, checks each
against its plain PyTorch version at the main path's shapes, then factors an
N=32768 fp32 SPD matrix (made on the card from a seeded generator) through
the user entry points in the main path's configurations:

  P0  the card, its power limit, the kernel build
  P1  each kernel vs its plain version: relative Frobenius error <= 1e-5
      (same fp32 or bf16x3 arithmetic, summation order only) and the mean
      time of >= 10 warm launches, kernel and plain in turns (CUDA events)
  P2  cholesky(TrapezoidMatrix, storage="trapezoid") + run_program with
      NpwConfig.compensated: every GEMM through the matmul3 kernel
  P3  cholesky_trapezoid(t, precision="highest"): the matmul kernel
  P4  the default configuration (torch.matmul, true FP32), the plain
      reference, and ||L_P2 - L_P4|| / ||L_P4|| <= 1e-4
  P5  the flat entry point cholesky(shard_matrix(A)) + run_program at
      N=16384, compensated

Residuals ||A - L Lᵀ||_F / ||A||_F are computed on the card in fp64 and
must be <= 1e-4. Each phase prints one JSON line; then the kernels' line,
the card's name and power limit, and last {"ok": true, "device": ...}.
Any failure exits non-zero without that last line; so does a host without
a CUDA device, or a directory without the port beside this script.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PANEL = 1024
RESID_BAR = 1e-4
KERNEL_BAR = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, kernel, plain, iters: int = 10):
    """Mean ms of `iters` warm launches each, plain-kernel-kernel-plain."""
    for fn in (kernel, plain):
        fn()
        fn()
    torch.cuda.synchronize()
    p1 = cuda_ms(torch, plain, iters)
    k1 = cuda_ms(torch, kernel, iters)
    k2 = cuda_ms(torch, kernel, iters)
    p2 = cuda_ms(torch, plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------------------
# P1: each kernel against its plain version
# ---------------------------------------------------------------------------

def p1_kernels(torch, gen):
    from numpywren_tpu_torch.ops import gemm, gemm3

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    r = 31744  # rows below the first panel at N=32768, panel 1024
    cases = [  # (name, m, k, n, with c)
        ("trailing", r, 1024, 1024, True),
        ("rtrsm_512", r, 512, 512, False),
        ("leaf_128", r, 128, 128, False),
        ("ragged", 1000, 300, 777, True),
    ]
    results = {"matmul": [], "matmul3": []}
    for name, m, k, n, with_c in cases:
        a, b = rand(m, k), rand(n, k)
        c = rand(m, n) if with_c else None
        # the library GEMM the default configuration runs (P4's route)
        lib = (lambda: torch.addmm(c, a, b.T, alpha=-1.0)) if with_c else (lambda: a @ b.T)
        lib(), torch.cuda.synchronize()
        torch_ms = cuda_ms(torch, lib, 10)
        for kern in ("matmul3", "matmul"):
            if kern == "matmul3":
                run = lambda: gemm3.matmul3(a, b, c, tb=True)  # noqa: E731
                plain = lambda: gemm3.matmul3_ref(a, b, c, tb=True)  # noqa: E731
            else:
                kw = dict(tb=True, alpha=-1.0, beta=1.0) if with_c else dict(tb=True)
                run = lambda: gemm.matmul(a, b, c, precision="highest", **kw)  # noqa: E731
                plain = lambda: gemm.matmul_ref(a, b, c, **kw)  # noqa: E731
            results[kern].append(_compare(torch, f"{kern}:{name}", m, k, n, run, plain,
                                          torch_ms=torch_ms))

    # in place, as the trailing update runs: out aliases c
    m, k, n = r, 1024, 1024
    a, b, c = rand(m, k), rand(n, k), rand(m, n)
    for kern, run, plain in (
        ("matmul3", lambda cc: gemm3.matmul3(a, b, cc, tb=True, out=cc),
         lambda: gemm3.matmul3_ref(a, b, c, tb=True)),
        ("matmul", lambda cc: gemm.matmul(a, b, cc, tb=True, alpha=-1.0, beta=1.0,
                                          precision="highest", out=cc),
         lambda: gemm.matmul_ref(a, b, c, tb=True, alpha=-1.0, beta=1.0)),
    ):
        row = _check(f"{kern}:trailing_in_place", run(c.clone()), plain())
        emit({"phase": "P1", **row})
        results[kern].append(row)

    # matmul only: op(A) transposed, alpha/beta, and bf16 inputs
    a, b, c = rand(300, 1000), rand(300, 777), rand(1000, 777)
    results["matmul"].append(_compare(
        torch, "matmul:ta_alpha_beta", 1000, 300, 777,
        lambda: gemm.matmul(a, b, c, ta=True, alpha=0.5, beta=-2.0, precision="highest"),
        lambda: gemm.matmul_ref(a, b, c, ta=True, alpha=0.5, beta=-2.0)))
    a, b = rand(r, 1024, dtype=torch.bfloat16), rand(1024, 1024, dtype=torch.bfloat16)
    results["matmul"].append(_compare(
        torch, "matmul:bf16_trailing", r, 1024, 1024,
        lambda: gemm.matmul(a, b, tb=True, out_dtype=torch.float32, precision="default"),
        lambda: gemm.matmul_ref(a, b, tb=True, out_dtype=torch.float32)))
    return results


def _check(name, got, want):
    import torch

    torch.cuda.synchronize()
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    mx = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    require(rel <= KERNEL_BAR, f"{name}: relative error {rel} > {KERNEL_BAR}")
    return {"case": name, "rel_err": rel, "max_abs_err": mx}


def _compare(torch, name, m, k, n, run, plain, **extra):
    row = _check(name, run(), plain())
    ms, plain_ms = in_turns(torch, run, plain)
    row.update(shape=[m, k, n], ms=ms, plain_ms=plain_ms,
               kernel_tflops=2 * m * n * k / ms / 1e9, **extra)
    emit({"phase": "P1", **row})
    return row


# ---------------------------------------------------------------------------
# P2-P5: the main path
# ---------------------------------------------------------------------------

def spd_columns(torch, n, panel, seed):
    """Trapezoid columns of A = X Xᵀ/n + 2I, X ~ N(0,1) from a seeded CUDA
    generator, built per column block on the card (one GEMM each)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, n, generator=gen, device="cuda")
    cols = []
    for c in range(n // panel):
        col = x[c * panel:] @ x[c * panel:(c + 1) * panel].T / n
        col[:panel].diagonal().add_(2.0)
        cols.append(col)
    del x
    return cols


def symmetric_from_lower(lower):
    """The symmetric matrix the factorization sees: its lower triangle."""
    return lower + lower.tril(-1).T


def residual(torch, a, l, block: int = 2048) -> float:
    """||A - L Lᵀ||_F / ||A||_F in fp64 on the card, by column blocks."""
    n = a.shape[0]
    l64 = l.double()
    num = den = 0.0
    for j0 in range(0, n, block):
        j1 = min(n, j0 + block)
        aj = a[:, j0:j1].double()
        rj = aj - l64[:, :j1] @ l64[j0:j1, :j1].T
        num += float((rj * rj).sum())
        den += float((aj * aj).sum())
    del l64
    return (num / den) ** 0.5


def run_entry(torch, drive):
    """Host seconds of `drive()` and device seconds of what it enqueued."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = drive()
    end.record()
    end.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end) / 1e3


def main_path(torch, npw, n: int, n_flat: int, seed: int):
    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.ops import gemm, gemm3

    cfg = npw.default_config()
    launches = {"matmul": 0, "matmul3": 0}

    def reset():
        gemm.LAUNCHES = 0
        gemm3.LAUNCHES = 0

    def counts():
        return {"matmul": gemm.LAUNCHES, "matmul3": gemm3.LAUNCHES}

    # warm-up: the solver and BLAS handles, each configuration once, small
    for comp, prec in ((True, None), (False, "highest"), (False, None)):
        cfg.compensated = comp
        w = torch.randn(2048, 2048, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
        w = w @ w.T / 2048 + 2 * torch.eye(2048, device="cuda")
        npw.cholesky_trapezoid(npw.TrapezoidMatrix.from_array(w, panel=PANEL), precision=prec)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    trap = npw.TrapezoidMatrix(spd_columns(torch, n, PANEL, seed), n, PANEL)
    a = symmetric_from_lower(trap.to_array())
    torch.cuda.synchronize()
    emit({"phase": "operand", "n": n, "panel": PANEL, "seed": seed,
          "seconds": time.perf_counter() - t0})
    flops = n ** 3 / 3

    def report(phase, l_trap, host_s, dev_s, extra):
        resid = residual(torch, a, l_trap.to_array())
        row = {"phase": phase, "n": n, "seconds": dev_s, "host_seconds": host_s,
               "tflops": flops / dev_s / 1e12, "residual": resid, **extra}
        emit(row)
        require(resid <= RESID_BAR, f"{phase}: residual {resid} > {RESID_BAR}")
        return row

    # P2: compensated, through the DSL entry point
    cfg.compensated = True
    reset()

    t0 = time.perf_counter()
    prog, o2, _ = npw.cholesky(trap, storage="trapezoid")
    bind_s = time.perf_counter() - t0  # the DSL bind: host only
    _, host_s, dev_s = run_entry(torch, lambda: npw.run_program(prog))
    c2 = counts()
    require(c2["matmul3"] > 0 and c2["matmul"] == 0, f"P2 launches {c2}")
    launches["matmul3"] += c2["matmul3"]
    p2_row = report("P2", o2.trap, host_s, dev_s,
                    {"config": "compensated", "entry": "cholesky+run_program",
                     "bind_seconds": bind_s, "launches": c2})
    l2 = o2.trap
    del trap, o2, prog

    # P3: precision="highest", the matmul kernel
    cfg.compensated = False
    t = npw.TrapezoidMatrix.from_array(a, panel=PANEL)
    reset()
    l3, host_s, dev_s = run_entry(torch, lambda: npw.cholesky_trapezoid(t, precision="highest"))
    c3 = counts()
    require(c3["matmul"] > 0 and c3["matmul3"] == 0, f"P3 launches {c3}")
    launches["matmul"] += c3["matmul"]
    p3_row = report("P3", l3, host_s, dev_s,
                    {"config": "highest", "entry": "cholesky_trapezoid", "launches": c3})
    del t, l3

    # P4: the plain reference (torch.matmul in true FP32)
    t = npw.TrapezoidMatrix.from_array(a, panel=PANEL)
    reset()
    l4, host_s, dev_s = run_entry(torch, lambda: npw.cholesky_trapezoid(t))
    c4 = counts()
    require(c4 == {"matmul": 0, "matmul3": 0}, f"P4 launches {c4}")
    f4 = l4.to_array()
    diff = float(torch.linalg.norm(l2.to_array() - f4) / torch.linalg.norm(f4))
    p4_row = report("P4", l4, host_s, dev_s,
                    {"config": "default", "entry": "cholesky_trapezoid", "launches": c4,
                     "rel_diff_P2_vs_P4": diff})
    require(diff <= RESID_BAR, f"P4: ||L_P2 - L_P4|| / ||L_P4|| = {diff} > {RESID_BAR}")
    del t, l4, f4, l2, a
    torch.cuda.empty_cache()

    # P5: the flat HBM entry point, compensated
    cfg.compensated = True
    g5 = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(n_flat, n_flat, generator=g5, device="cuda")
    a5 = x @ x.T / n_flat
    a5.diagonal().add_(2.0)
    a5 = symmetric_from_lower(a5.tril())
    del x
    reset()
    t0 = time.perf_counter()
    prog, o5, _ = npw.cholesky(shard_matrix(a5, tile=(512, 512)))
    bind_s = time.perf_counter() - t0
    _, host_s, dev_s = run_entry(torch, lambda: npw.run_program(prog))
    c5 = counts()
    require(c5["matmul3"] > 0, f"P5 launches {c5}")
    launches["matmul3"] += c5["matmul3"]
    l5 = o5.array[:n_flat, :n_flat]
    resid = residual(torch, a5, l5)
    emit({"phase": "P5", "n": n_flat, "seconds": dev_s, "host_seconds": host_s,
          "tflops": n_flat ** 3 / 3 / dev_s / 1e12, "residual": resid,
          "config": "compensated", "entry": "cholesky(shard_matrix)+run_program",
          "bind_seconds": bind_s, "launches": c5})
    require(resid <= RESID_BAR, f"P5: residual {resid} > {RESID_BAR}")
    cfg.compensated = False
    return launches, (p2_row, p3_row, p4_row)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32768, help="trapezoid phases' size")
    ap.add_argument("--n-flat", type=int, default=16384, help="P5's size")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.n % PANEL:
        raise SmokeFailure(f"--n must be a multiple of {PANEL}")

    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this script measures the port on a GPU")
    try:
        import numpywren_tpu_torch as npw
    except ImportError as e:
        raise SmokeFailure(f"the port is not importable beside this script: {e}") from e
    from numpywren_tpu_torch.ops import _build

    # P0: the card and the kernel build
    card = gpu_line()
    t0 = time.perf_counter()
    so = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    log = so.with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
             if "registers" in ln or "spill" in ln]
    emit({"phase": "P0", "device": torch.cuda.get_device_name(0), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": build_s, "built_now": _build.BUILD_SECONDS is not None,
          "library": so.name, "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    p1 = p1_kernels(torch, gen)
    launches, _ = main_path(torch, npw, args.n, args.n_flat, args.seed)

    require("jax" not in sys.modules, "jax was imported")
    kernels = []
    for name, src, replaces in (
        ("matmul", "numpywren_tpu_torch/csrc/gemm.cu", "numpywren_tpu/ops/gemm.py:145"),
        ("matmul3", "numpywren_tpu_torch/csrc/gemm3.cu", "numpywren_tpu/ops/gemm3.py:120"),
    ):
        main_case = p1[name][0]  # the trailing update, 31744x1024 by 1024x1024
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in p1[name]),
                        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"]})
    emit({"kernels": kernels})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
