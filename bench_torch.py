"""Benchmark harness of the PyTorch/CUDA port (numpywren_tpu_torch): the
counterpart of bench.py, with its command line, its JSON lines and its
stdout contract.

    python bench_torch.py [--alg cholesky|gemm|tsqr|bdfac] [--n N] [--tile T]
                          [--dtype float32|bfloat16] [--precision default|high|highest]
                          [--layout trapezoid|flat] [--panel P]
                          [--tsqr-method cholqr2|cholqr3s|tree] [--device cuda|cpu]
    python bench_torch.py --numerics [--device cuda|cpu]
    python -m numpywren_tpu_torch bench ...                 # the same

The flagship is blocked Cholesky on the trapezoid tier: TFLOP/s (n³/3 over
the seconds of one factorization) beside the measured GEMM speed of light of
the route its products take (`route`): the matmul3 kernel (bf16x3, under
NpwConfig.compensated, NPW_COMPENSATED=1), the matmul kernel (bf16x6,
--precision highest) or cuBLAS true FP32 (the default "high"). The metric is
`{alg}_n{n}_{dtype}_{precision}_tflops`, with `compensated` for the
precision when the products run matmul3.

Stdout holds JSON lines only, and the last one is the record. A provisional
line (the last good line of the same alg, marked stale) is flushed before
torch is imported, so a run killed at any moment leaves a parseable line;
each measured stage prints its line as soon as it ends. A failure before
any measurement prints the last good line marked stale with the reason, or
a line of value 0.0, and exits 1. NPW_BENCH_BUDGET_S (default 3300) bounds
the run: when it is spent the run exits 0, having printed the last good
line if it measured nothing. Progress goes to stderr.

The default device is the current CUDA device. A host without one fails;
the CPU is measured only under --device cpu. On the card each timed run
lies between two CUDA events; on the CPU, where the work is synchronous,
the host clock times it. Every timed run gets a fresh operand, made
untimed, and the reported time is the least over the runs. Only a run on a
CUDA device saves its line as the last good one (NPW_BENCH_LASTGOOD,
default BENCH_LASTGOOD_TORCH.json beside this file). Numbers are written
unrounded.

Other environment variables: NPW_BENCH_FAST (the flagship at 32768 alone;
the small --numerics ladder), NPW_BENCH_FORCE_BIG (the blockwise operand at
any size), NPW_BENCH_ESCALATE_S (default 1200: the least budget left for
the flagship's 65536 stage to start).
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import math
import os
import sys
import threading
import time
import traceback

LASTGOOD_PATH = os.environ.get(
    "NPW_BENCH_LASTGOOD",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_LASTGOOD_TORCH.json"))

# Set once a measured (not stale) line is on stdout: from then on a failure
# or the end of the budget exits 0 and prints nothing after it.
_REAL_PRINTED = threading.Event()

# The trapezoid Cholesky builds its operand blockwise from a seed when the
# Gram operand's n_pad x n_pad X would take more than this (bench.py's rule).
BIG_OPERAND_BYTES = 6 << 30
PEAK_CHAIN = 32  # products in one timed chain of measure_matmul_peak


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# The stdout contract
# ---------------------------------------------------------------------------

def save_lastgood(out: dict) -> None:
    try:
        tmp = LASTGOOD_PATH + ".tmp"
        with open(tmp, "w") as f:
            json.dump({**out, "captured_unix": time.time()}, f)
        os.replace(tmp, LASTGOOD_PATH)
    except OSError as e:  # the record is on stdout already; the file is a convenience
        log(f"lastgood save failed: {e}")


def load_lastgood(alg: str):
    """The last good line of the same alg (a line of another alg would
    record a wrong metric), or None."""
    try:
        with open(LASTGOOD_PATH) as f:
            last = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(last, dict) and str(last.get("metric", "")).startswith(f"{alg}_"):
        return last
    return None


def emit_failure(alg: str, error: str) -> None:
    """The failure's line: the last good line marked stale, else value 0.0.
    Nothing once a measured line is out."""
    if _REAL_PRINTED.is_set():
        return
    last = load_lastgood(alg)
    if last is not None:
        print(json.dumps({**last, "stale": True, "stale_reason": error}), flush=True)
        return
    print(json.dumps({"metric": f"{alg}_tflops", "value": 0.0, "unit": "TFLOP/s",
                      "vs_baseline": 0.0, "error": error}), flush=True)


def emit_provisional(alg: str) -> None:
    """The last good line, marked stale and provisional, flushed at once: a
    run killed before it measures anything still leaves a parseable line,
    which a measured line printed later supersedes."""
    last = load_lastgood(alg)
    if last is not None:
        print(json.dumps({**last, "stale": True, "provisional": True}), flush=True)


def _watchdog(alg: str, budget: float, deadline: float, done: threading.Event) -> None:
    """Ends the process at the deadline unless the run is done by then:
    exit 0, after the failure line if nothing was measured."""
    if done.wait(max(0.0, deadline - time.monotonic())):
        return
    if not _REAL_PRINTED.is_set():
        emit_failure(alg, f"global bench budget ({budget:.0f}s) exhausted before a real "
                          "measurement")
    log(f"budget {budget:.0f}s exhausted; exiting (real measurement printed: "
        f"{_REAL_PRINTED.is_set()})")
    os._exit(0)


# ---------------------------------------------------------------------------
# Timing and the speed of light
# ---------------------------------------------------------------------------

def timed(device, run) -> float:
    """Seconds of run(): between two CUDA events on the card, read once the
    end event has completed, with the device idle when the first is
    recorded; by the host clock on the CPU, where the work is synchronous."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        run()
        seconds = time.perf_counter() - t0
    if not seconds > 0:
        raise RuntimeError(f"a timed run measured {seconds} s")
    return seconds


def best_time(device, make, run, runs: int) -> float:
    """The least seconds of run(make(i)) over i < runs: every run on a fresh
    operand, made untimed."""
    best = math.inf
    for i in range(runs):
        x = make(i)
        best = min(best, timed(device, lambda: run(x)))
        del x
    return best


def route(dtype, precision: str) -> str:
    """The GEMM that the factorizations' products take at this dtype and
    precision (compiler/lower.py's _matmul): the matmul3 kernel, the matmul
    kernel, or torch.matmul."""
    import torch

    from numpywren_tpu_torch.compiler.lower import _use_compensated

    if precision != "high":
        return "matmul"
    if _use_compensated(torch.empty(0, dtype=dtype), precision):
        return "matmul3"
    return "torch_fp32" if dtype == torch.float32 else "torch_bf16"


def measure_matmul_peak(dtype, precision: str, device, n: int = None) -> float:
    """The measured GEMM speed of light (TFLOP/s) of `route(dtype,
    precision)`: chains of n x n products through compiler/lower.py's
    _matmul (n = 8192 on the card, 512 on the CPU), the best of three."""
    import torch

    from numpywren_tpu_torch.compiler.lower import _matmul

    n = n or (8192 if device.type == "cuda" else 512)
    gen = torch.Generator(device=device).manual_seed(0)
    # entries of variance 1/n: every product in a chain stays of order 1/sqrt(n)
    x = (torch.randn(n, n, generator=gen, device=device) / math.sqrt(n)).to(dtype)

    def chain(k):
        y = x
        for _ in range(k):
            y = _matmul(y, x, precision=precision)

    chain(2)
    per = min(timed(device, lambda: chain(PEAK_CHAIN)) for _ in range(3)) / PEAK_CHAIN
    return 2 * n ** 3 / per / 1e12


def _launches() -> dict:
    """The GEMM kernels' launch counts so far in this process (a call on a
    CPU tensor runs the plain version and counts nothing)."""
    return {name: importlib.import_module(f"numpywren_tpu_torch.ops.{mod}").LAUNCHES
            for name, mod in (("matmul", "gemm"), ("matmul3", "gemm3"))}


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------

def gram_columns(n: int, n_pad: int, panel: int, dtype, device):
    """make(seed): the trapezoid column blocks of A = X Xᵀ/n + 2I, X an
    n_pad x n_pad N(0, 1) from a generator seeded by `seed`. Column block c
    holds rows [c·panel, n_pad) of columns [c·panel, (c + 1)·panel), one
    product each, so A's diagonal is every block's local diagonal; the
    diagonal block is made exactly symmetric."""
    import torch

    def make(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn(n_pad, n_pad, generator=gen, device=device)
        cols = []
        for c in range(n_pad // panel):
            col = x[c * panel:] @ x[c * panel:(c + 1) * panel].T / n
            d = col[:panel]
            d.copy_(d.tril() + d.tril(-1).T)
            d.diagonal().add_(2.0)
            cols.append(col.to(dtype))
        return cols

    return make


def blockwise_columns(n_pad: int, panel: int, dtype, device):
    """(make, column): the trapezoid column blocks of A whose panel-sized
    blocks are A[i, j] = s (R(i, j) + R(j, i)ᵀ) + 2I[i == j], s =
    0.5/sqrt(n_pad), R(i, j) an N(0, 1) block from a generator seeded by
    seed·nb² + i·nb + j. A is symmetric by construction and positive
    definite: the symmetric random part's spectral radius, about
    2·sqrt(n_pad·2s²) = sqrt(2), stays below the shift of 2. No n_pad x n_pad
    tensor exists: make(seed) builds every column block, column(seed, c)
    rebuilds block c alone."""
    import torch

    nb = n_pad // panel
    s = 0.5 / math.sqrt(n_pad)
    gen = torch.Generator(device=device)

    def block(seed, i, j):
        gen.manual_seed(seed * nb * nb + i * nb + j)
        return torch.randn(panel, panel, generator=gen, device=device)

    def column(seed: int, c: int):
        out = torch.empty((n_pad - c * panel, panel), dtype=dtype, device=device)
        for i in range(c, nb):
            blk = block(seed, i, c).add_(block(seed, c, i).T).mul_(s)
            if i == c:
                blk.diagonal().add_(2.0)
            out[(i - c) * panel:(i - c + 1) * panel] = blk
        return out

    def make(seed: int):
        return [column(seed, c) for c in range(nb)]

    return make, column


def trapezoid_residual(l_cols, a_column, panel: int) -> float:
    """‖A − L Lᵀ‖_F / ‖A‖_F over the whole symmetric matrix, in fp64 on the
    factor's device, one column block at a time. Column block c of L Lᵀ
    (rows from c·panel down) is the sum over q ≤ c of L's column block q
    below row c·panel times its block row c, transposed: one product per
    (c, q). a_column(c) gives A's column block c as the factorization saw
    it; the blocks below the diagonal count twice, for their mirrors."""
    import torch

    num = torch.zeros((), dtype=torch.float64, device=l_cols[0].device)
    den = torch.zeros_like(num)
    for c in range(len(l_cols)):
        a = a_column(c).double()
        r = a.clone()
        for q in range(c + 1):
            lq = l_cols[q][(c - q) * panel:].double()
            r.addmm_(lq, lq[:panel].T, alpha=-1.0)
        r2, a2 = r.square(), a.square()
        num += 2 * r2.sum() - r2[:panel].sum()
        den += 2 * a2.sum() - a2[:panel].sum()
    return float((num / den).sqrt())


def bench_cholesky_trapezoid(n, tile, dtype, precision, syrk_depth, device, panel=None):
    """The flagship: trapezoid._trapezoid_chol_fn on fresh column buffers,
    factored in place."""
    from numpywren_tpu_torch.trapezoid import _trapezoid_chol_fn

    panel = panel or 8 * tile  # 8 tiles: bench.py's default, measured on the TPU
    nb = -(-n // panel)
    n_pad = nb * panel
    log(f"cholesky[trapezoid]: n={n} tile={tile} panel={panel} dtype={dtype} "
        f"precision={precision}")
    big = (n_pad * n_pad * 4 > BIG_OPERAND_BYTES
           or bool(os.environ.get("NPW_BENCH_FORCE_BIG")))
    if big:
        make_cols, column = blockwise_columns(n_pad, panel, dtype, device)
    else:
        make_cols = gram_columns(n, n_pad, panel, dtype, device)
    fn = _trapezoid_chol_fn(panel, tile, precision)
    fn(make_cols(99))  # warm-up
    # bench.py's repetitions: two single runs on the blockwise operand, else
    # two of its slope legs' k1 + k2 runs
    runs = 2 if big else 2 * (3 if n > 16384 else 12)
    per = best_time(device, lambda i: make_cols(i + 1), fn, runs)
    tflops = n ** 3 / 3 / per / 1e12

    l_cols = make_cols(0)
    # A's column blocks for the residual: rebuilt from the seed where A is
    # blockwise, else kept
    a_column = functools.partial(column, 0) if big else [c.clone() for c in l_cols].__getitem__
    fn(l_cols)
    resid = trapezoid_residual(l_cols, a_column, panel)
    log(f"per-factorization: {per * 1e3:.1f} ms  residual: {resid:.3e}")
    return tflops, per, {"layout": "trapezoid", "residual_fro": resid, "residual_full": True}


def flat_residual(a, l, rows: int = 8192) -> float:
    """‖A − L Lᵀ‖_F / ‖A‖_F in fp64 on the device, by row blocks (L lower)."""
    import torch

    n = a.shape[0]
    l64 = l.double()
    num = torch.zeros((), dtype=torch.float64, device=a.device)
    den = torch.zeros_like(num)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        ab = a[r0:r1].double()
        rb = ab - l64[r0:r1, :r1] @ l64[:, :r1].T
        num += rb.square().sum()
        den += ab.square().sum()
    return float((num / den).sqrt())


def bench_cholesky(n, tile, dtype, precision, syrk_depth, device):
    """The flat layout: compiler/lower.py's fused_cholesky_fn on a fresh copy
    of A = X Xᵀ/n + 2I each run."""
    import torch

    from numpywren_tpu_torch.compiler.lower import fused_cholesky_fn

    log(f"cholesky: n={n} tile={tile} dtype={dtype} precision={precision}")
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(n, n, generator=gen, device=device)
    a = (x @ x.T / n).tril()
    del x
    a = a + a.tril(-1).T
    a.diagonal().add_(2.0)
    a = a.to(dtype)
    body = fused_cholesky_fn(n, tile, syrk_depth=syrk_depth, precision=precision,
                             dtype=a.dtype)
    body(a.clone())  # warm-up
    runs = 8 if n <= 16384 else 4  # bench.py's slope legs, k1 + k2
    per = best_time(device, lambda i: a.clone(), body, runs)
    tflops = n ** 3 / 3 / per / 1e12
    resid = flat_residual(a, body(a.clone()))
    log(f"per-factorization: {per * 1e3:.1f} ms  residual: {resid:.3e}")
    return tflops, per, {"residual_fro": resid}


# ---------------------------------------------------------------------------
# GEMM, TSQR, BDFAC
# ---------------------------------------------------------------------------

def bench_gemm(n, tile, dtype, precision, syrk_depth, device):
    """One n x n product through compiler/lower.py's _matmul, the route the
    fused lowering takes."""
    import torch

    from numpywren_tpu_torch.compiler.lower import _matmul

    log(f"gemm: n={n} tile={tile} dtype={dtype} precision={precision}")
    gen = torch.Generator(device=device).manual_seed(1)
    a = (torch.randn(n, n, generator=gen, device=device) * 0.01).to(dtype)
    _matmul(a, a, precision=precision)  # warm-up
    per = best_time(device, lambda i: a.clone(), lambda x: _matmul(x, a, precision=precision),
                    12)  # bench.py's slope legs, 3 + 9
    return 2 * n ** 3 / per / 1e12, per, {}


def bench_tsqr(n, tile, dtype, precision, syrk_depth, device, method="cholqr2"):
    """R of an n x 512 operand (n rounded down to whole leaves of `tile`
    rows): cholqr2 (two Gram passes), cholqr3s (the adaptive shifted chain)
    or tree (Householder leaves and combine tree)."""
    import torch

    from numpywren_tpu_torch.compiler.lower import (
        fused_cholqr2_fn,
        fused_cholqr3s_fn,
        fused_tsqr_fn,
    )

    b = 512
    n_leaves = max(1, n // tile)
    rows = n_leaves * tile
    log(f"tsqr[{method}]: {rows}x{b}, {n_leaves} leaves of {tile} rows")
    gen = torch.Generator(device=device).manual_seed(1)
    a = (torch.randn(rows, b, generator=gen, device=device) * 0.1).to(dtype)
    if method == "cholqr2":
        body = fused_cholqr2_fn(precision=precision, dtype=a.dtype)
    elif method == "cholqr3s":
        body = fused_cholqr3s_fn(precision=precision, dtype=a.dtype)
    else:
        body = fused_tsqr_fn(n_leaves, tile, b, precision=precision, dtype=a.dtype)
    body(a.clone())  # warm-up
    per = best_time(device, lambda i: a.clone(), body, 8)  # bench.py's slope legs, 2 + 6
    # useful work 2mb² a pass: cholqr2 and cholqr3s (whose chain takes two
    # passes on this well-conditioned operand) count two, the tree one
    flops = {"cholqr2": 4, "cholqr3s": 4}.get(method, 2) * rows * b * b
    # Gram parity ‖RᵀR − AᵀA‖_F / ‖AᵀA‖_F, in fp64
    a64, r64 = a.double(), body(a.clone()).double()
    g = a64.T @ a64
    err = float(torch.linalg.norm(r64.T @ r64 - g) / torch.linalg.norm(g))
    log(f"gram relative error: {err:.3e}")
    return flops / per / 1e12, per, {"rows": rows, "cols": b, "method": method,
                                     "gram_rel_err": err}


def bench_bdfac(n, tile, dtype, precision, syrk_depth, device):
    """compiler/lower.py's fused_bdfac_fn on a fresh copy each run, worked in
    place; 8n³/3 flops (the two-sided blocked Householder sweeps)."""
    import torch

    from numpywren_tpu_torch.compiler.lower import fused_bdfac_fn

    log(f"bdfac: n={n} tile={tile} dtype={dtype} precision={precision}")
    gen = torch.Generator(device=device).manual_seed(1)
    a = (torch.randn(n, n, generator=gen, device=device) * 0.1).to(dtype)
    body = fused_bdfac_fn(n, tile, precision=precision, dtype=a.dtype)
    body(a.clone())  # warm-up
    per = best_time(device, lambda i: a.clone(), body, 4)  # bench.py's slope legs, 1 + 3
    return 8 * n ** 3 / 3 / per / 1e12, per, {}


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def bench_numerics(device_name: str) -> int:
    """The κ ladder through the adaptive shifted CholeskyQR chain (fused_tsqr,
    method "cholqr3s", with Q) and the BDFAC panels (models.singular_values)
    at tiles 256 and 512, on numpy operands from default_rng(0); one JSON
    line of each rung's errors. Returns 0 when every rung passes."""
    import numpy as np
    import torch

    from numpywren_tpu_torch import models
    from numpywren_tpu_torch.compiler.lower import fused_tsqr

    device = _device(device_name)
    rng = np.random.default_rng(0)

    def logspace_mat(m, b, kappa):
        u, _ = np.linalg.qr(rng.standard_normal((m, b)))
        v, _ = np.linalg.qr(rng.standard_normal((b, b)))
        sv = np.logspace(0, -np.log10(kappa), b)
        return (u * sv) @ v.T

    rungs = {}
    fast = bool(os.environ.get("NPW_BENCH_FAST"))
    m, b = (8192, 128) if fast else (65536, 256)
    ladder = [1e2, 1e4, 1e6, 1e8] if fast else [1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8]
    for kappa in ladder:
        a = logspace_mat(m, b, kappa).astype(np.float32)
        q, r = fused_tsqr(torch.from_numpy(a).to(device), tile_rows=m, compute_q=True,
                          method="cholqr3s")
        q, r = q.cpu().numpy(), r.cpu().numpy()
        ortho = float(np.max(np.abs(q.T @ q - np.eye(b))))
        resid = float(np.linalg.norm(q @ r - a) / np.linalg.norm(a))
        # bench.py's bars: resid 2e-4 sits above the healthy rungs' fp32
        # apply floor; a broken chain lands decades higher
        passed = bool(np.isfinite(ortho) and ortho < 1e-3 and resid < 2e-4)
        rungs[f"cholqr3s_kappa_{kappa:.0e}"] = {"ortho_max": ortho, "resid": resid,
                                                "pass": passed}
        log(f"cholqr3s kappa={kappa:.0e}: ortho {ortho:.2e} resid {resid:.2e} "
            f"{'PASS' if passed else 'FAIL'}")
    for tile in ([256] if fast else [256, 512]):
        n = 1024 if fast else 2048
        x = rng.standard_normal((n, n)).astype(np.float32)
        s = models.singular_values(x, tile=tile, device=device)
        s_ref = np.linalg.svd(x.astype(np.float64), compute_uv=False)
        err = float(np.max(np.abs(s - s_ref)) / s_ref[0])
        passed = bool(np.isfinite(err) and err < 1e-4)
        rungs[f"bdfac_sv_tile{tile}"] = {"sv_maxerr": err, "pass": passed}
        log(f"bdfac tile={tile}: sv err {err:.2e} {'PASS' if passed else 'FAIL'}")
    ok = sum(v["pass"] for v in rungs.values())
    worst = max(v.get("ortho_max", v.get("sv_maxerr")) for v in rungs.values())
    print(json.dumps({
        "metric": "numerics_gate_maxerr", "value": worst, "unit": "maxerr",
        "vs_baseline": ok / len(rungs),  # the share of rungs that pass
        "rungs": rungs, "device": _device_label(device),
    }), flush=True)
    return 0 if ok == len(rungs) else 1


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def _device(name: str):
    """torch.device(name); "cuda" on a host without a CUDA device raises."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain PyTorch "
                           "versions on the CPU")
    return torch.device(name)


def _device_label(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def defaults(cuda: bool) -> dict:
    """(n, tile) by alg. The tiles (Cholesky 128, so panels of 1024; BDFAC
    512) are bench.py's, measured on the TPU, not tuned on the card."""
    fast = bool(os.environ.get("NPW_BENCH_FAST"))
    return {
        "cholesky": ((32768 if fast else 65536) if cuda else 512, 128),
        "gemm": (8192 if cuda else 1024, 512),
        "tsqr": (1 << 20 if cuda else 1 << 14, 4096 if cuda else 1024),
        "bdfac": (8192 if cuda else 256, 512 if cuda else 64),
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--alg", default="cholesky", choices=["cholesky", "gemm", "tsqr", "bdfac"])
    p.add_argument("--numerics", action="store_true",
                   help="run the numerics gate (kappa ladder + bdfac composition) instead "
                        "of a perf benchmark")
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--tile", type=int, default=None)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--precision", default="high",
                   help="one of numpywren_tpu_torch.ops.common.PRECISIONS: default (bf16), "
                        "high (true FP32, or matmul3 under NPW_COMPENSATED=1), highest "
                        "(the matmul kernel, bf16x6)")
    p.add_argument("--syrk-depth", type=int, default=3, help="recursive triangular-syrk depth")
    p.add_argument("--layout", default="trapezoid", choices=["trapezoid", "flat"],
                   help="cholesky storage layout (trapezoid: column blocks factored in place)")
    p.add_argument("--panel", type=int, default=None,
                   help="trapezoid column-block width (default 8*tile)")
    p.add_argument("--tsqr-method", default="cholqr2", choices=["cholqr2", "cholqr3s", "tree"])
    p.add_argument("--target-frac", type=float, default=0.70,
                   help="the north star's fraction of the GEMM speed of light (vs_baseline)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="measure on the current CUDA device (default) or the CPU")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.numerics:
        return bench_numerics(args.device)
    _REAL_PRINTED.clear()
    emit_provisional(args.alg)  # before torch is imported or the device initialises
    budget = float(os.environ.get("NPW_BENCH_BUDGET_S", "3300"))
    deadline = time.monotonic() + budget
    done = threading.Event()
    threading.Thread(target=_watchdog, args=(args.alg, budget, deadline, done),
                     daemon=True).start()
    try:
        _perf_main(args, deadline)
    except Exception as e:  # noqa: BLE001 - the run's boundary: a failure becomes its line
        log(traceback.format_exc())
        if _REAL_PRINTED.is_set():
            return 0
        emit_failure(args.alg, f"{type(e).__name__}: {e}")
        return 1
    finally:
        done.set()
    return 0


def _perf_main(args, deadline: float) -> None:
    from numpywren_tpu_torch.ops.common import check_precision, torch_dtype

    device = _device(args.device)
    label = _device_label(device)
    log(f"device: {label}")
    cuda = device.type == "cuda"
    precision = check_precision(args.precision)
    dtype = torch_dtype(args.dtype)
    n_default, tile_default = defaults(cuda)[args.alg]
    n = args.n or n_default
    tile = args.tile or tile_default
    products = route(dtype, precision)
    token = "compensated" if products == "matmul3" else args.precision

    peak = measure_matmul_peak(dtype, precision, device)
    log(f"measured matmul speed-of-light ({products}): {peak:.1f} TFLOP/s")

    if args.alg == "cholesky" and args.layout == "trapezoid":
        def fn(*a):
            return bench_cholesky_trapezoid(*a, panel=args.panel)
    elif args.alg == "tsqr":
        def fn(*a):
            return bench_tsqr(*a, method=args.tsqr_method)
    else:
        fn = {"cholesky": bench_cholesky, "gemm": bench_gemm, "bdfac": bench_bdfac}[args.alg]

    def run_stage(n_stage, note=None):
        """One measurement, its line printed at once: a later stage's failure
        leaves it on stdout."""
        before = _launches()
        tflops, per, extra = fn(n_stage, tile, dtype, precision, args.syrk_depth, device)
        after = _launches()
        frac_peak = tflops / peak
        out = {
            "metric": f"{args.alg}_n{n_stage}_{args.dtype}_{token}_tflops",
            "value": tflops,
            "unit": "TFLOP/s",
            "vs_baseline": frac_peak / args.target_frac,
            "frac_of_matmul_peak": frac_peak,
            "matmul_peak_tflops": peak,
            "seconds_per_run": per,
            "device": label,
            "route": products,
            "launches": {k: after[k] - before[k] for k in after},
            **extra,
            **({"stage_note": note} if note else {}),
        }
        print(json.dumps(out), flush=True)
        _REAL_PRINTED.set()
        if cuda:  # only the card's numbers are worth replaying
            save_lastgood(out)

    # The flagship measures the quick 32768 stage first, so a record is on
    # stdout early; the 65536 stage follows while the budget has room.
    stages = [n]
    if (cuda and args.n is None and args.alg == "cholesky"
            and not os.environ.get("NPW_BENCH_FAST") and n > 32768):
        stages = [32768, n]
    escalate_min = float(os.environ.get("NPW_BENCH_ESCALATE_S", "1200"))
    for i, n_stage in enumerate(stages):
        left = deadline - time.monotonic()
        if i > 0 and left < escalate_min:
            log(f"skipping n={n_stage}: {left:.0f}s left < {escalate_min:.0f}s")
            break
        try:
            run_stage(n_stage, note="quick" if len(stages) > 1 and i == 0 else None)
        except Exception as e:  # noqa: BLE001 - a failed stage: a smaller one on the same route
            if _REAL_PRINTED.is_set():
                log(f"stage n={n_stage} failed ({type(e).__name__}: {e}); keeping the "
                    "earlier stage's record")
                break
            fallback = {"cholesky": 16384 if n_stage <= 32768 else 32768, "gemm": 4096,
                        "tsqr": 1 << 19, "bdfac": 4096}[args.alg]
            if not (cuda and args.n is None and fallback < n_stage):
                raise
            log(f"stage n={n_stage} failed ({type(e).__name__}: {e}); falling back to "
                f"n={fallback}")
            run_stage(fallback, note="fallback_from_stage_failure")
            break


if __name__ == "__main__":
    sys.exit(main())
