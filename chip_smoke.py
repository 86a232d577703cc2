#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from numpywren_tpu_torch/csrc, checks each
against its plain PyTorch version at its path's shapes, then drives the
user entry points (operands made on the card from seeded generators):
blocked Cholesky at N=32768 (P2-P5), the factor ops (P6), TSQR at
BASELINE config 3's 1,048,576 x 512 and beside it (P8-P11), GEMM at 8192
(P12), the QR kernel and ops.qr_leaf (P13-P14), the generic DSL
executors on both storage tiers (P15-P16), and the out-of-core Cholesky
(P17):

  P0  the card, its power limit, the kernel build
  P1  each kernel vs its plain version: relative Frobenius error <= 1e-5
      (same fp32, bf16x3 or bf16x6 arithmetic, summation order only) and the
      mean time of >= 10 warm launches, kernel and plain in turns (CUDA
      events); the GEMM kernels (csrc/gemm_split.cu: matmul at three bf16
      planes, matmul3 at two) also vs _matmul_split_ref (their own
      arithmetic; matmul <= 1e-5, matmul3 <= 1e-6), their device launches
      (pack A, pack B, mainloop: 3 a call), their pack and mainloop device
      time at the trailing update (torch.profiler) with the ring's stages
      and shared bytes; matmul3's panel route (gemm3.Panel: one pack, then
      the mainloop alone at offsets 0 and 1024 of a 31744 x 1024 panel)
      bit for bit against the per-call route, both timed; and the error
      against fp64 of matmul, addmm (true FP32) and matmul3 at K = 1024 and
      8192: matmul's within 2x of addmm's, matmul3's <= 1e-5
  P2  cholesky(TrapezoidMatrix, storage="trapezoid") + run_program with
      NpwConfig.compensated: every GEMM through the matmul3 kernel, each
      panel packed once; its calls and device launches as the panel route
      implies (panel_route_counts); then one compensated factorization
      under torch.profiler: device ms by kernel group and the idle share
  P3  cholesky_trapezoid(t, precision="highest"): the matmul kernel, its
      device launches 3 a call
  P4  the default configuration (torch.matmul, true FP32), the plain
      reference, and ||L_P2 - L_P4|| / ||L_P4|| <= 1e-4
  P5  the flat entry point cholesky(shard_matrix(A)) + run_program at
      N=16384, compensated, matmul3's counts as in P2
  P6  potrf's diagonal step alone at 128² vs its plain version
      (_factor_block_rec_ref, rel <= 1e-5); potrf, potrf_inv, trtri, trsm
      kernels vs their plain versions at n = 128..1024, trtri and potrf_inv
      also at 384 and 640 (rel Frobenius <= 1e-5, ||L W - I||_max <= 1e-4,
      strict upper exactly 0), ms of kernel, plain and torch.linalg in
      turns, and for potrf, potrf_inv and trtri the device launches of one
      call (counted by csrc/potrf.cu and csrc/trtri.cu, checked against
      pallas_factor.device_launches) and their device time by kernel and
      by launch (torch.profiler; a session that loses records is retaken);
      potrf at kappa = 1e5 (||A - L Lᵀ||_F/||A||_F <= 1e-5, fp64) and trtri
      of its factor (||L W - I||_max <= 10 x solve_triangular's); an
      off-envelope n=1000 call launches nothing; then the ops entry points
      potrf_pallas + trsm_pallas on the first Cholesky panel (1024
      diagonal block, 31744 x 1024 below it)
  P7  the CholeskyQR2 chain (csrc/cholqr_chain.cu's launch sequence, the
      apply on gemm_split.cu at three bf16 planes) at 1,048,576 x 256
      (columns) and 256 x 1,048,576 (rows), kappa 10, vs its plain versions:
      cholqr2_chain_ref (fp32) and _cholqr2_chain_steps_ref (its own
      arithmetic): max|q - q_plain| <= 3e-5 against each, q rel <= 1e-5
      against the steps, total rel <= 1e-5, the same conv flag, dev2 rel
      <= 1e-4; its device launches (pallas_factor.device_launches); both
      folds (shift_c = 1: the identity, dev2 >= 0.1, conv False; a
      hundredth of the shift: the Neumann cleanup, dev2 < 0.1) finite and
      within 1e-5 of its steps; a failed factor (g's last diagonal entry
      negated: dev2 NaN, conv False, the identity fold, R's NaN in its
      failed row or column alone); ms of the kernel, the plain version and
      passes 1-2 by the library and by the chain, in turns; device ms of
      step 0, the packs and the mainloop (torch.profiler, required, in a
      new process of its own), beside the profiled call's ms by CUDA
      events and the profiler's span; the bound at three planes beside the
      FFMA bound
  P8  tsqr(X 1,048,576 x 512, tile_rows=4096, "cholqr3s", compute_q) +
      run_program with NPW_PALLAS_FACTOR=1 (potrf_inv kernel), then the
      library route (both flags off)
  P9  the same at 1,048,576 x 256 with NPW_PALLAS_CHAIN=1 (chain kernel)
  P10 kappa = 1e6 at 65,536 x 256 with both flags on (chain and potrf_inv)
  P11 methods "cholqr2" and "tree" at 65,536 x 256 (library only)
  P12 gemm(A, B) + run_program at 8192^2 fp32, tile 512: the default route
      (torch.matmul) and the compensated one (matmul3), vs an fp64 product
      on the card, rel <= 1e-5
  P13 the qr kernel vs its plain versions, qr_ref and the row-split
      _qr_rowsplit_ref (the kernel's sum order), at 128², 256 x 128, 512²,
      1024 x 256, 2048 x 128 (rel Frobenius of Q and R <= 1e-5 against
      each, ||QᵀQ - I||_max <= 2e-5, R exactly upper), a zero column (the
      same, finite) and kappa = 1e7 at 512 x 128 (ortho <= 5e-5,
      reconstruction <= 1e-5 max|A|); the launch's CTAs and shared bytes
      per CTA; ms of kernel and torch.linalg.qr in turns at every case, of
      the plain version too at 512² and 2048 x 128; an off-envelope
      100 x 60 call launches nothing
  P14 ops.qr_leaf on the 128 leaves (2048 x 128) of a 262,144 x 128
      operand with NPW_PALLAS_QR=1 (one kernel launch each), and with it
      off (the library); R agreement as P8's
  P15 TorchTaskExecutor (executor="jax") at the JAX package's own
      generic-executor configurations: DSL cholesky 16384/1024 (trsm_inv
      on and off), gemm 8192²/1024 (rel <= 1e-5 vs fp64), tsqr_q
      65,536 x 256/4096 (bars as P8, R against the cholqr3s route), bdfac
      8192/1024 (off-bidiagonal blocks <= 1e-4 ||X||_F, singular values
      within 1e-4 sigma_max of fp64 svdvals(X)); device seconds and groups
  P16 SpillTaskExecutor (executor="spill") on a host-tier cholesky
      16384/1024 (device seconds, host<->device bytes), and LocalExecutor
      (executor="local") at 2048/256 with fault_rate = duplicate_rate = 0.1
  P17 the out-of-core Cholesky (runtime/spill.py), compensated, tile 512,
      W = 2048, cache_bytes 0: matmul3 and matmul at its tallest update
      (65536 x 2048 by 2048ᵀ, in place) vs their plain versions and addmm;
      one pinned 512 MiB copy each way (the link's yardstick); put_block's
      host cost; then N=65536 (8 GiB of lower tiles on the host tier)
      through cholesky + run_program with NpwConfig.hbm_budget_bytes
      lowered into the spill branch, and N=32768 called directly at
      pipeline_width 1 and 2 by shape_mode exact and pow2 in turns, and at
      "highest": device and host seconds, TFLOP/s, residual, L on the host
      tier, spill_stats, H2D/D2H bytes (SpillTraffic, from the events and
      shapes) and GB/s, one matmul3 (or matmul) call per update, device
      memory growth within spill_memory_bound; a checkpoint run stopped
      after two panels and continued equals the uninterrupted factor bit
      for bit

Residuals ||A - L Lᵀ||_F / ||A||_F are computed on the card in fp64 and
must be <= 1e-4. TSQR phases hold ||QᵀQ - I||_F/sqrt(b) <= 1e-4,
||QR - X||_F/||X||_F <= 1e-5 (fp64 on the card) and the kernel route's R
within 3e-5 (rel Frobenius, signs fixed by diag(R)) of the library's.
Each phase prints JSON lines; then the kernels' line, the card's name and
power limit, and last {"ok": true, "device": ...}. Any failure exits
non-zero without that last line; so does a host without a CUDA device, or
a directory without the port beside this script.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

PANEL = 1024
RESID_BAR = 1e-4
KERNEL_BAR = 1e-5
SPLIT_BAR = 1e-6   # matmul3 against _matmul_split_ref(planes=2), its own arithmetic
MATMUL3_FP64_BAR = 1e-5  # matmul3's error against fp64 (bf16x3: ~4.4e-6)
FP64_RATIO_BAR = 2.0  # matmul's error against fp64 over addmm's (true FP32)
INV_BAR = 1e-4     # ||L W - I||_max of a factor kernel
CHAIN_Q_BAR = 3e-5  # max |q - q_plain| of the chain (tests/test_pallas_factor.py:180)
DEV2_BAR = 1e-4    # dev2 of kernel and plain: two summation orders of one product
ORTHO_BAR = 1e-4
QR_RESID_BAR = 1e-5
R_AGREE_BAR = 3e-5
FLAGS = ("NPW_PALLAS_FACTOR", "NPW_PALLAS_CHAIN")

# H100 SXM5 published peaks (NVIDIA H100 datasheet)
PEAK_FP32 = 67e12     # FP32 FFMA, FLOP/s
PEAK_BF16 = 989e12    # dense bf16 tensor cores, FLOP/s
PEAK_HBM = 3.35e12    # bytes/s


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


def gemm_module():
    """numpywren_tpu_torch.ops.gemm, the module (the package exports its
    function `gemm` under the same name)."""
    return importlib.import_module("numpywren_tpu_torch.ops.gemm")


def cuda_ms(torch, fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, *fns, iters: int = 10):
    """Mean ms of `iters` warm calls of each fn, timed in turns: forward,
    then backward (kernel, plain, ..., plain, kernel)."""
    for fn in fns:
        fn()
        fn()
    torch.cuda.synchronize()
    fwd = [cuda_ms(torch, fn, iters) for fn in fns]
    bwd = [cuda_ms(torch, fn, iters) for fn in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(fwd, bwd)]


def bound(flops: float, nbytes: float, peak: float):
    """(ms, "operations" | "bytes"): the least time the card could take."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_HBM * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rel_err(torch, got, want) -> float:
    return float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))


def set_flags(on=()) -> None:
    for name in FLAGS:
        os.environ[name] = "1" if name in on else "0"


# ---------------------------------------------------------------------------
# P1: each kernel against its plain version
# ---------------------------------------------------------------------------

def p1_kernels(torch, gen):
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    r = 31744  # rows below the first panel at N=32768, panel 1024
    launches0 = (gemm.LAUNCHES, gemm.DEVICE_LAUNCHES)
    launches3 = (gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES)
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
        flops, nbytes = 2 * m * n * k, 4 * (m * k + n * k + (2 if with_c else 1) * m * n)
        for kern in ("matmul3", "matmul"):
            if kern == "matmul3":
                run = lambda: gemm3.matmul3(a, b, c, tb=True)  # noqa: E731
                plain = lambda: gemm3.matmul3_ref(a, b, c, tb=True)  # noqa: E731
            else:
                kw = dict(tb=True, alpha=-1.0, beta=1.0) if with_c else dict(tb=True)
                run = lambda: gemm.matmul(a, b, c, precision="highest", **kw)  # noqa: E731
                plain = lambda: gemm.matmul_ref(a, b, c, **kw)  # noqa: E731
            if kern == "matmul3":
                b_ms, b_by = bound(3 * flops, nbytes, PEAK_BF16)
                kw = dict(tb=True, alpha=-1.0, beta=1.0) if with_c else dict(tb=True)
                extra = dict(split_ref=lambda: gemm._matmul_split_ref(a, b, c, planes=2, **kw),
                             split_bar=SPLIT_BAR)
            else:  # six bf16 products; the FFMA bound of the same fp32 product beside it
                b_ms, b_by = bound(6 * flops, nbytes, PEAK_BF16)
                extra = dict(ffma_bound_ms=bound(flops, nbytes, PEAK_FP32)[0],
                             split_ref=lambda: gemm._matmul_split_ref(a, b, c, **kw))
            results[kern].append(_compare(torch, f"{kern}:{name}", m, k, n, run, plain,
                                          torch_ms=torch_ms, bound_ms=b_ms, bound_by=b_by,
                                          **extra))

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
        planes, bar = (2, SPLIT_BAR) if kern == "matmul3" else (3, KERNEL_BAR)
        row["rel_err_split_ref"] = _check(
            f"{kern}:trailing_in_place vs split", run(c.clone()),
            gemm._matmul_split_ref(a, b, c, tb=True, alpha=-1.0, beta=1.0, planes=planes),
            bar)["rel_err"]
        emit({"phase": "P1", **row})
        results[kern].append(row)
    calls = gemm3.LAUNCHES - launches3[0]
    device = gemm3.DEVICE_LAUNCHES - launches3[1]
    require(device == 3 * calls, f"P1 matmul3: {device} device launches for {calls} calls, not 3 each")

    # matmul only: op(A) transposed, alpha/beta, and bf16 inputs (one plane)
    a, b, c = rand(300, 1000), rand(300, 777), rand(1000, 777)
    kw = dict(ta=True, alpha=0.5, beta=-2.0)
    results["matmul"].append(_compare(
        torch, "matmul:ta_alpha_beta", 1000, 300, 777,
        lambda: gemm.matmul(a, b, c, precision="highest", **kw),
        lambda: gemm.matmul_ref(a, b, c, **kw),
        split_ref=lambda: gemm._matmul_split_ref(a, b, c, **kw)))
    a, b = rand(r, 1024, dtype=torch.bfloat16), rand(1024, 1024, dtype=torch.bfloat16)
    kw = dict(tb=True, out_dtype=torch.float32)
    flops, nbytes = 2 * r * 1024 * 1024, 2 * (r * 1024 + 1024 * 1024) + 4 * r * 1024
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
    results["matmul"].append(_compare(
        torch, "matmul:bf16_trailing", r, 1024, 1024,
        lambda: gemm.matmul(a, b, precision="default", **kw),
        lambda: gemm.matmul_ref(a, b, **kw), bound_ms=b_ms, bound_by=b_by,
        split_ref=lambda: gemm._matmul_split_ref(a, b, **kw)))
    calls = gemm.LAUNCHES - launches0[0]
    device = gemm.DEVICE_LAUNCHES - launches0[1]
    require(device == 3 * calls, f"P1 matmul: {device} device launches for {calls} calls, not 3 each")
    results["matmul_split"] = split_profile(torch, gen, "matmul", r)
    results["matmul3_split"] = split_profile(torch, gen, "matmul3", r)
    results["matmul3_panel"] = matmul3_panel_rows(torch, gen, r)
    results["fp64"] = p1_fp64_errors(torch, gen)
    return results


def split_profile(torch, gen, kern: str, m: int, k: int = 1024, n: int = 1024,
                  sessions: int = 3):
    """One warm trailing update c - a bᵀ through the matmul (three planes)
    or matmul3 (two) kernel under torch.profiler: the device ms of the two
    pack launches and of the mainloop, with the ring the mainloop runs
    (slice depth, stages, dynamic shared bytes a CTA). A session that
    recorded other than three of the kernel's launches is taken again;
    after `sessions` the split is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()
    a, b, c = (torch.randn(*s, generator=gen, device="cuda") for s in ((m, k), (n, k), (m, n)))

    def run():
        if kern == "matmul3":
            return gemm3.matmul3(a, b, c, tb=True)
        return gemm.matmul(a, b, c, tb=True, alpha=-1.0, beta=1.0, precision="highest")

    run()
    torch.cuda.synchronize()
    split = None
    for attempt in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "gemm_split_" in e.name]
        if len(kernels) == 3:
            split = {"pack": 0.0, "mainloop": 0.0}
            for e in kernels:
                step = "pack" if "gemm_split_pack" in e.name else "mainloop"
                split[step] += e.time_range.elapsed_us() / 1e3
            break
    if split is None:
        print(f"chip_smoke: {kern}'s pack/mainloop split not measured ({sessions} sessions)",
              file=sys.stderr, flush=True)
    row = {"case": f"{kern}:trailing_split", "shape": [m, k, n], "device_ms": split,
           "sessions": attempt, **gemm.split_plan(2 if kern == "matmul3" else 3)}
    emit({"phase": "P1", **row})
    return row


def matmul3_panel_rows(torch, gen, r: int, w: int = 1024):
    """The Cholesky's panel route at the trailing update: one pack of an
    r x w panel b (gemm3.Panel), then c - b[off:] b[off:off + w]ᵀ for
    off = 0 (the trailing update's shape) and off = w, each against the
    per-call matmul3 on the same inputs, bit for bit (the same planes and
    mainloop). Times the pack, the update alone and the per-call route,
    in turns (CUDA events)."""
    from numpywren_tpu_torch.ops import gemm3

    def counts():
        return gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES

    b = torch.randn(r, w, generator=gen, device="cuda")
    calls, device = counts()
    panel = gemm3.Panel(b)
    require(counts() == (calls, device + 1), f"P1 matmul3 panel: the pack counted {counts()}")
    pack_ms = in_turns(torch, lambda: gemm3.Panel(b))[0]
    rows = []
    for off in (0, w):
        c = torch.randn(r - off, w, generator=gen, device="cuda")
        calls, device = counts()
        got = panel.sub_update(c, off, w)
        require(counts() == (calls + 1, device + 1),
                f"P1 matmul3 panel: an update counted {counts()} after {(calls, device)}")
        per_call = gemm3.matmul3(b[off:], b[off:off + w], c, tb=True)
        torch.cuda.synchronize()
        require(torch.equal(got, per_call),
                f"P1 matmul3 panel off={off}: differs from the per-call route")
        row = _check(f"matmul3:panel_off{off}", got, gemm3.matmul3_ref(b[off:], b[off:off + w],
                                                                       c, tb=True))
        ms, per_call_ms = in_turns(torch, lambda: panel.sub_update(c, off, w, out=c),
                                   lambda: gemm3.matmul3(b[off:], b[off:off + w], c, tb=True))
        m = r - off
        row.update(shape=[m, w, w], bitwise_equal_per_call=True, update_ms=ms,
                   per_call_ms=per_call_ms, pack_ms=pack_ms,
                   update_bf16_tflops=3 * 2 * m * w * w / ms / 1e9)
        emit({"phase": "P1", **row})
        rows.append(row)
    return rows


def p1_fp64_errors(torch, gen, m: int = 4096, n: int = 1024):
    """c - a bᵀ against its fp64 value (relative Frobenius) at K = 1024 and
    8192: the matmul kernel (bf16x6), torch.addmm (cuBLAS, true FP32) and
    the matmul3 kernel (bf16x3), on the same inputs."""
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()
    rows = []
    for k in (1024, 8192):
        a, b, c = (torch.randn(*s, generator=gen, device="cuda") for s in ((m, k), (n, k), (m, n)))
        exact = c.double() - a.double() @ b.double().T
        errs = {}
        for name, got in (
            ("matmul", gemm.matmul(a, b, c, tb=True, alpha=-1.0, beta=1.0, precision="highest")),
            ("addmm", torch.addmm(c, a, b.T, alpha=-1.0)),
            ("matmul3", gemm3.matmul3(a, b, c, tb=True)),
        ):
            errs[name] = float(torch.linalg.norm(got.double() - exact) / torch.linalg.norm(exact))
        row = {"case": f"fp64_error:k{k}", "shape": [m, k, n], "rel_err_vs_fp64": errs,
               "matmul_over_addmm": errs["matmul"] / errs["addmm"]}
        emit({"phase": "P1", **row})
        require(errs["matmul"] <= FP64_RATIO_BAR * errs["addmm"],
                f"P1 K={k}: matmul's error {errs['matmul']} > {FP64_RATIO_BAR} x addmm's "
                f"{errs['addmm']}")
        require(errs["matmul3"] <= MATMUL3_FP64_BAR,
                f"P1 K={k}: matmul3's error {errs['matmul3']} > {MATMUL3_FP64_BAR}")
        rows.append(row)
    return rows


def _check(name, got, want, bar=KERNEL_BAR):
    import torch

    torch.cuda.synchronize()
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    mx = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    require(rel <= bar, f"{name}: relative error {rel} > {bar}")
    return {"case": name, "rel_err": rel, "max_abs_err": mx}


def _compare(torch, name, m, k, n, run, plain, split_ref=None, split_bar=KERNEL_BAR, **extra):
    """`run` against `plain` (and against `split_ref`, the kernel's own
    arithmetic, when given, within `split_bar`), then both timed in turns."""
    row = _check(name, run(), plain())
    if split_ref is not None:
        row["rel_err_split_ref"] = _check(f"{name} vs split", run(), split_ref(),
                                          split_bar)["rel_err"]
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


def rtrsm_products(w: int, tile: int) -> int:
    """The products of _rtrsm on a w-wide panel (compiler/lower.py): one a
    tile-wide leaf; else the two halves' and the update between them."""
    if w <= tile:
        return 1
    h = (w // 2 + tile - 1) // tile * tile
    return rtrsm_products(h, tile) + 1 + rtrsm_products(w - h, tile)


def panel_route_counts(n: int, panel: int, tile: int):
    """(gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES) that one compensated Cholesky
    of n (a multiple of panel) implies: each panel with rows below runs its
    solve's products as matmul3 calls (three device launches each), one
    pack, and one mainloop per later column block (one launch, one call)."""
    nb = n // panel
    solves = (nb - 1) * rtrsm_products(panel, tile)
    updates = nb * (nb - 1) // 2
    return solves + updates, 3 * solves + (nb - 1) + updates


def cholesky_profile(torch, npw, a, sessions: int = 3):
    """One warm compensated cholesky_trapezoid of `a` under torch.profiler:
    device ms by kernel group, the ten largest kernels by name, and the
    idle share: 1 - (union of the kernels' intervals) / (first kernel start
    to last kernel end). Groups: the matmul3 calls of the panel solves
    (pack A, pack B, mainloop in a row), the panel packs and the trailing
    updates (a lone pack, a lone mainloop), cholesky_ex (cuSOLVER's
    getrf/potrf kernels), solve_triangular (trsm) and the rest. A session
    that recorded no mainloop is taken again; after `sessions` the row says
    not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    library = (("cholesky_ex", ("getrf", "potrf")), ("solve_triangular", ("trsm",)))
    row = {"phase": "P2_profile", "n": a.shape[0], "config": "compensated",
           "entry": "cholesky_trapezoid", "device_ms": None}
    for attempt in range(1, sessions + 1):
        t = npw.TrapezoidMatrix.from_array(a, panel=PANEL)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            npw.cholesky_trapezoid(t)
            torch.cuda.synchronize()
        del t
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        if not any("gemm_split_mainloop" in e.name for e in kernels):
            continue
        groups = dict.fromkeys(("solve_products", "panel_pack", "panel_updates",
                                "cholesky_ex", "solve_triangular", "other"), 0.0)
        by_name, split = {}, []
        for e in kernels:
            ms = e.time_range.elapsed_us() / 1e3
            count, total = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (count + 1, total + ms)
            if "gemm_split_" in e.name:
                split.append(("pack" if "gemm_split_pack" in e.name else "mainloop", ms))
                continue
            group = next((g for g, keys in library if any(k in e.name for k in keys)), "other")
            groups[group] += ms
        i = 0
        while i < len(split):  # a call's pack A, pack B, mainloop; else a panel's steps
            if [kind for kind, _ in split[i:i + 3]] == ["pack", "pack", "mainloop"]:
                groups["solve_products"] += sum(ms for _, ms in split[i:i + 3])
                i += 3
            else:
                groups["panel_pack" if split[i][0] == "pack" else "panel_updates"] += split[i][1]
                i += 1
        busy, end = 0.0, kernels[0].time_range.start
        for e in kernels:
            busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
            end = max(end, e.time_range.end)
        window = end - kernels[0].time_range.start
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        row.update(device_ms=groups, window_ms=window / 1e3, busy_ms=busy / 1e3,
                   idle_share=1 - busy / window, kernel_launches=len(kernels),
                   top=[{"name": k[:120], "launches": c, "ms": ms} for k, (c, ms) in top])
        break
    row["sessions"] = attempt
    if row["device_ms"] is None:
        print(f"chip_smoke: P2's profile not measured ({sessions} sessions)", file=sys.stderr,
              flush=True)
    emit(row)
    return row


def main_path(torch, npw, n: int, n_flat: int, seed: int):
    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()

    cfg = npw.default_config()
    launches = {"matmul": 0, "matmul3": 0}

    def reset():
        gemm.LAUNCHES = 0
        gemm.DEVICE_LAUNCHES = 0
        gemm3.LAUNCHES = 0
        gemm3.DEVICE_LAUNCHES = 0

    def check_matmul3(phase, n_, tile):
        want = panel_route_counts(n_, PANEL, tile)
        got = (gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES)
        require(got == want, f"{phase}: matmul3 (calls, device launches) {got}, the panel "
                             f"route implies {want}")
        return got[1]

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
    device2 = check_matmul3("P2", n, min(128, PANEL))
    launches["matmul3"] += c2["matmul3"]
    p2_row = report("P2", o2.trap, host_s, dev_s,
                    {"config": "compensated", "entry": "cholesky+run_program",
                     "bind_seconds": bind_s, "launches": c2, "matmul3_device_launches": device2})
    l2 = o2.trap
    del trap, o2, prog
    p2_row["profile"] = cholesky_profile(torch, npw, a)  # still compensated

    # P3: precision="highest", the matmul kernel
    cfg.compensated = False
    t = npw.TrapezoidMatrix.from_array(a, panel=PANEL)
    reset()
    l3, host_s, dev_s = run_entry(torch, lambda: npw.cholesky_trapezoid(t, precision="highest"))
    c3 = counts()
    require(c3["matmul"] > 0 and c3["matmul3"] == 0, f"P3 launches {c3}")
    require(gemm.DEVICE_LAUNCHES == 3 * c3["matmul"],
            f"P3: {gemm.DEVICE_LAUNCHES} device launches for {c3['matmul']} matmul calls")
    launches["matmul"] += c3["matmul"]
    p3_row = report("P3", l3, host_s, dev_s,
                    {"config": "highest", "entry": "cholesky_trapezoid", "launches": c3,
                     "device_launches": gemm.DEVICE_LAUNCHES})
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
    device5 = check_matmul3("P5", n_flat, 128)  # the flat lowering's inner tile
    launches["matmul3"] += c5["matmul3"]
    l5 = o5.array[:n_flat, :n_flat]
    resid = residual(torch, a5, l5)
    emit({"phase": "P5", "n": n_flat, "seconds": dev_s, "host_seconds": host_s,
          "tflops": n_flat ** 3 / 3 / dev_s / 1e12, "residual": resid,
          "config": "compensated", "entry": "cholesky(shard_matrix)+run_program",
          "bind_seconds": bind_s, "launches": c5, "matmul3_device_launches": device5})
    require(resid <= RESID_BAR, f"P5: residual {resid} > {RESID_BAR}")
    cfg.compensated = False
    return launches, (p2_row, p3_row, p4_row)


# ---------------------------------------------------------------------------
# P6-P7: the factorization kernels against their plain versions
# ---------------------------------------------------------------------------

def spd(torch, gen, n):
    x = torch.randn(n, n, generator=gen, device="cuda")
    return x @ x.T / n + torch.eye(n, device="cuda")


def spd_kappa(torch, gen, n, kappa):
    """An (n, n) SPD fp32 matrix with eigenvalues logspaced from 1 to 1/kappa."""
    q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, device="cuda").double())
    ev = torch.logspace(0, -float(torch.log10(torch.tensor(kappa))), n, device="cuda",
                        dtype=torch.float64)
    return ((q * ev) @ q.T).float()


SPLIT_STEPS = (("potrf_diag", "diag"), ("potrf_store", "store"), ("trtri_diag", "inv_diag"),
               ("trtri_level_t", "level_t"), ("trtri_level_w", "level_w"))


def launch_split(torch, fn, want: int, sessions: int = 3):
    """One warm call of a launch sequence (potrf, potrf_inv, trtri) under
    torch.profiler: (the sequence's kernels the session recorded, device ms
    by step, each launch's device µs in order, sessions taken, the names of
    other device records in the session). The matmul kernel's launches
    alternate panel solve, trailing update. A session that recorded another
    number of the sequence's kernels than the call enqueued (`want`; the
    profiler can lose a short session's device records) is taken again;
    after `sessions` such sessions the split and the list are None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        kernels = [e for e in device
                   if "gemm_kernel" in e.name or any(k in e.name for k, _ in SPLIT_STEPS)]
        other = sorted({e.name for e in device} - {e.name for e in kernels})
        if len(kernels) == want:
            break
    else:
        return len(kernels), None, None, sessions, other
    split, gemms = {}, 0
    for e in kernels:
        step = next((s for key, s in SPLIT_STEPS if key in e.name), "other")
        if "gemm_kernel" in e.name:
            step = ("solve", "update")[gemms % 2]
            gemms += 1
        split[step] = split.get(step, 0.0) + e.time_range.elapsed_us() / 1e3
    return len(kernels), split, [e.time_range.elapsed_us() for e in kernels], attempt, other


def p6_factor(torch, gen):
    """The four factor wrappers at n = 128..1024 (trtri and potrf_inv also
    at the ragged 384 and 640): kernel vs plain vs library, the launch
    sequences' device launches and their device split; potrf's diagonal
    step alone; potrf and trtri at kappa = 1e5."""
    gemm = gemm_module()
    from numpywren_tpu_torch.ops import pallas_factor as pf

    rows = {}
    d = spd(torch, gen, 128)
    got, want = pf.potrf_diag_block(d), pf._factor_block_rec_ref(d)
    torch.cuda.synchronize()
    errs = [rel_err(torch, g, w) for g, w in zip(got, want)]
    for g in got:
        require(bool(torch.isfinite(g).all()), "P6 potrf_diag: non-finite output")
        require(int(torch.count_nonzero(torch.triu(g, 1))) == 0,
                "P6 potrf_diag: strict upper triangle not 0")
    require(max(errs) <= KERNEL_BAR, f"P6 potrf_diag: rel error {errs} > {KERNEL_BAR}")
    ms, plain_ms = in_turns(torch, lambda: pf.potrf_diag_block(d),
                            lambda: pf._factor_block_rec_ref(d), iters=5)
    emit({"phase": "P6", "case": "potrf_diag:128", "n": 128, "rel_err": max(errs),
          "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
          "inv_err": float((got[0] @ got[1] - torch.eye(128, device="cuda")).abs().max()),
          "ms": ms, "plain_ms": plain_ms})
    for n in (128, 256, 384, 512, 640, 1024):
        a = spd(torch, gen, n)
        eye = torch.eye(n, device="cuda")
        x = torch.randn(2048, n, generator=gen, device="cuda")
        def chol():
            return torch.linalg.cholesky_ex(a)[0]

        def chol_inv():
            lo = chol()
            return lo, torch.linalg.solve_triangular(lo, eye, upper=False)

        l = chol()
        cases = {  # name -> (kernel, plain, library, flops, bytes)
            "potrf": (lambda: pf.potrf_pallas(a), lambda: pf.potrf_ref(a), chol,
                      n ** 3 / 3, 8 * n * n),
            "potrf_inv": (lambda: pf.potrf_inv_pallas(a), lambda: pf.potrf_inv_ref(a),
                          chol_inv, 2 * n ** 3 / 3, 12 * n * n),
            "trtri": (lambda: pf.trtri_pallas(l), lambda: pf.trtri_ref(l),
                      lambda: torch.linalg.solve_triangular(l, eye, upper=False),
                      n ** 3 / 3, 8 * n * n),
            "trsm": (lambda: pf.trsm_pallas(x, l, precision="highest"),
                     lambda: gemm.matmul_ref(x, pf.trtri_ref(l), tb=True),
                     lambda: torch.linalg.solve_triangular(l.T, x, upper=True, left=False),
                     n ** 3 / 3 + 2 * 2048 * n * n, 4 * (n * n + 2 * 2048 * n)),
        }
        for name, (kern, plain, lib, flops, nbytes) in cases.items():
            if n in (384, 640) and name not in ("trtri", "potrf_inv"):
                continue  # the ragged doubling levels
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            errs = [rel_err(torch, g, w) for g, w in zip(got, want)]
            mx = max(float((g - w).abs().max()) for g, w in zip(got, want))
            for g in got:
                require(bool(torch.isfinite(g).all()), f"P6 {name} n={n}: non-finite output")
            require(max(errs) <= KERNEL_BAR, f"P6 {name} n={n}: rel error {errs} > {KERNEL_BAR}")
            row = {"phase": "P6", "case": f"{name}:{n}", "n": n, "rel_err": max(errs),
                   "max_abs_err": mx}
            if name != "trsm":
                w = got[-1]
                lw = (got[0] @ w) if name == "potrf_inv" else (l @ w if name == "trtri" else None)
                for t in got:
                    require(int(torch.count_nonzero(torch.triu(t, 1))) == 0,
                            f"P6 {name} n={n}: strict upper triangle not 0")
                if lw is not None:
                    inv_err = float((lw - eye).abs().max())
                    require(inv_err <= INV_BAR, f"P6 {name} n={n}: ||LW - I|| {inv_err}")
                    row["inv_err"] = inv_err
            ms, plain_ms, lib_ms = in_turns(torch, kern, plain, lib, iters=5)
            b_ms, b_by = bound(flops, nbytes, PEAK_FP32)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            if name != "trsm":
                want_launches = pf.device_launches(name, n)
                before = pf.DEVICE_LAUNCHES[name]
                kern()
                torch.cuda.synchronize()
                row["device_launches"] = pf.DEVICE_LAUNCHES[name] - before
                require(row["device_launches"] == want_launches,
                        f"P6 {name} n={n}: {row['device_launches']} device launches, "
                        f"expected {want_launches}")
                (row["profiled_launches"], row["device_ms_by_step"], row["device_us_by_launch"],
                 row["profile_sessions"], row["profiled_other"]) = launch_split(
                    torch, kern, want_launches)
                if row["device_ms_by_step"] is None:
                    print(f"chip_smoke: P6 {name} n={n}: the profiler recorded "
                          f"{row['profiled_launches']} of {want_launches} kernels in "
                          f"{row['profile_sessions']} sessions; split not measured",
                          file=sys.stderr)
            emit(row)
            rows[(name, n)] = row

    a = spd_kappa(torch, gen, 1024, 1e5)
    l = pf.potrf_pallas(a).double()
    resid = rel_err(torch, l @ l.T, a)
    emit({"phase": "P6", "case": "potrf_kappa_1e5:1024", "n": 1024, "kappa": 1e5,
          "residual": resid})
    require(resid <= KERNEL_BAR, f"P6 potrf kappa=1e5: residual {resid} > {KERNEL_BAR}")

    # trtri of that factor at kappa = 1e5: ||L W - I||_max within 10x the library's
    l = l.float()
    eye = torch.eye(1024, device="cuda")
    w = pf.trtri_pallas(l)
    w_lib = torch.linalg.solve_triangular(l, eye, upper=False)
    inv_err, lib_err = (float((l.double() @ x.double() - eye.double()).abs().max())
                        for x in (w, w_lib))
    rel = rel_err(torch, w, pf.trtri_ref(l))
    emit({"phase": "P6", "case": "trtri_kappa_1e5:1024", "n": 1024, "kappa": 1e5,
          "inv_err": inv_err, "library_inv_err": lib_err, "rel_err_vs_plain": rel})
    require(bool(torch.isfinite(w).all()), "P6 trtri kappa=1e5: non-finite output")
    require(inv_err <= 10 * lib_err,
            f"P6 trtri kappa=1e5: ||LW - I|| {inv_err} > 10 x the library's {lib_err}")

    # outside the envelope: torch.linalg, no launch
    before = dict(pf.LAUNCHES)
    a = spd(torch, gen, 1000)
    l, w = pf.potrf_inv_pallas(a)
    pf.potrf_pallas(a)
    pf.trtri_pallas(l)
    torch.cuda.synchronize()
    require(pf.LAUNCHES == before, f"P6 off-envelope n=1000 launched {pf.LAUNCHES} vs {before}")
    emit({"phase": "P6", "case": "off_envelope:1000", "launches_unchanged": True,
          "inv_err": float((l @ w - torch.eye(1000, device="cuda")).abs().max())})
    return rows


def p6_ops_path(torch, gen, n_rows: int = 31744, n: int = PANEL):
    """The ops entry points on the first panel of an N=32768 Cholesky:
    potrf_pallas of the 1024 diagonal block, trsm_pallas of the 31744 x
    1024 block below it (kernels.potrf / kernels.trsm semantics)."""
    from numpywren_tpu_torch import ops
    gemm = gemm_module()
    from numpywren_tpu_torch.ops import pallas_factor as pf

    a = spd(torch, gen, n)
    b = torch.randn(n_rows, n, generator=gen, device="cuda")
    torch.cuda.synchronize()
    pf.reset_launches()
    gemm.LAUNCHES = 0

    def drive():
        lo = ops.potrf_pallas(a)
        return lo, ops.trsm_pallas(b, lo, precision="highest")

    (l, x), host_s, dev_s = run_entry(torch, drive)
    counts = {**pf.LAUNCHES, "matmul": gemm.LAUNCHES}
    require(counts["potrf"] == 1 and counts["trtri"] == 1, f"P6 ops path launches {counts}")
    resid = rel_err(torch, l @ l.T, a)
    solve = rel_err(torch, x @ l.T, b)
    emit({"phase": "P6", "case": "ops_path", "shape": [n_rows, n], "seconds": dev_s,
          "host_seconds": host_s, "launches": counts, "potrf_residual": resid,
          "trsm_residual": solve})
    require(resid <= KERNEL_BAR and solve <= KERNEL_BAR,
            f"P6 ops path residuals {resid}, {solve} > {KERNEL_BAR}")
    return counts


def kappa_panel(torch, gen, m, b, kappa):
    """An (m, b) panel with singular values logspaced from 1 to 1/kappa."""
    u, _ = torch.linalg.qr(torch.randn(m, b, generator=gen, device="cuda"))
    v, _ = torch.linalg.qr(torch.randn(b, b, generator=gen, device="cuda"))
    s = torch.logspace(0, -float(torch.log10(torch.tensor(kappa))), b, device="cuda")
    return (u * s) @ v.T


def chain_split(torch, fn, want=None, sessions: int = 3):
    """One warm chain call under torch.profiler, as a dict: device ms by
    part, each launch's device µs in order, the port's launches the
    session recorded, sessions taken, the call's ms by CUDA events in that
    session and the profiler's span from the first launch's start to the
    last one's end. The parts: step 0 (every launch before the apply), the
    apply's two packs and its mainloop (gemm_split.cu), or "apply_ffma",
    the last launch, in a tree whose apply is one FFMA launch (no pack).
    PyTorch's own kernels (the conv flag's comparison) are left out. The
    span against the events' time shows whether the profiler's
    timestamps run on the events' clock. A session that recorded another
    number of the port's launches than `want` (when given) is taken
    again; after `sessions` such sessions the split and the list are
    None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, sessions + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        recs = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA and "at::" not in e.name),
                      key=lambda e: e.time_range.start)
        if want is None or len(recs) == want:
            break
    else:
        return {"device_ms_by_part": None, "device_us_by_launch": None,
                "profiled_launches": len(recs), "profile_sessions": sessions}
    first = next((i for i, e in enumerate(recs) if "gemm_split_pack" in e.name), len(recs) - 1)
    split = {"step0": 0.0, "pack": 0.0, "mainloop": 0.0}
    for i, e in enumerate(recs):
        part = ("step0" if i < first else "pack" if "gemm_split_pack" in e.name
                else "mainloop" if "gemm_split_mainloop" in e.name else "apply_ffma")
        split[part] = split.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
    return {"device_ms_by_part": split,
            "device_us_by_launch": [e.time_range.elapsed_us() for e in recs],
            "profiled_launches": len(recs), "profile_sessions": attempt,
            "profiled_call_ms": start.elapsed_time(end),
            "device_span_ms": (recs[-1].time_range.end - recs[0].time_range.start) / 1e3}


def chain_kw(m: int, b: int, rows: bool) -> dict:
    """P7's chain arguments: the shift of _cholqr_adaptive's fold path."""
    return dict(rows=rows, shift_c=4.0 * 2.0 ** -23 * (m * b) ** 0.5,
                conv_gate=min(2.0 * 1e-4 ** 0.5, 1e-1))


def fresh_chain_split(torch, m: int, b: int, rows: int, want: int):
    """chain_split of one chain call on a kappa 10 operand of P7's shape, in
    the process that calls it: the body of chain_split_new_process."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    p = kappa_panel(torch, torch.Generator(device="cuda").manual_seed(0), m, b, 10.0)
    if rows:
        p = p.T.contiguous()
    g = p @ p.T if rows else p.T @ p
    kw = chain_kw(m, b, bool(rows))
    return chain_split(torch, lambda: pf.cholqr2_chain_pallas(g, p, **kw), want)


def chain_split_new_process(m: int, b: int, rows: bool, want: int):
    """chain_split in a process of its own, whose profiler has recorded
    nothing before. A process's later profiler sessions can lose device
    records (P6's sessions in one full run, the second form's in a short
    one), a first session in a new process has not."""
    code = ("import json, sys, torch, chip_smoke; print(json.dumps("
            "chip_smoke.fresh_chain_split(torch, *map(int, sys.argv[1:]))))")
    proc = subprocess.run([sys.executable, "-c", code, str(m), str(b), str(int(rows)), str(want)],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=300)
    require(proc.returncode == 0, f"P7 split process: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def p7_chain(torch, gen, m: int, b: int = 256):
    """The chain at (m, b), kappa 10, both forms: against cholqr2_chain_ref
    (q max abs <= 3e-5, total rel <= 1e-5, conv, dev2 rel <= 1e-4) and
    _cholqr2_chain_steps_ref (the same, q rel <= 1e-5); its device
    launches; its device time by part and by launch (required; taken in a
    new process, whose profiler has recorded nothing before); both folds (the
    identity at shift_c = 1, not converged; the Neumann cleanup at a
    hundredth of the shift) finite and as its plain version; a failed
    factor (dev2 NaN, conv False, the identity fold); ms of the
    kernel, its plain version and passes 1-2 of _cholqr_adaptive by the
    library and by the chain (with the Gram), in turns; the bound at three
    bf16 planes (the apply's products) beside the FFMA bound."""
    from numpywren_tpu_torch.compiler import lower
    from numpywren_tpu_torch.ops import pallas_factor as pf

    out = {}
    want = pf.device_launches("cholqr2_chain", b)
    base = kappa_panel(torch, gen, m, b, 10.0)
    for rows in (False, True):
        p = base.T.contiguous() if rows else base
        g = p @ p.T if rows else p.T @ p
        kw = chain_kw(m, b, rows)
        case = f"chain:{'rows' if rows else 'cols'}"
        before = pf.DEVICE_LAUNCHES["cholqr2_chain"]
        q, total, conv, dev2 = pf.cholqr2_chain_pallas(g, p, **kw)
        torch.cuda.synchronize()
        launched = pf.DEVICE_LAUNCHES["cholqr2_chain"] - before
        require(launched == want, f"P7 {case}: {launched} device launches, expected {want}")
        row = {"phase": "P7", "case": case, "shape": list(p.shape), "kappa": 10.0,
               "dev2": float(dev2), "conv": bool(conv), "device_launches": launched}
        for name, plain in (("plain", pf.cholqr2_chain_ref), ("steps", pf._cholqr2_chain_steps_ref)):
            qr_, tr, convr, dev2r = plain(g, p, **kw)
            torch.cuda.synchronize()
            qerr = float((q - qr_).abs().max())
            errs = {"max_abs_err": qerr, "q_rel_err": rel_err(torch, q, qr_),
                    "total_rel_err": rel_err(torch, total, tr),
                    "dev2_rel_err": abs(float(dev2) - float(dev2r)) / float(dev2r)}
            require(qerr <= CHAIN_Q_BAR, f"P7 {case}: max|q - q_{name}| {qerr} > {CHAIN_Q_BAR}")
            if name == "steps":
                require(errs["q_rel_err"] <= KERNEL_BAR,
                        f"P7 {case}: q rel {errs['q_rel_err']} vs its steps > {KERNEL_BAR}")
            require(errs["total_rel_err"] <= KERNEL_BAR,
                    f"P7 {case}: total rel {errs['total_rel_err']} vs {name} > {KERNEL_BAR}")
            require(bool(conv) == bool(convr), f"P7 {case}: conv {bool(conv)} vs {bool(convr)}")
            require(errs["dev2_rel_err"] <= DEV2_BAR,
                    f"P7 {case}: dev2 {float(dev2)} vs {name}'s {float(dev2r)}")
            row.update({f"{k}_vs_{name}" if name == "steps" else k: v for k, v in errs.items()})
            del qr_
        del q

        # both folds at this size, whichever the operand's own shift takes:
        # the identity (shift_c = 1: dev2 >= 0.1, conv False) and the
        # Neumann cleanup (a hundredth of the shift: dev2 < 0.1)
        for branch, shift_c in (("identity", 1.0), ("neumann", kw["shift_c"] / 100)):
            bkw = dict(kw, shift_c=shift_c)
            qi, ti, convi, dev2i = pf.cholqr2_chain_pallas(g, p, **bkw)
            qs, ts, convs, dev2s = pf._cholqr2_chain_steps_ref(g, p, **bkw)
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(x).all()) for x in (qi, ti, dev2i))
            res = row[branch] = {"dev2": float(dev2i), "conv": bool(convi), "finite": finite,
                                 "q_rel_err": rel_err(torch, qi, qs),
                                 "total_rel_err": rel_err(torch, ti, ts)}
            taken = float(dev2i) >= 0.1 if branch == "identity" else float(dev2i) < 0.1
            require(finite and taken and bool(convi) == bool(convs)
                    and (branch == "neumann" or not bool(convi)),
                    f"P7 {case} {branch} branch: {res}")
            require(res["q_rel_err"] <= KERNEL_BAR and res["total_rel_err"] <= KERNEL_BAR,
                    f"P7 {case} {branch} branch vs its steps: {res}")
            del qi, qs

        # a failed factor (g's last diagonal entry negated, so the last
        # pivot is negative): dev2 NaN, conv False and the identity fold, so
        # R's NaN is its failed row (rows) or column (columns) alone
        gf = g.clone()
        gf[-1, -1] = -gf[-1, -1]
        _, tf, convf, dev2f = pf.cholqr2_chain_pallas(gf, p, **kw)
        _, tfs, _ = pf._chain_step0_ref(gf, rows=rows, shift_c=kw["shift_c"])
        failed = torch.isnan(tfs)
        res = row["failed_factor"] = {
            "dev2_is_nan": bool(torch.isnan(dev2f)), "conv": bool(convf),
            "nan_in_total": int(torch.isnan(tf).sum()), "nan_in_steps": int(failed.sum()),
            "total_rel_err": rel_err(torch, tf[~failed], tfs[~failed])}
        require(res["dev2_is_nan"] and not res["conv"] and res["nan_in_steps"] == b
                and bool(torch.equal(torch.isnan(tf), failed))
                and res["total_rel_err"] <= KERNEL_BAR, f"P7 {case} failed factor: {res}")
        del gf, tf, tfs

        set_flags()
        ms, plain_ms, lib_ms, chained_ms = in_turns(
            torch,
            lambda: pf.cholqr2_chain_pallas(g, p, **kw),
            lambda: pf.cholqr2_chain_ref(g, p, **kw),
            lambda: lower._cholqr_adaptive(p, rows=rows, max_passes=2),
            lambda: lower._cholqr_adaptive(p, rows=rows, max_passes=2, pallas_chain=True),
            iters=5)
        prof = chain_split_new_process(m, b, rows, want)
        require(prof["device_ms_by_part"] is not None,
                f"P7 {case}: the profiler recorded {prof['profiled_launches']} of {want} "
                f"launches in {prof['profile_sessions']} sessions")
        # step 0: potrf_inv (2 b^3 / 3) and seven b x b products, FP32
        small = 2 * b ** 3 / 3 + 7 * 2 * b ** 3
        nbytes = 4 * (2 * m * b + 2 * b * b + 2)
        # six bf16 products of the apply on the tensor cores, step 0 on FFMA
        b_ms, b_by = max(((6 * 2 * m * b * b / PEAK_BF16 + small / PEAK_FP32) * 1e3,
                          "operations"), (nbytes / PEAK_HBM * 1e3, "bytes"))
        ffma_ms, ffma_by = bound(2 * m * b * b + small, nbytes, PEAK_FP32)
        row.update(ms=ms, plain_ms=plain_ms, library_passes12_ms=lib_ms,
                   chain_passes12_ms=chained_ms, bound_ms=b_ms, bound_by=b_by,
                   ffma_bound_ms=ffma_ms, ffma_bound_by=ffma_by, **prof,
                   device_ms_sum=sum(prof["device_ms_by_part"].values()))
        emit(row)
        out[rows] = row
        del p, g
    return out


# ---------------------------------------------------------------------------
# P8-P11: TSQR through tsqr + run_program
# ---------------------------------------------------------------------------

def qr_quality(torch, x, q, r, chunk: int = 1 << 17):
    """(||QᵀQ - I||_F / sqrt(b), ||QR - X||_F / ||X||_F) in fp64 on the card."""
    b = r.shape[0]
    r64 = r.double()
    gram = torch.zeros(b, b, dtype=torch.float64, device="cuda")
    num = den = 0.0
    for i0 in range(0, x.shape[0], chunk):
        qc = q[i0:i0 + chunk].double()
        xc = x[i0:i0 + chunk].double()
        gram += qc.T @ qc
        d = qc @ r64 - xc
        num += float((d * d).sum())
        den += float((xc * xc).sum())
    ortho = float(torch.linalg.norm(gram - torch.eye(b, dtype=torch.float64, device="cuda")))
    return ortho / b ** 0.5, (num / den) ** 0.5


def sign_fixed(r):
    s = r.diagonal().sign()
    s[s == 0] = 1
    return s[:, None] * r


def tsqr_phase(torch, npw, phase, x, method, flags, tile_rows=4096, r_ref=None, extra=None,
               repeat: int = 3):
    """tsqr(x) + run_program with the opt-in `flags` on, `repeat` times (the
    first pays this shape's first allocations); checks the last run's
    output and emits one line with every run's seconds; returns (R, the
    last run's kernel launch counts)."""
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()
    from numpywren_tpu_torch.ops import pallas_factor as pf

    m, b = x.shape
    set_flags(flags)
    runs = []
    for _ in range(repeat):
        out = None  # the previous run's outputs go before this one allocates
        pf.reset_launches()
        gemm.LAUNCHES = gemm3.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog, out, _ = npw.tsqr(x, tile_rows=tile_rows, method=method, compute_q=True)
        bind_s = time.perf_counter() - t0
        _, host_s, dev_s = run_entry(torch, lambda: npw.run_program(prog))
        runs.append((dev_s, host_s, bind_s))
    counts = {**pf.LAUNCHES, "matmul": gemm.LAUNCHES, "matmul3": gemm3.LAUNCHES}
    set_flags()
    q = out["Q"].array[:m, :b]
    r = out["R"].get_block(*out["R_block"])
    ortho, resid = qr_quality(torch, x, q, r)
    dev_s, host_s, bind_s = runs[-1]
    row = {"phase": phase, "shape": [m, b], "tile_rows": tile_rows, "method": method,
           "flags": list(flags), "seconds": dev_s, "host_seconds": host_s,
           "bind_seconds": bind_s, "seconds_runs": [r_[0] for r_ in runs],
           "tflops": (2 * m * b * b - 2 * b ** 3 / 3) / dev_s / 1e12,
           "ortho": ortho, "residual": resid, "launches": counts, **(extra or {})}
    if r_ref is not None:
        row["r_rel_diff"] = rel_err(torch, sign_fixed(r), sign_fixed(r_ref))
    emit(row)
    require(ortho <= ORTHO_BAR, f"{phase} {method} {flags}: ortho {ortho} > {ORTHO_BAR}")
    require(resid <= QR_RESID_BAR, f"{phase} {method} {flags}: residual {resid}")
    if r_ref is not None:
        require(row["r_rel_diff"] <= R_AGREE_BAR,
                f"{phase} {method} {flags}: R differs {row['r_rel_diff']} > {R_AGREE_BAR}")
    return r.clone(), counts


def tsqr_phases(torch, npw, gen, m: int, m_small: int):
    launches = {"potrf_inv": 0, "cholqr2_chain": 0}
    def routes(phase, x, kernel_flag, need):
        r_lib, _ = tsqr_phase(torch, npw, phase, x, "cholqr3s", ())
        r_k, c = tsqr_phase(torch, npw, phase, x, "cholqr3s", (kernel_flag,), r_ref=r_lib)
        require(c[need] > 0, f"{phase}: {need} launches {c}")
        launches[need] += c[need]
        return r_lib

    x = torch.randn(m, 512, generator=gen, device="cuda")
    routes("P8", x, "NPW_PALLAS_FACTOR", "potrf_inv")
    del x
    x = torch.randn(m, 256, generator=gen, device="cuda")
    routes("P9", x, "NPW_PALLAS_CHAIN", "cholqr2_chain")
    del x

    x = kappa_panel(torch, gen, m_small, 256, 1e6)
    r_lib, _ = tsqr_phase(torch, npw, "P10", x, "cholqr3s", (), extra={"kappa": 1e6})
    _, c = tsqr_phase(torch, npw, "P10", x, "cholqr3s", FLAGS, r_ref=r_lib,
                      extra={"kappa": 1e6})
    require(c["cholqr2_chain"] > 0 and c["potrf_inv"] > 0, f"P10 launches {c}")
    for k in launches:
        launches[k] += c[k]

    x = torch.randn(m_small, 256, generator=gen, device="cuda")
    r_lib, _ = tsqr_phase(torch, npw, "P11", x, "cholqr3s", ())
    for method in ("cholqr2", "tree"):
        tsqr_phase(torch, npw, "P11", x, method, (), r_ref=r_lib)
    return launches


# ---------------------------------------------------------------------------
# P12: GEMM through gemm + run_program
# ---------------------------------------------------------------------------

def p12_gemm(torch, npw, gen, n: int):
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()

    cfg = npw.default_config()
    a = torch.randn(n, n, generator=gen, device="cuda")
    b = torch.randn(n, n, generator=gen, device="cuda")
    exact = a.double() @ b.double()
    matmul3_launches = 0
    for i, comp in enumerate((False, True, False, True)):  # warm, then measured
        cfg.compensated = comp
        gemm.LAUNCHES = gemm3.LAUNCHES = 0
        prog, c, _ = npw.gemm(a, b, tile=(512, 512))
        _, host_s, dev_s = run_entry(torch, lambda: npw.run_program(prog))
        counts = {"matmul": gemm.LAUNCHES, "matmul3": gemm3.LAUNCHES}
        err = rel_err(torch, c.array[:n, :n], exact)
        require(err <= KERNEL_BAR, f"P12 compensated={comp}: rel error {err} > {KERNEL_BAR}")
        require((counts["matmul3"] > 0) == comp, f"P12 compensated={comp}: launches {counts}")
        emit({"phase": "P12", "n": n, "tile": 512, "config": "compensated" if comp else "default",
              "seconds": dev_s, "host_seconds": host_s, "tflops": 2 * n ** 3 / dev_s / 1e12,
              "rel_err_vs_fp64": err, "launches": counts, "warmup": i < 2})
        matmul3_launches = counts["matmul3"]
        del prog, c
    cfg.compensated = False
    return matmul3_launches


# ---------------------------------------------------------------------------
# P13-P14: the qr kernel and ops.qr_leaf
# ---------------------------------------------------------------------------

QR_SHAPES = ((128, 128), (256, 128), (512, 512), (1024, 256), (2048, 128))
QR_ORTHO_BAR = 2e-5   # ||QᵀQ - I||_max of the kernel (tests/test_pallas_factor.py:92)
QR_KAPPA_ORTHO_BAR = 5e-5  # the same at kappa = 1e7 (tests/test_pallas_factor.py:108)


def qr_bound(m, n):
    """Geqrf plus the Q rebuild, 4mn² - 4n³/3 flops; A read, Q and R written."""
    return bound(4 * m * n * n - 4 * n ** 3 / 3, 4 * (2 * m * n + n * n), PEAK_FP32)


def p13_qr(torch, gen):
    """The qr kernel against qr_ref and _qr_rowsplit_ref at the reference
    tests' shapes, with its launch's CTAs and shared bytes per CTA, a zero
    column and kappa = 1e7 at 512 x 128; ms of kernel, plain and
    torch.linalg.qr in turns; an off-envelope call launches nothing."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    rows = {}
    cases = [(f"{m}x{n}", torch.randn(m, n, generator=gen, device="cuda")) for m, n in QR_SHAPES]
    zero = torch.randn(512, 128, generator=gen, device="cuda")
    zero[:, 5] = 0.0
    cases.append(("zero_column:512x128", zero))
    cases.append(("kappa_1e7:512x128", kappa_panel(torch, gen, 512, 128, 1e7)))
    for case, a in cases:
        m, n = a.shape
        before = pf.LAUNCHES["qr"]
        q, r = pf.qr_pallas(a)
        require(pf.LAUNCHES["qr"] == before + 1, f"P13 {case}: the kernel did not launch")
        qp, rp = pf.qr_ref(a)
        plan = pf.qr_plan(m, n)
        qs, rs = pf._qr_rowsplit_ref(a, plan["parts"])
        torch.cuda.synchronize()
        for t in (q, r):
            require(bool(torch.isfinite(t).all()), f"P13 {case}: non-finite output")
        require(bool(torch.equal(torch.triu(r), r)), f"P13 {case}: R not exactly upper")
        eye = torch.eye(n, device="cuda", dtype=torch.float64)
        ortho = float((q.double().T @ q.double() - eye).abs().max())
        recon = float((q.double() @ r.double() - a.double()).abs().max() / a.abs().max())
        q_err, r_err = rel_err(torch, q, qp), rel_err(torch, r, rp)
        qs_err, rs_err = rel_err(torch, q, qs), rel_err(torch, r, rs)
        mx = max(float((q - qp).abs().max()), float((r - rp).abs().max()))
        row = {"phase": "P13", "case": case, "shape": [m, n], "ctas": plan["parts"],
               "smem_bytes_per_cta": plan["smem_bytes"], "q_rel_err": q_err,
               "r_rel_err": r_err, "q_rel_err_rowsplit": qs_err, "r_rel_err_rowsplit": rs_err,
               "max_abs_err": mx, "ortho": ortho, "recon": recon}
        if case.startswith("kappa"):
            # Q's last columns are determined only to eps·kappa: held by
            # orthogonality and reconstruction (tests/test_pallas_factor.py)
            require(ortho <= QR_KAPPA_ORTHO_BAR, f"P13 {case}: ortho {ortho}")
            require(recon <= 1e-5, f"P13 {case}: reconstruction {recon}")
        else:
            require(max(q_err, r_err) <= KERNEL_BAR,
                    f"P13 {case}: rel error q {q_err} r {r_err} > {KERNEL_BAR}")
            require(max(qs_err, rs_err) <= KERNEL_BAR,
                    f"P13 {case}: rel error to the row split q {qs_err} r {rs_err} > {KERNEL_BAR}")
            require(ortho <= QR_ORTHO_BAR, f"P13 {case}: ortho {ortho} > {QR_ORTHO_BAR}")
        runs = [lambda: pf.qr_pallas(a), lambda: torch.linalg.qr(a, mode="reduced")]
        if case in ("2048x128", "512x512"):
            runs.append(lambda: pf.qr_ref(a))
        times = in_turns(torch, *runs, iters=5)
        b_ms, b_by = qr_bound(m, n)
        row.update(ms=times[0], library_ms=times[1], bound_ms=b_ms, bound_by=b_by)
        if len(times) > 2:
            row.update(plain_ms=times[2])
        emit(row)
        rows[case] = row
    before = dict(pf.LAUNCHES)
    a = torch.randn(100, 60, generator=gen, device="cuda")
    q, r = pf.qr_pallas(a)
    torch.cuda.synchronize()
    require(pf.LAUNCHES == before, f"P13 off-envelope 100x60 launched {pf.LAUNCHES}")
    emit({"phase": "P13", "case": "off_envelope:100x60", "launches_unchanged": True,
          "recon": float((q @ r - a).abs().max())})
    return rows


def p14_qr_leaf(torch, gen, m: int, leaf: int = 2048, b: int = 128):
    """ops.qr_leaf with NPW_PALLAS_QR=1 on every leaf x b row block of an
    m x b operand (the qr kernel), then with the flag off (the library)."""
    from numpywren_tpu_torch import ops
    from numpywren_tpu_torch.ops import pallas_factor as pf

    x = torch.randn(m, b, generator=gen, device="cuda")
    blocks = [x[i:i + leaf] for i in range(0, m, leaf)]
    out = {}
    for route in ("library", "kernel", "kernel", "library"):  # in turns; the second of each is kept
        os.environ["NPW_PALLAS_QR"] = "1" if route == "kernel" else "0"
        pf.reset_launches()
        res, host_s, dev_s = run_entry(torch, lambda: [ops.qr_leaf(blk) for blk in blocks])
        out[route] = (res, host_s, dev_s, pf.LAUNCHES["qr"])
    os.environ["NPW_PALLAS_QR"] = "0"
    launches = out["kernel"][3]
    require(launches == len(blocks), f"P14: {launches} qr launches for {len(blocks)} leaves")
    require(out["library"][3] == 0, "P14: the library route launched the kernel")
    ortho = resid = r_diff = 0.0
    for blk, (q, r), (_, r_lib) in zip(blocks, out["kernel"][0], out["library"][0]):
        o, e = qr_quality(torch, blk, q, r)
        ortho, resid = max(ortho, o), max(resid, e)
        r_diff = max(r_diff, rel_err(torch, sign_fixed(r), sign_fixed(r_lib)))
    row = {"phase": "P14", "shape": [m, b], "leaf": [leaf, b], "leaves": len(blocks),
           "launches": launches, "kernel_seconds": out["kernel"][2],
           "kernel_host_seconds": out["kernel"][1], "library_seconds": out["library"][2],
           "worst_ortho": ortho, "worst_residual": resid, "worst_r_rel_diff": r_diff}
    emit(row)
    require(ortho <= ORTHO_BAR, f"P14: ortho {ortho} > {ORTHO_BAR}")
    require(resid <= QR_RESID_BAR, f"P14: residual {resid} > {QR_RESID_BAR}")
    require(r_diff <= R_AGREE_BAR, f"P14: R differs {r_diff} > {R_AGREE_BAR}")
    return launches


# ---------------------------------------------------------------------------
# P15-P16: the generic executors
# ---------------------------------------------------------------------------

def spd_flat(torch, gen, n):
    x = torch.randn(n, n, generator=gen, device="cuda")
    a = x @ x.T / n
    a.diagonal().add_(2.0)
    return symmetric_from_lower(a.tril())


def dsl_run(torch, npw, prog, **kw):
    """run_program(prog, **kw): (status, host s, device s)."""
    return run_entry(torch, lambda: npw.run_program(prog, **kw))


def p15_generic(torch, npw, gen, n: int, n_gemm: int, m_tsqr: int, n_bdfac: int,
                tile_bdfac: int):
    """executor="jax" (TorchTaskExecutor) on the JAX package's own generic-
    executor configurations (BENCH.md's DSL cholesky, gemm, tsqr, bdfac)."""
    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.runtime.executor import TorchTaskExecutor

    def jax_exec(prog, **kw):
        ex = TorchTaskExecutor(prog, **kw)
        _, host_s, dev_s = run_entry(torch, ex.run)
        return ex.groups_run, host_s, dev_s

    a = spd_flat(torch, gen, n)
    for trsm_inv in (True, False):
        prog, o, _ = npw.cholesky(shard_matrix(a, tile=(1024, 1024)))
        groups, host_s, dev_s = jax_exec(prog, trsm_inv=trsm_inv)
        resid = residual(torch, a, o.array[:n, :n])
        emit({"phase": "P15", "program": "cholesky", "n": n, "tile": 1024,
              "nodes": prog.num_nodes, "trsm_inv": trsm_inv, "groups": groups,
              "seconds": dev_s, "host_seconds": host_s, "residual": resid})
        require(resid <= RESID_BAR, f"P15 cholesky trsm_inv={trsm_inv}: residual {resid}")
        del prog, o
    del a
    torch.cuda.empty_cache()

    a = torch.randn(n_gemm, n_gemm, generator=gen, device="cuda")
    b = torch.randn(n_gemm, n_gemm, generator=gen, device="cuda")
    prog, c, meta = npw.gemm(a, b, tile=(1024, 1024))
    groups, host_s, dev_s = jax_exec(prog)
    err = rel_err(torch, c.array[:n_gemm, :n_gemm], a.double() @ b.double())
    emit({"phase": "P15", "program": "gemm", "n": n_gemm, "tile": 1024,
          "nodes": prog.num_nodes, "groups": groups, "seconds": dev_s,
          "host_seconds": host_s, "rel_err_vs_fp64": err, "k_chunk": meta["k_chunk"]})
    require(err <= KERNEL_BAR, f"P15 gemm: rel error {err} > {KERNEL_BAR}")
    del a, b, prog, c
    torch.cuda.empty_cache()

    x = torch.randn(m_tsqr, 256, generator=gen, device="cuda")
    # the R to agree with: another algorithm, the fused cholqr3s library route
    prog, out, _ = npw.tsqr(x, tile_rows=4096, method="cholqr3s")
    npw.run_program(prog)
    r_ref = out["R"].get_block(*out["R_block"]).clone()
    prog, out, _ = npw.tsqr(x, tile_rows=4096, compute_q=True)
    groups, host_s, dev_s = jax_exec(prog)
    q = out["Q"].array[:m_tsqr, :256]
    r = out["R"].get_block(*out["R_block"])
    ortho, resid = qr_quality(torch, x, q, r)
    r_diff = rel_err(torch, sign_fixed(r), sign_fixed(r_ref))
    emit({"phase": "P15", "program": "tsqr_q", "shape": [m_tsqr, 256], "tile_rows": 4096,
          "nodes": prog.num_nodes, "groups": groups, "seconds": dev_s,
          "host_seconds": host_s, "ortho": ortho, "residual": resid, "r_rel_diff": r_diff})
    require(ortho <= ORTHO_BAR and resid <= QR_RESID_BAR and r_diff <= R_AGREE_BAR,
            f"P15 tsqr: ortho {ortho}, residual {resid}, R differs {r_diff}")
    del x, prog, out, q
    torch.cuda.empty_cache()

    x = torch.randn(n_bdfac, n_bdfac, generator=gen, device="cuda")
    prog, bmat, _ = npw.bdfac(x, tile=(tile_bdfac, tile_bdfac))
    groups, host_s, dev_s = jax_exec(prog)
    bd = bmat.array[:n_bdfac, :n_bdfac]
    t, g = tile_bdfac, n_bdfac // tile_bdfac
    band = torch.zeros(g, g, dtype=torch.bool)
    for i in range(g):
        band[i, i] = True
        if i + 1 < g:
            band[i, i + 1] = True
    mask = band.repeat_interleave(t, 0).repeat_interleave(t, 1).to("cuda")
    x_f = float(torch.linalg.norm(x.double()))
    off = float(bd.masked_fill(mask, 0.0).abs().max())
    t0 = time.perf_counter()
    sv = torch.linalg.svdvals(bd.double())
    sv_ref = torch.linalg.svdvals(x.double())
    sv_err = float((sv - sv_ref).abs().max())
    sv_s = time.perf_counter() - t0
    emit({"phase": "P15", "program": "bdfac", "n": n_bdfac, "tile": tile_bdfac,
          "nodes": prog.num_nodes, "groups": groups, "seconds": dev_s, "host_seconds": host_s,
          "off_bidiagonal_max_over_fro": off / x_f, "sv_err_over_max": sv_err / float(sv_ref[0]),
          "svdvals_seconds": sv_s})
    require(off <= 1e-4 * x_f, f"P15 bdfac: off-bidiagonal {off} > 1e-4 * {x_f}")
    require(sv_err <= 1e-4 * float(sv_ref[0]), f"P15 bdfac: singular values off by {sv_err}")
    del x, prog, bmat, bd, mask
    torch.cuda.empty_cache()


def p16_host_tier(torch, npw, gen, n: int, n_local: int):
    """executor="spill" on a host-tier cholesky; executor="local" with
    faults and duplicate deliveries."""
    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.runtime.executor import LocalExecutor, SpillTaskExecutor

    a = spd_flat(torch, gen, n)
    x_host = shard_matrix(a, tile=(1024, 1024), storage="host")
    prog, o, _ = npw.cholesky(x_host, storage="host")
    ex = SpillTaskExecutor(prog)
    _, host_s, dev_s = run_entry(torch, ex.run)
    l = o.to_hbm().array[:n, :n]
    resid = residual(torch, a, l)
    emit({"phase": "P16", "program": "cholesky", "executor": "spill", "n": n, "tile": 1024,
          "nodes": prog.num_nodes, "seconds": dev_s, "host_seconds": host_s,
          "h2d_bytes": ex.h2d_bytes, "d2h_bytes": ex.d2h_bytes, "residual": resid})
    require(resid <= RESID_BAR, f"P16 spill cholesky: residual {resid}")
    del a, x_host, prog, o, l
    torch.cuda.empty_cache()

    a = spd_flat(torch, gen, n_local)
    prog, o, _ = npw.cholesky(shard_matrix(a, tile=(256, 256), storage="host"), storage="host")
    ex = LocalExecutor(prog, fault_rate=0.1, duplicate_rate=0.1, seed=0)
    t0 = time.perf_counter()
    status = ex.run(timeout=300)
    host_s = time.perf_counter() - t0
    resid = residual(torch, a, o.to_hbm().array[:n_local, :n_local])
    emit({"phase": "P16", "program": "cholesky", "executor": "local", "n": n_local, "tile": 256,
          "nodes": prog.num_nodes, "fault_rate": 0.1, "duplicate_rate": 0.1,
          "status": status.name, "host_seconds": host_s, "residual": resid})
    require(status.name == "SUCCESS", f"P16 local: status {status.name}")
    require(resid <= RESID_BAR, f"P16 local cholesky: residual {resid}")


# ---------------------------------------------------------------------------
# P17: the out-of-core Cholesky (runtime/spill.py)
# ---------------------------------------------------------------------------

SPILL_TILE = 512
SPILL_PANEL_TILES = 4  # W = 2048
SPILL_RANK = 2048


def spill_operand(torch, n: int, seed: int):
    """A = X Xᵀ/k + 2I on the card, X (n x k, k = SPILL_RANK) ~ N(0,1) from a
    seeded CUDA generator: SPD with eigenvalues in [2, ~2 + (sqrt(n/k) + 1)²],
    made in one GEMM of 2n²k flops."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, SPILL_RANK, generator=gen, device="cuda")
    a = x @ x.T
    a.mul_(1.0 / SPILL_RANK).diagonal().add_(2.0)
    return a


def spill_memory_bound(n_pad: int, tile: int, panel_tiles: int, width: int, planes: int,
                       cache_bytes: int = 0) -> int:
    """Device bytes out_of_core_cholesky may add (its docstring): 2 * width
    panel buffers of (n_pad + W) x W fp32, two strips of n_pad x W, the
    GEMM's packed bf16 planes 2 * planes * (n_pad + W) * W bytes,
    cache_bytes, and 16 W² bytes for the W x W factor's workspace."""
    w = panel_tiles * tile
    return (2 * width * (n_pad + w) * w * 4 + 2 * n_pad * w * 4
            + 2 * planes * (n_pad + w) * w + cache_bytes + 16 * w * w)


class SpillTraffic:
    """An on_event hook of out_of_core_cholesky counting the host <-> device
    bytes each event implies from the shapes: an upload moves panel s's
    real tiles, a strip load panel q's rows of the panel being updated, a
    download panel s's real rows."""

    def __init__(self, g: int, tile: int, panel_tiles: int):
        self.g, self.t, self.pt = g, tile, panel_tiles
        self.h2d = self.d2h = self.strip_bytes = 0
        self.counts = {}
        self.current = 0  # the panel whose updates run (main-thread events only)

    def _panel_bytes(self, s: int) -> int:
        c0 = s * self.pt
        return (self.g - c0) * min(self.pt, self.g - c0) * self.t * self.t * 4

    def __call__(self, kind: str, s: int) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if kind == "upload":
            self.h2d += self._panel_bytes(s)
        elif kind == "download":
            self.d2h += self._panel_bytes(s)
        elif kind == "factor":
            self.current = s + 1
        elif kind == "strip_load":
            rows_t = self.g - self.current * self.pt
            nbytes = rows_t * min(self.pt, self.g - s * self.pt) * self.t * self.t * 4
            self.h2d += nbytes
            self.strip_bytes += nbytes


def host_tiles_to_card(torch, m, n: int):
    """The host-tier matrix `m` as one (n, n) tensor on the card (tiles that
    do not exist read as zeros)."""
    t = m.tile[0]
    out = torch.zeros(m.padded_shape, device="cuda")
    for (i, j) in m.block_idxs_exist:
        out[i * t:(i + 1) * t, j * t:(j + 1) * t].copy_(m.get_block(i, j), non_blocking=True)
    torch.cuda.synchronize()
    return out[:n, :n]


def lower_residual(torch, a, l, block: int = 4096) -> float:
    """||A - L Lᵀ||_F / ||A||_F in fp64 on the card, for symmetric A and
    lower L, over the lower block triangle: a diagonal block counts once, a
    block below it twice (its mirror)."""
    n = a.shape[0]
    num = den = 0.0
    for j0 in range(0, n, block):
        j1 = min(n, j0 + block)
        r = a[j0:, j0:j1].double()
        for k0 in range(0, j1, block):
            k1 = min(j1, k0 + block)
            r -= l[j0:, k0:k1].double() @ l[j0:j1, k0:k1].double().T
        a64 = a[j0:, j0:j1].double()
        w = j1 - j0
        num += float((r[:w] ** 2).sum()) + 2 * float((r[w:] ** 2).sum())
        den += float((a64[:w] ** 2).sum()) + 2 * float((a64[w:] ** 2).sum())
        del r, a64
    return (num / den) ** 0.5


def meminfo() -> dict:
    """The host's RAM from /proc/meminfo, in GiB."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) / 2 ** 20
    return out


def link_yardstick(torch, nbytes: int = 512 << 20) -> dict:
    """GB/s of one plain pinned copy of `nbytes` each way (CUDA events,
    the mean of three after a warm-up)."""
    host = torch.empty(nbytes // 4, pin_memory=True)
    dev = torch.empty(nbytes // 4, device="cuda")
    h2d = cuda_ms(torch, lambda: dev.copy_(host, non_blocking=True), 1)
    h2d = cuda_ms(torch, lambda: dev.copy_(host, non_blocking=True), 3)
    d2h = cuda_ms(torch, lambda: host.copy_(dev, non_blocking=True), 1)
    d2h = cuda_ms(torch, lambda: host.copy_(dev, non_blocking=True), 3)
    return {"bytes": nbytes, "h2d_GBps": nbytes / h2d / 1e6, "d2h_GBps": nbytes / d2h / 1e6}


def writeback_host_cost(torch, rows: int, w: int = SPILL_PANEL_TILES * SPILL_TILE) -> dict:
    """Host seconds of one writeback's host side at `rows` x W (1 MiB
    tiles), each on fresh host memory: put_block of each tile from a pinned
    panel (a fresh pinned tile a call, tiled.py) against what the writer of
    runtime/spill.py does: one pinned slab of tiles, adopted tile by tile
    (the device-to-host copy into it not counted)."""
    from numpywren_tpu_torch.runtime.spill import _panel_to_host
    from numpywren_tpu_torch.tiled import TiledMatrix

    t = SPILL_TILE
    src = torch.randn(rows, w).pin_memory()
    m = TiledMatrix(shape=(rows, w), tile=(t, t), storage="host", device="cuda")
    t0 = time.perf_counter()
    _panel_to_host(m, src, 0, 0)
    put_s = time.perf_counter() - t0
    m = TiledMatrix(shape=(rows, w), tile=(t, t), storage="host", device="cuda")
    t0 = time.perf_counter()
    slab = torch.empty((rows // t, w // t, t, t), pin_memory=True)
    for i in range(rows // t):
        for j in range(w // t):
            m.adopt_block(slab[i, j], i, j)
    slab_s = time.perf_counter() - t0
    return {"rows": rows, "w": w, "bytes": rows * w * 4, "put_block_seconds": put_s,
            "slab_adopt_seconds": slab_s}


def spill_kernel_check(torch, gen, n: int, card: str) -> list:
    """matmul3 and matmul at the spill path's tallest update (n x W strip,
    W x W top, out = the n x W panel) against their plain versions, timed in
    turns with the library's addmm."""
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()
    w = SPILL_PANEL_TILES * SPILL_TILE
    strip = torch.randn(n, w, generator=gen, device="cuda")
    panel = torch.randn(n, w, generator=gen, device="cuda")
    top = strip[:w]
    rows = []
    flops, nbytes = 2 * n * w * w, 4 * (n * w + w * w + 2 * n * w)
    lib = lambda: torch.addmm(panel, strip, top.T, alpha=-1.0)  # noqa: E731
    for name, planes, run, plain in (
        ("matmul3", 2, lambda: gemm3.matmul3(strip, top, panel, tb=True),
         lambda: gemm3.matmul3_ref(strip, top, panel, tb=True)),
        ("matmul", 3, lambda: gemm.matmul(strip, top, panel, tb=True, alpha=-1.0, beta=1.0,
                                          precision="highest"),
         lambda: gemm.matmul_ref(strip, top, panel, tb=True, alpha=-1.0, beta=1.0)),
    ):
        row = _check(f"P17 {name}:spill_update", run(), plain())
        ms, plain_ms, lib_ms = in_turns(torch, run, plain, lib, iters=5)
        b_ms, b_by = bound(planes * (planes + 1) // 2 * flops, nbytes, PEAK_BF16)
        row.update(kernel=name, shape=[n, w, w], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, nvidia_smi=card)
        emit({"phase": "P17", **row})
        rows.append(row)
    return rows


def spill_profile(torch, run) -> dict:
    """`run()` (one out-of-core Cholesky) under torch.profiler: the device
    ms of each group of activities as the union of its intervals (copies
    host to device and device to host; kernels: the GEMM kernels'
    gemm_split_* launches, cholesky_ex's potrf, solve_triangular's trsm,
    the rest), the span from the first device activity to the last, and
    the shares of the span with no upload and with no kernel running.
    Never fatal: a session that recorded no copy says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    keys = (("h2d", ("HtoD",)), ("d2h", ("DtoH",)), ("gemm", ("gemm_split",)),
            ("cholesky_ex", ("potrf", "getrf")), ("solve_triangular", ("trsm",)))
    groups = {g: [] for g, _ in keys}
    groups["other"] = []
    for e in acts:
        g = next((g for g, ks in keys if any(k in e.name for k in ks)), "other")
        groups[g].append((e.time_range.start, e.time_range.end))

    def union(iv):
        total, end = 0.0, None
        for a, b in sorted(iv):
            if end is None or a > end:
                total, end = total + (b - a), b
            elif b > end:
                total, end = total + (b - end), b
        return total / 1e3

    if not groups["h2d"]:
        return {"profile": "not measured (no copy recorded)", "activities": len(acts)}
    span = (max(e.time_range.end for e in acts) - min(e.time_range.start for e in acts)) / 1e3
    kernels = [iv for g in ("gemm", "cholesky_ex", "solve_triangular", "other")
               for iv in groups[g]]
    return {"span_ms": span, "ms": {g: union(iv) for g, iv in groups.items()},
            "count": {g: len(iv) for g, iv in groups.items()},
            "upload_idle_share": 1 - union(groups["h2d"]) / span,
            "kernel_idle_share": 1 - union(kernels) / span}


def p17_spill(torch, npw, n: int, n_small: int, seed: int):
    """The out-of-core Cholesky (runtime/spill.py), compensated, tile 512,
    W = 2048, cache_bytes 0: N = n through cholesky + run_program with the
    device budget lowered so that _run_fused_cholesky takes its spill
    branch, then N = n_small called directly at pipeline_width 1 and 2 by
    shape_mode exact and pow2 in turns, once at "highest", and a checkpoint
    run continued to the uninterrupted factor bit for bit. Returns the
    (matmul, matmul3) calls of the driven path and the kernel checks."""
    import tempfile

    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.ops import gemm3
    from numpywren_tpu_torch.runtime import spill

    gemm = gemm_module()
    t0_phase = time.perf_counter()
    card = gpu_line()
    t, pt = SPILL_TILE, SPILL_PANEL_TILES
    cfg = npw.default_config()
    launches = {"matmul": 0, "matmul3": 0}
    kernel_rows = spill_kernel_check(torch, torch.Generator(device="cuda").manual_seed(seed), n,
                                     card)
    emit({"phase": "P17", "link": link_yardstick(torch), "nvidia_smi": card,
          "writeback_host": writeback_host_cost(torch, 8192), "meminfo_GiB": meminfo()})

    def reset():
        gemm.LAUNCHES = gemm.DEVICE_LAUNCHES = 0
        gemm3.LAUNCHES = gemm3.DEVICE_LAUNCHES = 0

    def drive(label, a, run, n_, width, mode, planes):
        """Run `run(traffic)` (which returns L), check and report it."""
        g = n_ // t
        traffic = SpillTraffic(g, t, pt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset()
        l, host_s, dev_s = run_entry(torch, lambda: run(traffic))
        c = {"matmul": gemm.LAUNCHES, "matmul3": gemm3.LAUNCHES}
        device_launches = gemm.DEVICE_LAUNCHES + gemm3.DEVICE_LAUNCHES
        growth = torch.cuda.max_memory_allocated() - before
        limit = spill_memory_bound(n_, t, pt, width, planes)
        n_panels = -(-g // pt)
        updates = n_panels * (n_panels - 1) // 2
        kern = "matmul3" if planes == 2 else "matmul"
        stats = l.spill_stats
        l_dev = host_tiles_to_card(torch, l, n_)
        resid = lower_residual(torch, a, l_dev)
        row = {"phase": "P17", "run": label, "n": n_, "tile": t, "w": pt * t,
               "pipeline_width": width, "shape_mode": mode, "seconds": dev_s,
               "host_seconds": host_s, "tflops": n_ ** 3 / 3 / dev_s / 1e12,
               "residual": resid, "l_storage": l.storage, "spill_stats": stats,
               "events": traffic.counts, "h2d_bytes": traffic.h2d, "d2h_bytes": traffic.d2h,
               "strip_bytes": traffic.strip_bytes, "h2d_GBps": traffic.h2d / dev_s / 1e9,
               "d2h_GBps": traffic.d2h / dev_s / 1e9, "launches": c,
               "device_launches": device_launches, "memory_growth": growth,
               "memory_bound": limit, "nvidia_smi": card}
        emit(row)
        require(l.storage == "host", f"P17 {label}: L on the {l.storage} tier")
        require(resid <= RESID_BAR, f"P17 {label}: residual {resid} > {RESID_BAR}")
        require(growth <= limit, f"P17 {label}: device memory grew {growth} B > bound {limit}")
        require(c[kern] == updates and device_launches == 3 * updates,
                f"P17 {label}: {kern} calls {c}, device launches {device_launches}, "
                f"{updates} updates")
        require(stats["host_strip_loads"] == traffic.counts.get("strip_load", 0)
                and stats["panels"] == n_panels, f"P17 {label}: spill_stats {stats}")
        launches[kern] += c[kern]
        return l_dev, row

    # warm-up: streams, pinned pools, the solver's handles
    cfg.compensated = True
    a = spill_operand(torch, 4096, seed)
    spill.out_of_core_cholesky(shard_matrix(a, tile=(t, t), storage="host", symmetric=True),
                               panel_tiles=pt, cache_bytes=0)
    del a

    # N = n through the DSL entry point: the spill branch of _run_fused_cholesky
    t0 = time.perf_counter()
    a = spill_operand(torch, n, seed)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    x_host = shard_matrix(a, tile=(t, t), storage="host", symmetric=True)
    shard_s = time.perf_counter() - t0 - gen_s
    prog, o, _ = npw.cholesky(x_host, storage="host")
    bind_s = time.perf_counter() - t0 - gen_s - shard_s
    emit({"phase": "P17", "operand": n, "seed": seed, "generate_seconds": gen_s,
          "shard_seconds": shard_s, "bind_seconds": bind_s, "meminfo_GiB": meminfo()})
    budget, orig = cfg.hbm_budget_bytes, spill.out_of_core_cholesky
    calls = []

    def run_dsl(traffic):
        def traced(m, **kw):  # the branch's call, with the byte counter
            calls.append(tuple(m.shape))
            return orig(m, on_event=traffic, **kw)

        spill.out_of_core_cholesky = traced
        try:
            require(npw.run_program(prog).name == "SUCCESS", "P17: run_program failed")
        finally:
            spill.out_of_core_cholesky = orig
        return o

    cfg.hbm_budget_bytes = 3 * n * n * 4 // 2  # under the fused path's three copies
    try:
        _, row = drive("run_program", a, run_dsl, n, cfg.pipeline_width, "pow2", 2)
    finally:
        cfg.hbm_budget_bytes = budget
    require(calls == [(n, n)], f"P17: the spill branch ran {calls}")
    del a, x_host, prog, o
    torch.cuda.empty_cache()

    def direct_run(x, **kw):
        x.load_count = 0  # host_strip_loads counts from here
        return spill.out_of_core_cholesky(x, panel_tiles=pt, cache_bytes=0, **kw)

    # N = n_small called directly: width 1 and 2, exact and pow2, in turns
    a = spill_operand(torch, n_small, seed + 1)
    x_host = shard_matrix(a, tile=(t, t), storage="host", symmetric=True)
    direct = {}
    for width, mode in ((2, "pow2"), (1, "pow2"), (2, "exact"), (1, "exact"),
                        (1, "exact"), (2, "exact"), (1, "pow2"), (2, "pow2")):
        label = f"w{width}_{mode}"
        _, row = drive(label, a, lambda tr: direct_run(
            x_host, pipeline_width=width, shape_mode=mode, on_event=tr), n_small, width, mode, 2)
        direct.setdefault(label, []).append(row["seconds"])
    prof = spill_profile(torch, lambda: direct_run(x_host))
    emit({"phase": "P17", "run": "profile", "n": n_small, "pipeline_width": cfg.pipeline_width,
          "shape_mode": "pow2", **prof, "nvidia_smi": card})
    cfg.compensated = False
    l_hi, _ = drive("highest", a, lambda tr: direct_run(x_host, precision="highest",
                                                       on_event=tr),
                    n_small, cfg.pipeline_width, "pow2", 3)
    del l_hi
    cfg.compensated = True

    # a checkpoint run: two panels, then continued; the factor is the
    # uninterrupted one's, bit for bit
    whole = spill.out_of_core_cholesky(x_host, panel_tiles=pt, cache_bytes=0)
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        first = spill.out_of_core_cholesky(x_host, panel_tiles=pt, checkpoint_dir=ck,
                                           stop_panels=2)
        rest = spill.out_of_core_cholesky(x_host, panel_tiles=pt, checkpoint_dir=ck)
        ck_s = time.perf_counter() - t0
        done = spill.SpillCheckpoint(ck).completed()
    same = all(torch.equal(rest.get_block(i, j), whole.get_block(i, j))
               for (i, j) in whole.block_idxs_exist)
    emit({"phase": "P17", "run": "checkpoint", "n": n_small, "stop_panels": 2,
          "first_panels": first.spill_stats["panels"], "rest_panels": rest.spill_stats["panels"],
          "panels_done": done, "bitwise_equal": same, "host_seconds": ck_s, "nvidia_smi": card})
    require(same and set(rest.block_idxs_exist) == set(whole.block_idxs_exist),
            "P17 checkpoint: the continued factor differs from the uninterrupted one")
    require(first.spill_stats["panels"] == 2 and done == -(-n_small // t // pt),
            f"P17 checkpoint: {first.spill_stats}, manifest {done}")
    cfg.compensated = False
    del a, x_host, whole, first, rest
    torch.cuda.empty_cache()
    emit({"phase": "P17", "seconds_by_run": direct, "seconds": time.perf_counter() - t0_phase,
          "meminfo_GiB": meminfo(), "nvidia_smi": card})
    return launches, kernel_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32768, help="trapezoid phases' size")
    ap.add_argument("--n-flat", type=int, default=16384, help="P5's size")
    ap.add_argument("--m", type=int, default=1 << 20, help="P7-P9's TSQR rows")
    ap.add_argument("--m-small", type=int, default=65536, help="P10-P11's TSQR rows")
    ap.add_argument("--n-gemm", type=int, default=8192, help="P12's size")
    ap.add_argument("--m-qr", type=int, default=1 << 18, help="P14's operand rows")
    ap.add_argument("--n-dsl", type=int, default=16384, help="P15-P16's DSL cholesky size")
    ap.add_argument("--n-gemm-dsl", type=int, default=8192, help="P15's DSL gemm size")
    ap.add_argument("--m-tsqr-dsl", type=int, default=65536, help="P15's DSL tsqr rows")
    ap.add_argument("--n-bdfac", type=int, default=8192, help="P15's DSL bdfac size")
    ap.add_argument("--tile-bdfac", type=int, default=1024, help="P15's DSL bdfac tile")
    ap.add_argument("--n-local", type=int, default=2048, help="P16's local-executor size")
    ap.add_argument("--n-spill", type=int, default=65536, help="P17's run_program size")
    ap.add_argument("--n-spill-small", type=int, default=32768, help="P17's direct runs' size")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.n % PANEL:
        raise SmokeFailure(f"--n must be a multiple of {PANEL}")
    if args.n_spill % SPILL_TILE or args.n_spill_small % SPILL_TILE:
        raise SmokeFailure(f"--n-spill and --n-spill-small must be multiples of {SPILL_TILE}")

    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this script measures the port on a GPU")
    try:
        import numpywren_tpu_torch as npw
    except ImportError as e:
        raise SmokeFailure(f"the port is not importable beside this script: {e}") from e
    from numpywren_tpu_torch.ops import _build

    # P0: the card and the kernel build
    t_run = time.perf_counter()
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
    p6 = p6_factor(torch, gen)
    ops_counts = p6_ops_path(torch, gen)
    p7 = p7_chain(torch, gen, args.m)
    tsqr_counts = tsqr_phases(torch, npw, gen, args.m, args.m_small)
    launches["matmul3"] += p12_gemm(torch, npw, gen, args.n_gemm)
    p13 = p13_qr(torch, gen)
    launches["qr"] = p14_qr_leaf(torch, gen, args.m_qr)
    p15_generic(torch, npw, gen, args.n_dsl, args.n_gemm_dsl, args.m_tsqr_dsl, args.n_bdfac,
                args.tile_bdfac)
    p16_host_tier(torch, npw, gen, args.n_dsl, args.n_local)
    spill_launches, _ = p17_spill(torch, npw, args.n_spill, args.n_spill_small, args.seed)
    for name in ("matmul", "matmul3"):
        launches[name] += spill_launches[name]
    launches["matmul"] += ops_counts["matmul"]
    launches.update(potrf=ops_counts["potrf"], trtri=ops_counts["trtri"], **tsqr_counts)

    require("jax" not in sys.modules, "jax was imported")
    require("numpywren_tpu" not in sys.modules, "the JAX package was imported")
    kernels = []
    for name, src, replaces in (
        ("matmul", "numpywren_tpu_torch/csrc/gemm_split.cu", "numpywren_tpu/ops/gemm.py:145"),
        ("matmul3", "numpywren_tpu_torch/csrc/gemm_split.cu", "numpywren_tpu/ops/gemm3.py:120"),
    ):
        main_case = p1[name][0]  # the trailing update, 31744x1024 by 1024x1024
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in p1[name]),
                        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                        "library_ms": main_case["torch_ms"]})
    for name, n, src, replaces in (
        ("potrf", 1024, "potrf.cu", "numpywren_tpu/ops/pallas_factor.py:180"),
        ("potrf_inv", 512, "potrf.cu + numpywren_tpu_torch/csrc/trtri.cu",
         "numpywren_tpu/ops/pallas_factor.py:189"),
        ("trtri", 1024, "trtri.cu", "numpywren_tpu/ops/pallas_factor.py:199"),
    ):
        row = p6[(name, n)]
        kernels.append({"name": name, "route": "cuda", "source": f"numpywren_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"] for (k, _), r in p6.items()
                                           if k == name),
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    chain = p7[False]  # the columns form at 1,048,576 x 256 (P9's shape)
    kernels.append({"name": "cholqr2_chain", "route": "cuda",
                    "source": "numpywren_tpu_torch/csrc/cholqr_chain.cu + gemm_split.cu + "
                              "potrf.cu + trtri.cu + gemm.cu",
                    "replaces": "numpywren_tpu/ops/pallas_factor.py:544",
                    "launches": launches["cholqr2_chain"],
                    "max_abs_err": max(r["max_abs_err"] for r in p7.values()),
                    "ms": chain["ms"], "plain_ms": chain["plain_ms"],
                    "bound_ms": chain["bound_ms"], "bound_by": chain["bound_by"],
                    "library_ms": None})
    qr_main = p13["2048x128"]  # P14's leaf
    kernels.append({"name": "qr", "route": "cuda", "source": "numpywren_tpu_torch/csrc/qr.cu",
                    "replaces": "numpywren_tpu/ops/pallas_factor.py:389",
                    "launches": launches["qr"],
                    "max_abs_err": max(r["max_abs_err"] for c, r in p13.items()
                                       if not c.startswith("kappa")),
                    "ms": qr_main["ms"], "plain_ms": qr_main["plain_ms"],
                    "bound_ms": qr_main["bound_ms"], "bound_by": qr_main["bound_by"],
                    "library_ms": qr_main["library_ms"]})
    for k in kernels:
        require(k["launches"] > 0, f"kernel {k['name']} was not launched on its path")
    emit({"phase": "total", "seconds": time.perf_counter() - t_run})
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
