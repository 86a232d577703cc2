#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from numpywren_tpu_torch/csrc, checks each
against its plain PyTorch version at its path's shapes, then drives the
user entry points (operands made on the card from seeded generators):
blocked Cholesky at N=32768 (P2-P5), the factor ops (P6), TSQR at
BASELINE config 3's 1,048,576 x 512 and beside it (P8-P11), GEMM at 8192
(P12), the QR kernel and ops.qr_leaf (P13-P14), the generic DSL
executors on both storage tiers (P15-P16), the out-of-core Cholesky
(P17), the models (P18), the fused BDFAC with the two-stage SVD on it
(P19), the QDWH route with the out-of-core BDFAC (P20), the
multi-device layer (P21), the aux modules, metrics and the command
line (P22), and the benchmark harness, bench_torch.py (P23):

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
      8192/1024 (P19's BDFAC bars, bdfac_quality); device seconds and
      groups
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
  P18 the models (numpywren_tpu_torch/models) through their entry points,
      each call run twice (the first counting its host synchronizations
      under torch.cuda's sync debug mode, the second timed) with the
      launch counters set to 0 before each run: least_squares on
      1,048,576 x 512 (kappa 10, 4 right-hand sides with a 10% residual)
      by "qr" on the library route, compensated (matmul3) and under
      NPW_PALLAS_FACTOR (potrf_inv), by "normal", and ridge_regression
      (alpha 1e-3), each within 1e-4 of an fp64 solve on the card;
      matmul3 at that route's apply shape (1,048,576 x 512 by 512ᵀ, no c)
      vs matmul3_ref (<= 1e-5) and _matmul_split_ref (<= 1e-6), timed
      beside torch.matmul and its bound;
      least_squares and svd_tall at 1,048,576 x 256 under NPW_PALLAS_CHAIN
      (the chain) against the library route (x <= 1e-5, s <= 3e-5
      relative); pca "auto" (tall) on that operand and "randomized" on
      65,536 x 4,096 (rank 64, sigma_i = exp(-i/32)), the leading 10
      explained variances within 2e-2 and 1e-1 of fp64 svdvals on the
      card; svd_jacobi at n = 4096, block 512, on a Gaussian and a
      kappa 1e4 logspace matrix (reconstruction < 1e-4, both
      orthogonalities < 1e-5, sigma within rtol 2e-3 / atol 1e-4 s_max of
      fp64: tests/test_jacobi.py's _check), its sweeps and off-norms;
      torch.profiler splits, each in a new process, of one sweep (also as
      eigh, products and the rest) and of one library least_squares call:
      the device's busy ms (the union of its activities' intervals) and
      the idle share against the call's CUDA-event ms (busy <= call
      required), and the device ms by top-level aten op (their sum <= the
      busy ms required); svd(method="jacobi")
      on 65,536 x 1,024 (the same bars); matmul3, potrf_inv and the chain
      must launch
  P19 the fused BDFAC (compiler/lower.py's fused_bdfac) and the two-stage
      SVD on it, each call run twice (host synchronizations counted, then
      timed) with the launch counters set to 0 before each run: at
      n = 8192 (P15's size, a Gaussian from --seed) through bdfac +
      run_program ("auto" runs it fused) at tile 1024, at tile 512 by
      default, compensated (matmul3), "highest" (fused_bdfac direct: the
      matmul kernel) and Householder panels (NPW_BDFAC_PANEL), at tile 256
      by the library, NPW_PALLAS_CHAIN (the chain, both forms) and
      NPW_PALLAS_FACTOR (potrf_inv): off-bidiagonal blocks <= 1e-4 ||X||_F,
      max sigma error <= 1e-4 sigma_max against fp64 svdvals(X) (taken once;
      sigma(B) from fp64 eigvalsh(BᵀB)),
      | ||B||_F - ||X||_F | <= 1e-3 ||X||_F; one compensated tile-512 sweep
      under torch.profiler in a new process (busy ms as the union of the
      device's intervals, idle share, device ms under the chains and the
      products, the library factor kernels by name); every sweep's chains
      and their extras passes, counted in compiler/lower.py's
      _cholqr_adaptive (CHAIN_PASSES; 2g - 2 chains for g panels
      required), beside its host synchronizations; kappa 1e6 logspace at
      4096, tile 256, library and chain routes; singular_values at 4096,
      tile 512, and at 2560 with the default tile (tile=None: 128 where no
      LAPACK library is found and n > 2048, else 512): the tile and the
      finishes that ran (band_reduce + dgbbrd, the dense host gesdd, or
      the shuffled Golub-Kahan eigensolve), seconds of stage 1, the chase
      and the host finish, max |s - s_ref| <= 1e-4 s_max; the chase
      on that band (the tightened B of stage 1) timed apart, its hops, the
      reduced band's sigma in fp64 within 1e-4 s_max; svd(method="bdfac") at
      2048, tile 512, refine 0 and 2, and svd(x) (method None routes to
      "bdfac" on the card): tests/test_models.py's _check_svd bars; then
      matmul3 at the tile-512 sweep's first QR and LQ updates, matmul at
      svd's first accumulator update, potrf_inv at the tile-256 Gram and
      the chain at 8192 x 256 and 256 x 7936, each against its plain
      versions (KERNEL_BAR; matmul3 also SPLIT_BAR against
      _matmul_split_ref; the chain P7's bars at BDFAC's conv_tol 1e-5),
      timed in turns with its library call
  P20 the QDWH route (models/qdwh.py) and the out-of-core BDFAC
      (runtime/spill.py's out_of_core_bdfac), each call run twice (host
      synchronizations, chains and extras passes counted, then timed) with
      the launch counters set to 0 before each run: svd(method="qdwh") on
      P18's n = 4096 Gaussian Jacobi operand (beside its Jacobi seconds)
      and on P19's n = 8192 X, singular_values(finish="qdwh") on that X,
      and svd(uv_finish="device") on P19's svd operand (n = 2048, tile
      512, beside its host-finish seconds): device seconds, the QR,
      Cholesky and extra Halley steps, matmul launches, seconds of the
      polar decomposition, eigh and the rest (CUDA events), sigma within
      1e-4 sigma_max, reconstruction < 1e-4, max |UᵀU - I|, |VVᵀ - I|
      < 5e-4 (P19's svd bars), each also reported against the reference
      tests' 1e-5; then out_of_core_bdfac of host tiers of P19's X at
      tile 512, W = 2048, by default, compensated and "highest", and at
      tile 256, W = 256, under NPW_PALLAS_CHAIN and NPW_PALLAS_FACTOR:
      sigma(B) within 1e-4 sigma_max of P19's (sigma_by_gram),
      | ||B||_F - ||X||_F | <= 1e-3 ||X||_F, B zero below its diagonal and
      past 2W - 1 (<= 1e-5 ||X||_F), H2D and D2H bytes (from the loop's
      shapes) and GB/s beside one pinned 512 MiB copy each way, device
      memory growth within ooc_bdfac_memory_bound; out_of_core_singular_values
      at tile 128, W = 128, where the host has a LAPACK library; a 4 GiB
      host tier at --n-ooc (32768), compensated, W = 2048, held by
      ||B||_F and ||BᵀB||_F against X's (fp64 on the card, within 1e-3)
      and its band, then profiled in a new process (spill_profile); then
      matmul at QDWH's Gram and QR-step shapes at n = 8192 and matmul3 at
      the --n-ooc run's first apply, against their plain versions
      (KERNEL_BAR; SPLIT_BAR and KERNEL_BAR against _matmul_split_ref),
      timed in turns with their library call
  P21 the multi-device layer (numpywren_tpu_torch.parallel), compensated,
      after a warm-up at small sizes: (a) a 1-rank group joined by
      distributed.initialize() through the NPW_* variables (NCCL), a 1 x 1
      mesh: sharded_cholesky at --n (32768) tile 1024 (beside P2's
      seconds), sharded_gemm at --n-gemm (8192) compensated and "highest",
      sharded_tsqr with Q on --m x 512 (tile_rows 4096), summa_gemm and
      summa_syrk ("highest", a 1024-wide panel) at --n-gemm: each case's
      seconds and the matmul3 / matmul launches; (b) four processes on the
      one card (a gloo group: NCCL refuses two ranks on one card), a 2 x 2
      mesh, the same calls with the Cholesky at P21B_N_CHOL (16384); each
      result gathered by all_reduce and held on rank 0 to the bars below
      and to the 1-rank results of the same calls on a mesh of rank 0
      alone (the GEMMs within 1e-5, the factor within 1e-4, R within
      3e-5); TSQR's orthogonality and residual summed over the ranks'
      rows; every rank must launch matmul3 and matmul and import no jax.
      Then the fabric's calls (parallel.fabric, runtime.spill): in (a)
      cholesky_2d at --n panel 1024 with lookahead on and off, cholesky_1d,
      cholqr3s_sharded with Q on --m x 512, cholqr2_sharded with Q on
      65,536 x 256, tsqr_butterfly on --m x 512 and
      out_of_core_cholesky(mesh=) on a host tier of A (tile 512, W =
      2048), each twice in a row (both times reported), then matmul3 at
      cholesky_2d's first bulk update ((n - 1024)² by K = 1024, c a view)
      against matmul3_ref and _matmul_split_ref, timed in turns with
      addmm; in (b) the three Cholesky forms and the mesh out-of-core
      Cholesky at P21B_N_CHOL and cholqr3s_sharded with Q on a kappa = 1e6
      65,536 x 256 panel, whose chains and extras passes rank 0 requires
      equal on every rank, each held on rank 0 to the same call on a
      1-rank mesh (the factors within 1e-4, R within 3e-5). The factors'
      residuals <= 1e-4, Q's orthogonality and residual the TSQR bars (the
      kappa panel's residual <= 3e-5, P21_KAPPA_RESID_BAR), R within 3e-5
      of the library's QR (cholqr3s_sharded's within 1e-4, its chain's
      convergence target, and within 3e-5 of the single-device chain's);
      each card rank requires matmul3 launched by every Cholesky form, the
      mesh out-of-core Cholesky and the compensated cholqr3s apply.
      Then the distributed BDFAC: in (a) bdfac_1d and bdfac_2d (lookahead
      on and off, and at "highest") on P19's X at tile 512 and
      out_of_core_bdfac(mesh=) on P20's --n-ooc Gaussian tier (tile 512,
      W = 2048), each twice, held by P19's BDFAC bars and P20's
      invariants; bdfac_2d's time split in a new process
      (fresh_bdfac_profile); matmul3 at bdfac_2d's first bulk update
      (n x (n - 512) less n x 512 by 512 x (n - 512)) against matmul3_ref
      and _matmul_split_ref, timed in turns with addmm; in (b) bdfac_1d,
      bdfac_2d and the mesh out-of-core BDFAC of P19's X,
      singular_values(mesh=) at P21_SV_N, tile 256, on the 2 x 2 mesh
      (bdfac_2d) and a 1 x 4 one (bdfac_1d), and the dry run
      (parallel.dryrun, its ten stages); every rank's results the same
      (fingerprints), held on rank 0 to the 1-rank call (sigma within
      1e-4 sigma_max; B within 1e-4, P21_BDFAC_B_BAR, by b_agreement:
      B up to Yamamoto signs and its last block column's orthogonal
      factors) and to the bars above; each card
      rank requires matmul3 launched by the three BDFAC forms, (a) matmul
      by the "highest" call.
      Part (b)'s times are four processes time-sharing one card: no
      scaling claim is made from them
  P22 the aux modules (numpywren_tpu_torch.metrics, .cli, .__main__):
      `python -m numpywren_tpu_torch info` (the card's name and count,
      its total memory, default_mesh = _factor_2d(count)); cli.main
      (["doctor"]) in process (four "ok" lines; its kernel check one
      matmul call, three device launches) and `python -m ... doctor`;
      metrics.trace around one compensated cholesky_trapezoid at --n in a
      new process (one trace file naming the split mainloop and
      cholesky_ex's kernels; matmul3's calls as panel_route_counts);
      FlopMeter against cuda_ms of 20 matmul3 calls at 8192³, in turns
      (within 10%), then around the same Cholesky beside P2's TFLOP/s;
      level_report and log_program of a fault-free "local" Cholesky at
      --n-local, tile 256 (a record and an npw-step line a level, the ops
      summing to the nodes, the flops to node_flops, wall_s on each)
  P23 the benchmark harness, bench_torch.py, as a user runs it: `python -m
      numpywren_tpu_torch bench ...` in a new process a run, its last good
      line in a temporary directory (the checkout is not written), every
      JSON line parsed: (a) the flagship under NPW_COMPENSATED=1, the quick
      N=32768 stage then N=65536 (the blockwise operand) in one run, the
      32768 TFLOP/s within 5% of P2's; (b) N=32768 at the default "high"
      and at "highest", within 5% of P4's and P3's (or, where the phase's
      single reading came out low, of the best of three runs of that
      phase's factorization in a new process); every Cholesky line's
      full residual <= 1e-4 and 0 < frac_of_matmul_peak <= 1.05; (c) GEMM 8192
      at the default and compensated, beside P12's; (d) TSQR cholqr3s
      1,048,576 x 512, its Gram parity <= 1e-4 (the chain's convergence
      target); (e) BDFAC 8192/512 beside P19's tile-512 seconds; (f)
      --numerics, the full kappa ladder, every rung passing. Each line's
      route and its kernels' launches (matmul3, matmul) as the route
      implies; then matmul3's panel route at the 65536 stage's first
      trailing updates (64,512 x 1024) against the per-call route, bit for
      bit, and matmul3_ref

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
import math
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


def union_ms(intervals) -> float:
    """The time, in ms, that at least one of the (start, end) µs intervals
    covers: a set of device activities' busy time, overlaps counted once."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + (b - a), b
        elif b > end:
            total, end = total + (b - end), b
    return total / 1e3


def in_new_process(phase: str, func: str, *args):
    """chip_smoke.<func>(torch, *args) in a process of its own, whose
    profiler has recorded nothing before: a process's later profiler
    sessions can lose device records (P6's sessions in one full run, the
    second form's in a short one), a first session in a new process has
    not. The arguments and the result pass as JSON."""
    code = ("import json, sys, torch, chip_smoke; print(json.dumps(getattr("
            "chip_smoke, sys.argv[1])(torch, *json.loads(sys.argv[2]))))")
    proc = subprocess.run([sys.executable, "-c", code, func, json.dumps(args)],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=300)
    require(proc.returncode == 0, f"{phase} {func} process: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


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


def matmul3_panel_rows(torch, gen, r: int, w: int = 1024, phase: str = "P1"):
    """The Cholesky's panel route at the trailing update: one pack of an
    r x w panel b (gemm3.Panel), then c - b[off:] b[off:off + w]ᵀ for
    off = 0 (the trailing update's shape) and off = w, each against the
    per-call matmul3 on the same inputs, bit for bit (the same planes and
    mainloop). Times the pack, the update alone and the per-call route,
    in turns (CUDA events). Rows are emitted under `phase`."""
    from numpywren_tpu_torch.ops import gemm3

    def counts():
        return gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES

    b = torch.randn(r, w, generator=gen, device="cuda")
    calls, device = counts()
    panel = gemm3.Panel(b)
    require(counts() == (calls, device + 1), f"{phase} matmul3 panel: the pack counted {counts()}")
    pack_ms = in_turns(torch, lambda: gemm3.Panel(b))[0]
    rows = []
    for off in (0, w):
        c = torch.randn(r - off, w, generator=gen, device="cuda")
        calls, device = counts()
        got = panel.sub_update(c, off, w)
        require(counts() == (calls + 1, device + 1),
                f"{phase} matmul3 panel: an update counted {counts()} after {(calls, device)}")
        per_call = gemm3.matmul3(b[off:], b[off:off + w], c, tb=True)
        torch.cuda.synchronize()
        require(torch.equal(got, per_call),
                f"{phase} matmul3 panel off={off}: differs from the per-call route")
        row = _check(f"matmul3:panel_off{off}", got, gemm3.matmul3_ref(b[off:], b[off:off + w],
                                                                       c, tb=True))
        ms, per_call_ms = in_turns(torch, lambda: panel.sub_update(c, off, w, out=c),
                                   lambda: gemm3.matmul3(b[off:], b[off:off + w], c, tb=True))
        m = r - off
        row.update(shape=[m, w, w], bitwise_equal_per_call=True, update_ms=ms,
                   per_call_ms=per_call_ms, pack_ms=pack_ms,
                   update_bf16_tflops=3 * 2 * m * w * w / ms / 1e9)
        emit({"phase": phase, **row})
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
        busy = union_ms((e.time_range.start, e.time_range.end) for e in kernels)
        window = (max(e.time_range.end for e in kernels) - kernels[0].time_range.start) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        row.update(device_ms=groups, window_ms=window, busy_ms=busy,
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
    the process that calls it (P7 runs it in_new_process)."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    p = kappa_panel(torch, torch.Generator(device="cuda").manual_seed(0), m, b, 10.0)
    if rows:
        p = p.T.contiguous()
    g = p @ p.T if rows else p.T @ p
    kw = chain_kw(m, b, bool(rows))
    return chain_split(torch, lambda: pf.cholqr2_chain_pallas(g, p, **kw), want)


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
        prof = in_new_process("P7", "fresh_chain_split", m, b, int(rows), want)
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
    """GEMM through gemm + run_program at both configurations, warm, then
    measured. Returns matmul3's launches and the measured TFLOP/s by
    configuration."""
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()

    cfg = npw.default_config()
    a = torch.randn(n, n, generator=gen, device="cuda")
    b = torch.randn(n, n, generator=gen, device="cuda")
    exact = a.double() @ b.double()
    matmul3_launches, tflops = 0, {}
    for i, comp in enumerate((False, True, False, True)):  # warm, then measured
        cfg.compensated = comp
        gemm.LAUNCHES = gemm3.LAUNCHES = 0
        prog, c, _ = npw.gemm(a, b, tile=(512, 512))
        _, host_s, dev_s = run_entry(torch, lambda: npw.run_program(prog))
        counts = {"matmul": gemm.LAUNCHES, "matmul3": gemm3.LAUNCHES}
        err = rel_err(torch, c.array[:n, :n], exact)
        require(err <= KERNEL_BAR, f"P12 compensated={comp}: rel error {err} > {KERNEL_BAR}")
        require((counts["matmul3"] > 0) == comp, f"P12 compensated={comp}: launches {counts}")
        config = "compensated" if comp else "default"
        tflops[config] = 2 * n ** 3 / dev_s / 1e12
        emit({"phase": "P12", "n": n, "tile": 512, "config": config, "seconds": dev_s,
              "host_seconds": host_s, "tflops": tflops[config], "rel_err_vs_fp64": err,
              "launches": counts, "warmup": i < 2})
        matmul3_launches = counts["matmul3"]
        del prog, c
    cfg.compensated = False
    return matmul3_launches, tflops


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
    x_f = float(torch.linalg.norm(x.double()))
    t0 = time.perf_counter()
    sv_ref = sigma64(torch, x)
    ref_s = time.perf_counter() - t0
    q = bdfac_quality(torch, x, bmat.array[:n_bdfac, :n_bdfac], tile_bdfac, sv_ref, x_f)
    emit({"phase": "P15", "program": "bdfac", "n": n_bdfac, "tile": tile_bdfac,
          "nodes": prog.num_nodes, "groups": groups, "seconds": dev_s, "host_seconds": host_s,
          **q, "sv_ref_seconds": ref_s})
    require_bdfac("P15 bdfac", q)
    del x, prog, bmat
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

    if not groups["h2d"]:
        return {"profile": "not measured (no copy recorded)", "activities": len(acts)}
    span = (max(e.time_range.end for e in acts) - min(e.time_range.start for e in acts)) / 1e3
    kernels = [iv for g in ("gemm", "cholesky_ex", "solve_triangular", "other")
               for iv in groups[g]]
    return {"span_ms": span, "ms": {g: union_ms(iv) for g, iv in groups.items()},
            "count": {g: len(iv) for g, iv in groups.items()},
            "upload_idle_share": 1 - union_ms(groups["h2d"]) / span,
            "kernel_idle_share": 1 - union_ms(kernels) / span}


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


# ---------------------------------------------------------------------------
# P18: the models (numpywren_tpu_torch/models) on the card
# ---------------------------------------------------------------------------

LSTSQ_BAR = 1e-4      # x against an fp64 solve on the card
CHAIN_X_BAR = 1e-5    # the chain route's x against the library route's
PCA_TALL_BAR = 2e-2   # explained variance, tests/test_models.py's pca bars
PCA_RANDOMIZED_BAR = 1e-1
JACOBI_RECON_BAR = 1e-4  # tests/test_jacobi.py's _check
JACOBI_ORTHO_BAR = 1e-5
JACOBI_S_RTOL, JACOBI_S_ATOL = 2e-3, 1e-4
JACOBI_BLOCK = 512    # svd_jacobi's default (measured on a TPU v5e)


def host_syncs(torch, fn):
    """(fn(), the synchronizing CUDA calls it made): torch.cuda's sync debug
    mode warns at each one (an item(), a D2H copy, a library call that
    checks its status on the host)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


PATH_KERNELS = ("matmul", "matmul3", "potrf_inv", "cholqr2_chain")


def reset_launch_counts() -> None:
    """The launch counters of the kernels on P18's and P19's paths, set to 0."""
    from numpywren_tpu_torch.ops import gemm3
    from numpywren_tpu_torch.ops import pallas_factor as pf

    gemm_module().LAUNCHES = 0
    gemm3.LAUNCHES = 0
    pf.reset_launches()


def launch_counts() -> dict:
    from numpywren_tpu_torch.ops import gemm3
    from numpywren_tpu_torch.ops import pallas_factor as pf

    return {"matmul": gemm_module().LAUNCHES, "matmul3": gemm3.LAUNCHES,
            "potrf_inv": pf.LAUNCHES["potrf_inv"], "cholqr2_chain": pf.LAUNCHES["cholqr2_chain"]}


def model_call(torch, fn, flags=(), compensated=False, env=None):
    """fn() twice with the opt-in `flags`, NpwConfig.compensated and the
    extra environment `env` set: the first run counts its host
    synchronizations, the second is timed (run_entry). The launch counters
    are set to 0 before each run and read after it. Returns (the second
    run's result, its row: seconds, host seconds, the first run's seconds,
    syncs, launches, and the CholeskyQR chains and their extras passes of
    the first run with the syncs they leave unexplained: each chain reads
    the host once, each extras pass once)."""
    from numpywren_tpu_torch import config
    from numpywren_tpu_torch.compiler import lower

    cfg = config.default_config()
    cfg.compensated = compensated
    set_flags(flags)
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        reset_launch_counts()
        lower.reset_chain_passes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, syncs = host_syncs(torch, fn)
        first_s = time.perf_counter() - t0
        chains, extras = lower.CHAIN_PASSES["chains"], lower.CHAIN_PASSES["extras"]
        reset_launch_counts()
        out, host_s, dev_s = run_entry(torch, fn)
        launches = launch_counts()
    finally:
        cfg.compensated = False
        set_flags()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out, {"seconds": dev_s, "host_seconds": host_s, "first_seconds": first_s,
                 "host_syncs": syncs, "chains": chains, "extras_passes": extras,
                 "syncs_outside_chains": syncs - chains - extras,
                 "launches": launches, "flags": list(flags),
                 "compensated": compensated, "env": env or {}}


def regression_rhs(torch, gen, a, k: int = 4, tan_theta: float = 0.1):
    """k right-hand sides b = A x_true + noise, ||noise||_F = tan_theta
    ||A x_true||_F: a regression with a 10% residual. The fp32 sensitivity
    of any least-squares solver is ~(kappa + kappa² tan_theta) u, 2e-6 at
    kappa 10; a pure-noise b at 1,048,576 rows has tan_theta ~64 and
    puts it near 3e-4, above the bar for every fp32 route."""
    ax = a @ torch.randn(a.shape[1], k, generator=gen, device="cuda")
    noise = torch.randn(a.shape[0], k, generator=gen, device="cuda")
    return ax + noise * (tan_theta * torch.linalg.norm(ax) / torch.linalg.norm(noise))


def gram64(torch, a, b=None, chunk: int = 1 << 17):
    """aᵀa (or aᵀb) in fp64, by row chunks."""
    out = None
    for i0 in range(0, a.shape[0], chunk):
        ac = a[i0:i0 + chunk].double()
        part = ac.T @ (ac if b is None else b[i0:i0 + chunk].double())
        out = part if out is None else out + part
    return out


def solve64(torch, g, rhs):
    l = torch.linalg.cholesky(g)
    return torch.cholesky_solve(rhs, l)


def sigma64(torch, x):
    """Singular values of x by fp64 svdvals on the card (of R for a tall x),
    descending, by cuSOLVER's gesvd (QR iterations: 2.8 s at 8192², where
    svdvals' default method takes 8.9)."""
    x64 = x.double()
    if x.shape[0] > 2 * x.shape[1]:
        x64 = torch.linalg.qr(x64, mode="r").R
    return torch.linalg.svdvals(x64, driver="gesvd")


def svd_quality(torch, x, u, s, vt, s_ref, chunk: int = 1 << 14) -> dict:
    """tests/test_jacobi.py's _check as numbers, in fp64 on the card:
    reconstruction, both orthogonalities, sigma's error against s_ref."""
    u, s, vt = (torch.as_tensor(t, device="cuda").double() for t in (u, s, vt))
    k = s.shape[0]
    num = den = 0.0
    for i0 in range(0, x.shape[0], chunk):
        xc = x[i0:i0 + chunk].double()
        d = (u[i0:i0 + chunk] * s) @ vt - xc
        num += float((d * d).sum())
        den += float((xc * xc).sum())
    eye = torch.eye(k, dtype=torch.float64, device="cuda")
    s_err = (s - s_ref).abs()
    return {"recon": (num / den) ** 0.5,
            "ortho_u": float(torch.linalg.norm(u.T @ u - eye)) / k ** 0.5,
            "ortho_v": float(torch.linalg.norm(vt @ vt.T - eye)) / k ** 0.5,
            "descending": bool((s[1:] - s[:-1] <= 1e-6 * s[0]).all()),
            "s_max_abs_err_rel": float(s_err.max() / s_ref[0]),
            "s_within": bool((s_err <= JACOBI_S_RTOL * s_ref + JACOBI_S_ATOL * s_ref[0]).all())}


def require_svd(phase: str, q: dict) -> None:
    require(q["recon"] < JACOBI_RECON_BAR, f"{phase}: reconstruction {q['recon']}")
    require(q["ortho_u"] < JACOBI_ORTHO_BAR and q["ortho_v"] < JACOBI_ORTHO_BAR,
            f"{phase}: orthogonality {q['ortho_u']}, {q['ortho_v']}")
    require(q["descending"] and q["s_within"],
            f"{phase}: sigma off fp64 svdvals ({q['s_max_abs_err_rel']} of s_max)")


def matmul3_apply_check(torch, a, g64) -> dict:
    """matmul3 at the compensated least-squares route's shape: every launch
    there is _cholqr_adaptive's apply Q = A L⁻ᵀ, (m, b) by (b, b)ᵀ with no
    c (its folds of R are torch.matmul). A is the route's operand, L⁻¹ the
    inverse of its Gram's Cholesky factor; the kernel against matmul3_ref
    (<= 1e-5) and _matmul_split_ref at two planes (<= 1e-6); kernel, plain
    version and torch.matmul timed in turns, beside the bound (three bf16
    products)."""
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()
    b = a.shape[1]
    eye = torch.eye(b, device="cuda")
    linv = torch.linalg.solve_triangular(torch.linalg.cholesky(g64).float(), eye, upper=False)
    run = lambda: gemm3.matmul3(a, linv, tb=True)  # noqa: E731
    plain = lambda: gemm3.matmul3_ref(a, linv, tb=True)  # noqa: E731
    row = _check("P18 matmul3:apply", run(), plain())
    row["rel_err_split_ref"] = _check("P18 matmul3:apply vs split", run(),
                                      gemm._matmul_split_ref(a, linv, tb=True, planes=2),
                                      SPLIT_BAR)["rel_err"]
    ms, plain_ms, library_ms = in_turns(torch, run, plain, lambda: a @ linv.T)
    m = a.shape[0]
    b_ms, b_by = bound(3 * 2 * m * b * b, 4 * (2 * m * b + b * b), PEAK_BF16)
    return {"model": "matmul3_apply", **row, "shape": [m, b, b], "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def profile_call(torch, fn, sessions: int = 3) -> dict:
    """One warm fn() under torch.profiler: the device's busy ms (the union
    of its activities' intervals: kernels, copies, sets), the call's ms by
    CUDA events, the idle share 1 - busy / call, and the device ms of each
    top-level aten op (its kernels' and its children's, summed by name;
    the profiler's own spans are left out). One stream's activities do not
    overlap, so the ops' sum is at most the busy time: more would be a
    double count, and the caller fails on it. A session that records no
    device activity is taken again."""
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
        events = prof.events()
        acts = [e for e in events if e.device_type == DeviceType.CUDA]
        if acts:
            break
    by_op = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.cpu_parent is None and e.name.startswith("aten::"):
            us = getattr(e, "device_time_total", None)
            us = e.cuda_time_total if us is None else us
            if us:
                by_op[e.name] = by_op.get(e.name, 0.0) + us / 1e3
    call_ms = start.elapsed_time(end)
    busy = union_ms((e.time_range.start, e.time_range.end) for e in acts)
    return {"device_ms_by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
            "ops_ms": sum(by_op.values()), "call_ms": call_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / call_ms, "activities": len(acts),
            "profile_sessions": attempt}


def fresh_model_profile(torch, kind: str, *dims: int) -> dict:
    """profile_call of one model step in the process that calls it (P18
    runs it in_new_process): "jacobi_sweep" n block (one sweep of
    svd_jacobi on a Gaussian n x n, also split into eigh, products (bmm,
    matmul, mm) and the rest) or "least_squares" m b (the library route on
    a kappa 10 m x b operand, 4 right-hand sides)."""
    from numpywren_tpu_torch import models
    from numpywren_tpu_torch.models.jacobi import _sweep, _sweep_setup

    gen = torch.Generator(device="cuda").manual_seed(0)
    if kind == "jacobi_sweep":
        n, block = dims
        x = torch.randn(n, n, generator=gen, device="cuda")
        w, v, perms, g, b, skip = _sweep_setup(x, block)
        row = profile_call(torch, lambda: _sweep(w, v, perms, g=g, b=b, skip_rel=skip))
        split = {"eigh": 0.0, "products": 0.0, "rest": 0.0}
        for name, ms in row["device_ms_by_op"].items():
            part = ("eigh" if "eigh" in name else
                    "products" if name in ("aten::bmm", "aten::matmul", "aten::mm") else "rest")
            split[part] += ms
        return {"kind": kind, "n": n, "block": block, "rounds": g - 1, "eighs_per_round": g // 2,
                "device_ms_by_part": split, **row}
    m, b = dims
    a = kappa_panel(torch, gen, m, b, 10.0)
    rhs = regression_rhs(torch, gen, a)
    return {"kind": kind, "shape": [m, b],
            **profile_call(torch, lambda: models.least_squares(a, rhs))}


def p18_models(torch, gen, m: int, m_rand: int, n_rand: int, n_jac: int, m_jac: int,
               n_jac_tall: int, block: int = JACOBI_BLOCK):
    """The models through their entry points: least squares, ridge, svd_tall,
    PCA (tall and randomized), svd_jacobi and svd(method="jacobi").
    Returns the launches of matmul3, potrf_inv and the chain in the runs,
    and the Gaussian Jacobi run's operand, its sigma and its seconds."""
    from numpywren_tpu_torch import models

    card = gpu_line()
    launches = {"matmul3": 0, "potrf_inv": 0, "cholqr2_chain": 0}
    t_phase = time.perf_counter()

    def emit_row(row, counted=True):
        if counted:
            for k in launches:
                launches[k] += row.get("launches", {}).get(k, 0)
        emit({"phase": "P18", **row, "nvidia_smi": card})

    # least squares at BASELINE config 3's shape, kappa 10, 4 right-hand sides
    # with a 10% residual
    a = kappa_panel(torch, gen, m, 512, 10.0)
    rhs = regression_rhs(torch, gen, a)
    g64, atb64 = gram64(torch, a), gram64(torch, a, rhs)
    x64 = solve64(torch, g64, atb64)
    for label, method, flags, comp, need in (
            ("library", "qr", (), False, None),
            ("compensated", "qr", (), True, "matmul3"),
            ("potrf_inv", "qr", ("NPW_PALLAS_FACTOR",), False, "potrf_inv"),
            ("normal", "normal", (), False, None)):
        x, row = model_call(torch, lambda: models.least_squares(a, rhs, method=method),
                            flags, comp)
        err = rel_err(torch, torch.as_tensor(x, device="cuda"), x64)
        emit_row({"model": "least_squares", "route": label, "method": method,
                  "shape": [m, 512], "kappa": 10.0, "rhs": 4, "rel_err_vs_fp64": err, **row})
        require(err <= LSTSQ_BAR, f"P18 least_squares {label}: error {err} > {LSTSQ_BAR}")
        if need:
            require(row["launches"][need] > 0, f"P18 least_squares {label}: {row['launches']}")
    emit_row(matmul3_apply_check(torch, a, g64), counted=False)
    alpha = 1e-3
    x, row = model_call(torch, lambda: models.ridge_regression(a, rhs, alpha))
    xr64 = solve64(torch, g64 + alpha * torch.eye(512, dtype=torch.float64, device="cuda"),
                   atb64)
    err = rel_err(torch, torch.as_tensor(x, device="cuda"), xr64)
    emit_row({"model": "ridge_regression", "alpha": alpha, "shape": [m, 512],
              "rel_err_vs_fp64": err, **row})
    require(err <= LSTSQ_BAR, f"P18 ridge_regression: error {err} > {LSTSQ_BAR}")
    del a, rhs, g64, atb64

    # 1,048,576 x 256 under NPW_PALLAS_CHAIN=1 against the library route
    a = kappa_panel(torch, gen, m, 256, 10.0)
    rhs = regression_rhs(torch, gen, a)
    x64 = solve64(torch, gram64(torch, a), gram64(torch, a, rhs))
    outs = {}
    for label, flags in (("library", ()), ("chain", ("NPW_PALLAS_CHAIN",))):
        x, row = model_call(torch, lambda: models.least_squares(a, rhs), flags)
        err = rel_err(torch, torch.as_tensor(x, device="cuda"), x64)
        outs[label, "x"] = x
        emit_row({"model": "least_squares", "route": label, "shape": [m, 256],
                  "kappa": 10.0, "rhs": 4, "rel_err_vs_fp64": err, **row})
        require(err <= LSTSQ_BAR, f"P18 least_squares {label} at b=256: error {err}")
        (_, s, _), row = model_call(torch, lambda: models.svd_tall(a), flags)
        outs[label, "s"] = s
        emit_row({"model": "svd_tall", "route": label, "shape": [m, 256], **row})
        if flags:
            require(row["launches"]["cholqr2_chain"] > 0, f"P18 svd_tall chain: {row}")
    x_diff, s_diff = (rel_err(torch, *(torch.as_tensor(outs[r, k], device="cuda")
                                       for r in ("chain", "library"))) for k in ("x", "s"))
    emit_row({"model": "chain_vs_library", "shape": [m, 256], "x_rel_diff": x_diff,
              "s_rel_diff": s_diff}, counted=False)
    require(x_diff <= CHAIN_X_BAR, f"P18 chain route x differs {x_diff} > {CHAIN_X_BAR}")
    require(s_diff <= R_AGREE_BAR, f"P18 chain route s differs {s_diff} > {R_AGREE_BAR}")

    # PCA: "auto" takes the tall route at 256 features
    def pca_check(label, x, method, bar, k=64):
        (_, ev, _), row = model_call(torch, lambda: models.pca(x, k, method=method))
        xc = x.double() - x.double().mean(dim=0, keepdim=True)
        t0 = time.perf_counter()
        ev64 = sigma64(torch, xc)[:10] ** 2 / (x.shape[0] - 1)
        ref_s = time.perf_counter() - t0
        err = float(((torch.as_tensor(ev[:10]).cuda().double() - ev64).abs() / ev64).max())
        emit_row({"model": "pca", "route": label, "method": method, "shape": list(x.shape),
                  "n_components": k, "ev_max_rel_err_top10": err, "bar": bar,
                  "fp64_reference_seconds": ref_s, **row})
        require(err <= bar, f"P18 pca {label}: explained variance error {err} > {bar}")

    pca_check("tall", a, "auto", PCA_TALL_BAR)
    del a, rhs
    q, _ = torch.linalg.qr(torch.randn(m_rand, n_rand, generator=gen, device="cuda"))
    vq, _ = torch.linalg.qr(torch.randn(n_rand, n_rand, generator=gen, device="cuda"))
    decay = torch.exp(-torch.arange(n_rand, device="cuda", dtype=torch.float32) / 32.0)
    x = (q * decay) @ vq.T
    del q, vq
    pca_check("randomized", x, "randomized", PCA_RANDOMIZED_BAR)
    del x

    # the block-Jacobi SVD at the reference's on-chip size; P20 takes the
    # Gaussian operand, its sigma and its seconds
    jacobi = {}
    for label, x in (("gaussian", torch.randn(n_jac, n_jac, generator=gen, device="cuda")),
                     ("kappa_1e4", kappa_panel(torch, gen, n_jac, n_jac, 1e4))):
        trace = []

        def run():
            trace.clear()  # the off-norm of each sweep of this run
            return models.svd_jacobi(x, block=block, _sweep_trace=trace)

        (u, s, vt), row = model_call(torch, run)
        s_ref = sigma64(torch, x)
        q = svd_quality(torch, x, u, s, vt, s_ref)
        emit_row({"model": "svd_jacobi", "matrix": label, "n": n_jac, "block": block,
                  "sweeps": len(trace), "off_norms": trace, **q, **row})
        require_svd(f"P18 svd_jacobi {label}", q)
        if label == "gaussian":
            jacobi = {"x": x, "sv_ref": s_ref, "seconds": row["seconds"]}
    for kind, dims in (("jacobi_sweep", (n_jac, block)), ("least_squares", (m, 512))):
        prof = in_new_process("P18", "fresh_model_profile", kind, *dims)
        emit_row({"model": "profile", **prof}, counted=False)
        require(0 < prof["device_busy_ms"] <= prof["call_ms"] and 0 <= prof["idle_share"] <= 1,
                f"P18 {kind} profile: busy {prof['device_busy_ms']} ms in a "
                f"{prof['call_ms']} ms call")
        require(prof["ops_ms"] <= prof["device_busy_ms"] * (1 + 1e-3),
                f"P18 {kind} profile: the ops' {prof['ops_ms']} ms exceed the busy "
                f"{prof['device_busy_ms']} ms: {prof['device_ms_by_op']}")
        require(prof.get("device_ms_by_part", {"eigh": 1.0})["eigh"] > 0,
                f"P18 {kind} profile: no device time under eigh: {prof['device_ms_by_op']}")

    x = torch.randn(m_jac, n_jac_tall, generator=gen, device="cuda")
    (u, s, vt), row = model_call(torch, lambda: models.svd(x, method="jacobi"))
    q = svd_quality(torch, x, u, s, vt, sigma64(torch, x))
    emit_row({"model": "svd", "method": "jacobi", "shape": [m_jac, n_jac_tall], **q, **row})
    require_svd("P18 svd(method='jacobi')", q)
    emit({"phase": "P18", "seconds": time.perf_counter() - t_phase, "launches": launches,
          "nvidia_smi": card})
    for k, n in launches.items():
        require(n > 0, f"P18: {k} was not launched on the models' path")
    return launches, jacobi


# ---------------------------------------------------------------------------
# P19: the fused BDFAC and the two-stage SVD on it
# ---------------------------------------------------------------------------

BDFAC_BAR = 1e-4      # off-bidiagonal blocks / ||X||_F; max sigma error / sigma_max
BDFAC_FRO_BAR = 1e-3  # | ||B||_F - ||X||_F | / ||X||_F (the sweeps are orthogonal)
SV_BAR = 1e-4         # singular_values: max |s - s_ref| / s_ref[0] (tests/test_band_reduce.py:75)
SVD_S_RTOL = 1e-3     # svd: tests/test_models.py's _check_svd
SVD_RECON_BAR = 1e-4
SVD_ORTHO_BAR = 5e-4


def sigma_by_gram(torch, b):
    """Singular values of b, descending, as the square roots of the
    eigenvalues of bᵀb in fp64 on the card (0.67 s at 8192, against
    svdvals' 8.9): an eigenvalue error of n eps64 ||b||² moves a sigma by
    at most sqrt(n eps64) sigma_max, 1e-6 of sigma_max at 8192, a
    hundredth of the BDFAC bar."""
    b64 = b.double()
    return torch.linalg.eigvalsh(b64.T @ b64).clamp_min(0.0).sqrt().flip(0)


def bdfac_quality(torch, x, bd, tile: int, sv_ref, x_f: float) -> dict:
    """The BDFAC bars' numbers for B = bd of x, in fp64 on the card: the
    largest entry off the diagonal and superdiagonal tile blocks over
    ||X||_F, max |sigma(B) - sigma(X)| over sigma_max (sv_ref: sigma64
    of X, taken once per input) and | ||B||_F - ||X||_F | over ||X||_F,
    sigma(B) by sigma_by_gram."""
    n = x.shape[0]
    g = n // tile
    d = torch.arange(g)[None, :] - torch.arange(g)[:, None]
    band = (d == 0) | (d == 1)
    mask = band.repeat_interleave(tile, 0).repeat_interleave(tile, 1).to(bd.device)
    off = float(bd.masked_fill(mask, 0.0).abs().max())
    t0 = time.perf_counter()
    sv = sigma_by_gram(torch, bd)
    sv_err = float((sv - sv_ref).abs().max())
    sv_s = time.perf_counter() - t0
    b_f = float(torch.linalg.norm(bd.double()))
    return {"off_bidiagonal_max_over_fro": off / x_f, "sv_err_over_max": sv_err / float(sv_ref[0]),
            "fro_err_over_fro": abs(b_f - x_f) / x_f, "sigma_seconds": sv_s}


def require_bdfac(phase: str, q: dict, fro: bool = True) -> None:
    require(q["off_bidiagonal_max_over_fro"] <= BDFAC_BAR,
            f"{phase}: off-bidiagonal {q['off_bidiagonal_max_over_fro']} of ||X||_F")
    require(q["sv_err_over_max"] <= BDFAC_BAR,
            f"{phase}: singular values off by {q['sv_err_over_max']} of sigma_max")
    require(not fro or q["fro_err_over_fro"] <= BDFAC_FRO_BAR,
            f"{phase}: ||B||_F off ||X||_F by {q['fro_err_over_fro']}")


def require_chains(phase: str, n: int, tile: int, row: dict, cholqr: bool = True) -> None:
    """A CholeskyQR sweep of n x n at `tile` runs one chain a QR panel and
    one a LQ panel while two superdiagonal blocks remain: 2g - 2 for
    g = n / tile; a Householder sweep none."""
    want = 2 * (n // tile) - 2 if cholqr else 0
    require(row["chains"] == want, f"{phase}: {row['chains']} chains, {want} expected")


def fresh_bdfac_profile(torch, n: int, tile: int, form: str = "fused") -> dict:
    """One warm compensated BDFAC sweep of a Gaussian n x n (tile `tile`)
    under torch.profiler, in the process that calls it (P19 and P21 run it
    in_new_process): form "fused" is compiler.lower.fused_bdfac, "bdfac_2d"
    parallel.fabric.bdfac_2d on the 1 x 1 mesh of a 1-rank group. Busy ms
    as the union of the device's activity intervals and the idle share
    against the call's CUDA-event ms; the ms of the sweep's parts by CUDA
    events recorded around each call of _cholqr_adaptive (the chains, with
    their Grams, cholesky_ex, solve_triangular and host reads) and _matmul
    / _sub_matmul (the panel updates' products), each span its kernels and
    any idle between them, the rest of the call beside them; and the device
    ms of the kernels by name group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from numpywren_tpu_torch import config
    from numpywren_tpu_torch.compiler import lower
    from numpywren_tpu_torch.ops import _build

    _build.build()
    config.default_config().compensated = True
    x = torch.randn(n, n, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    if form == "fused":
        mod, call = lower, lambda: lower.fused_bdfac(x, tile)
    else:
        from numpywren_tpu_torch.parallel import distributed, fabric, make_mesh

        os.environ.update(NPW_COORDINATOR=f"127.0.0.1:{free_port()}", NPW_NUM_PROCESSES="1",
                          NPW_PROCESS_ID="0")
        distributed.initialize()
        mesh = make_mesh()
        mod, call = fabric, lambda: fabric.bdfac_2d(x, mesh, tile=tile)
    spans = {"chains": [], "products": []}
    for key, name in (("chains", "_cholqr_adaptive"), ("products", "_matmul"),
                      ("products", "_sub_matmul")):
        def timed(*a, _real=getattr(mod, name), _key=key, **kw):
            begin, end_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            begin.record()
            out = _real(*a, **kw)
            end_.record()
            spans[_key].append((begin, end_))
            return out
        setattr(mod, name, timed)

    call()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        for v in spans.values():
            v.clear()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
        acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if acts:
            break
    groups = (("cholesky_ex", ("getrf", "potrf")), ("solve_triangular", ("trsm",)),
              ("geqrf", ("geqrf", "geqr2", "larf", "orgqr")), ("split_kernels", ("gemm_split",)),
              ("cublas_fp32", ("gemm",)))
    by_kernel = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
    for e in acts:
        group = next((g for g, keys in groups if any(k in e.name for k in keys)), "other")
        by_kernel[group] += e.time_range.elapsed_us() / 1e3
    call_ms = start.elapsed_time(end)
    parts = {k: sum(b.elapsed_time(e) for b, e in v) for k, v in spans.items()}
    parts["rest"] = call_ms - parts["chains"] - parts["products"]
    busy = union_ms((e.time_range.start, e.time_range.end) for e in acts)
    if form != "fused":
        import torch.distributed as dist

        dist.destroy_process_group()
    return {"n": n, "tile": tile, "form": form, "config": "compensated", "call_ms": call_ms,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / call_ms,
            "ms_by_part": parts, "calls_by_part": {k: len(v) for k, v in spans.items()},
            "device_ms_by_kernel": by_kernel, "activities": len(acts),
            "profile_sessions": attempt}


def product_row(torch, phase: str, card: str, name: str, m: int, k: int, nn: int, run, plain,
                lib, split_ref, split_bar: float, planes: int, with_c: bool = True) -> dict:
    """One GEMM kernel call `run` (an m x k by k x nn product, with a c
    read when with_c) against its plain version (KERNEL_BAR) and its own
    split arithmetic (split_bar), timed in turns with the plain version and
    the library call `lib`, beside its bound at `planes` bf16 products;
    emitted under `phase` and returned."""
    row = _check(f"{name}", run(), plain())
    row["rel_err_split_ref"] = _check(f"{name} vs split", run(), split_ref(),
                                      split_bar)["rel_err"]
    ms, plain_ms, lib_ms = in_turns(torch, run, plain, lib, iters=5)
    flops, nbytes = 2 * m * nn * k, 4 * (m * k + k * nn + (2 if with_c else 1) * m * nn)
    b_ms, b_by = bound(planes * flops, nbytes, PEAK_BF16)
    row.update(kernel=name.split(":")[0], shape=[m, k, nn], ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    emit({"phase": phase, **row, "nvidia_smi": card})
    return row


def p19_kernel_checks(torch, gen, n: int, n_svd: int, card: str) -> list:
    """The kernels of P19's path at its shapes against their plain versions,
    timed in turns with their library call: matmul3 at the tile-512
    sweep's first QR update (n x 512 by 512 x (n - 512), c a view of the
    n² buffer) and its LQ mirror ((n - 512) x 512 by 512 x (n - 512)),
    also against _matmul_split_ref at two planes; matmul at svd's first
    accumulator update at n_svd (n_svd x 512 by 512 x n_svd, in place),
    also against _matmul_split_ref at three planes; potrf_inv at the tile-256
    shifted Gram; the chain at n x 256 (columns) and 256 x (n - 256)
    (rows) against cholqr2_chain_ref and its steps."""
    from numpywren_tpu_torch.compiler import lower
    from numpywren_tpu_torch.ops import gemm3
    from numpywren_tpu_torch.ops import pallas_factor as pf

    gemm = gemm_module()
    rows = []

    def product(*args):
        rows.append(product_row(torch, "P19", card, *args))

    buf = torch.randn(n, n, generator=gen, device="cuda")
    t = 512
    for case, a, b, c in (
            ("qr_update", torch.randn(n, t, generator=gen, device="cuda"),
             torch.randn(t, n - t, generator=gen, device="cuda"), buf[:, t:]),
            ("lq_update", torch.randn(n - t, t, generator=gen, device="cuda"),
             torch.randn(t, n - t, generator=gen, device="cuda"), buf[t:, t:])):
        m, nn = c.shape
        product(f"matmul3:{case}", m, t, nn,
                lambda: gemm3.matmul3(a, b, c), lambda: gemm3.matmul3_ref(a, b, c),
                lambda: torch.addmm(c, a, b, alpha=-1.0),
                lambda: gemm._matmul_split_ref(a, b, c, alpha=-1.0, beta=1.0, planes=2),
                SPLIT_BAR, 3)
    del buf
    acc = torch.randn(n_svd, n_svd, generator=gen, device="cuda")
    xv = torch.randn(n_svd, t, generator=gen, device="cuda")
    rhs = torch.randn(t, n_svd, generator=gen, device="cuda")
    product("matmul:accumulator_update", n_svd, t, n_svd,
            lambda: gemm.matmul(xv, rhs, acc, alpha=-1.0, beta=1.0, precision="highest"),
            lambda: gemm.matmul_ref(xv, rhs, acc, alpha=-1.0, beta=1.0),
            lambda: torch.addmm(acc, xv, rhs, alpha=-1.0),
            lambda: gemm._matmul_split_ref(xv, rhs, acc, alpha=-1.0, beta=1.0, planes=3),
            KERNEL_BAR, 6)
    del acc, xv, rhs

    # potrf_inv at the tile-256 chain's shifted Gram (its factoring pass)
    b = 256
    p = torch.randn(n, b, generator=gen, device="cuda")
    g = p.T @ p
    shift = 4.0 * 2.0 ** -23 * (n * b) ** 0.5 * float(g.abs().sum(dim=1).max())
    gs = g + shift * torch.eye(b, device="cuda")
    eye = torch.eye(b, device="cuda")
    got, want = pf.potrf_inv_pallas(gs), pf.potrf_inv_ref(gs)
    errs = [rel_err(torch, x, y) for x, y in zip(got, want)]
    require(max(errs) <= KERNEL_BAR and all(bool(torch.isfinite(x).all()) for x in got),
            f"P19 potrf_inv:{b}: rel error {errs}")

    def lib():
        lo = torch.linalg.cholesky_ex(gs)[0]
        return lo, torch.linalg.solve_triangular(lo, eye, upper=False)

    ms, plain_ms, lib_ms = in_turns(torch, lambda: pf.potrf_inv_pallas(gs),
                                    lambda: pf.potrf_inv_ref(gs), lib, iters=5)
    b_ms, b_by = bound(2 * b ** 3 / 3, 12 * b * b, PEAK_FP32)
    row = {"case": f"potrf_inv:{b}", "kernel": "potrf_inv", "n": b, "rel_err": max(errs),
           "max_abs_err": max(float((x - y).abs().max()) for x, y in zip(got, want)),
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "P19", **row, "nvidia_smi": card})
    rows.append(row)

    # the chain at the tile-256 sweep's first panels, BDFAC's conv_tol 1e-5
    for form, pp in (("cols", p), ("rows", torch.randn(b, n - b, generator=gen, device="cuda"))):
        is_rows = form == "rows"
        m = pp.shape[1] if is_rows else pp.shape[0]
        gg = pp @ pp.T if is_rows else pp.T @ pp
        kw = dict(rows=is_rows, shift_c=4.0 * 2.0 ** -23 * (m * b) ** 0.5,
                  conv_gate=min(2.0 * 1e-5 ** 0.5, 1e-1))
        q, total, conv, dev2 = pf.cholqr2_chain_pallas(gg, pp, **kw)
        row = {"case": f"chain:{form}", "kernel": "cholqr2_chain", "shape": list(pp.shape)}
        for name, plain in (("plain", pf.cholqr2_chain_ref), ("steps", pf._cholqr2_chain_steps_ref)):
            qr_, tr, convr, _ = plain(gg, pp, **kw)
            qerr = float((q - qr_).abs().max())
            require(qerr <= CHAIN_Q_BAR and rel_err(torch, total, tr) <= KERNEL_BAR
                    and bool(conv) == bool(convr),
                    f"P19 chain:{form}: q {qerr}, total {rel_err(torch, total, tr)} vs {name}")
            if name == "steps":
                require(rel_err(torch, q, qr_) <= KERNEL_BAR, f"P19 chain:{form}: q vs its steps")
            row[f"max_abs_err_vs_{name}"] = qerr
        row["max_abs_err"] = max(row["max_abs_err_vs_plain"], row["max_abs_err_vs_steps"])
        ms, plain_ms, lib_ms = in_turns(
            torch, lambda: pf.cholqr2_chain_pallas(gg, pp, **kw),
            lambda: pf.cholqr2_chain_ref(gg, pp, **kw),
            lambda: lower._cholqr_adaptive(pp, rows=is_rows, max_passes=2, conv_tol=1e-5),
            iters=5)
        small = 2 * b ** 3 / 3 + 7 * 2 * b ** 3
        b_ms, b_by = max(((6 * 2 * m * b * b / PEAK_BF16 + small / PEAK_FP32) * 1e3,
                          "operations"), (4 * (2 * m * b + 2 * b * b + 2) / PEAK_HBM * 1e3,
                                          "bytes"))
        row.update(dev2=float(dev2), conv=bool(conv), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        emit({"phase": "P19", **row, "nvidia_smi": card})
        rows.append(row)
    return rows


def svd_bars(torch, x, u, s, vt, s_ref) -> dict:
    """tests/test_models.py's _check_svd as numbers, in fp64 on the card:
    sigma within rtol 1e-3 / atol 1e-3 s_max, the reconstruction, and
    max |UᵀU - I|, max |V Vᵀ - I|."""
    u, s, vt = (torch.as_tensor(a, device="cuda").double() for a in (u, s, vt))
    x64 = x.double()
    k = s.shape[0]
    eye = torch.eye(k, dtype=torch.float64, device="cuda")
    s_err = (s - s_ref).abs()
    return {"recon": float(torch.linalg.norm((u * s) @ vt - x64) / torch.linalg.norm(x64)),
            "ortho_u_max": float((u.T @ u - eye).abs().max()),
            "ortho_v_max": float((vt @ vt.T - eye).abs().max()),
            "s_max_abs_err_rel": float(s_err.max() / s_ref[0]),
            "s_within": bool((s_err <= SVD_S_RTOL * s_ref + SVD_S_RTOL * s_ref[0]).all())}


def p19_bdfac(torch, npw, n: int, n_kappa: int, n_sv: int, n_svd: int, seed: int,
              n_sv_default: int = 2560):
    """The fused BDFAC and the two-stage SVD on it (see the module
    docstring). Returns the launches of matmul, matmul3, potrf_inv and the
    chain on the path, the kernel checks, and the operands P20 takes: the
    n x n Gaussian X with its fp64 sigma and norm, the svd operand with its
    sigma, and the host-finish svd's seconds; with them the tile-512
    sweeps' seconds by route, which P23 sets beside the bench's."""
    import numpy as np

    from numpywren_tpu_torch import models
    from numpywren_tpu_torch.compiler import lower
    from numpywren_tpu_torch.models import band, band_reduce
    from numpywren_tpu_torch.runtime.program import PS

    card = gpu_line()
    t_phase = time.perf_counter()
    launches = dict.fromkeys(PATH_KERNELS, 0)

    def emit_row(row):
        for k in launches:
            launches[k] += row.get("launches", {}).get(k, 0)
        emit({"phase": "P19", **row, "nvidia_smi": card})

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, n, generator=gen, device="cuda")
    x_f = float(torch.linalg.norm(x.double()))
    t0 = time.perf_counter()
    sv_ref = sigma64(torch, x)
    ref_s = time.perf_counter() - t0

    def through_program(tile):
        def run():
            prog, bmat, _ = npw.bdfac(x, tile=(tile, tile))
            status = npw.run_program(prog)
            require(status == PS.SUCCESS, f"P19 bdfac program: {status}")
            return bmat.array[:n, :n]
        return run

    runs = (  # (label, tile, drive, opt-in flags, compensated, env)
        ("auto", 1024, through_program(1024), (), False, None),
        ("default", 512, through_program(512), (), False, None),
        ("compensated", 512, through_program(512), (), True, None),
        ("highest", 512, lambda: lower.fused_bdfac(x, 512, precision="highest"), (), False,
         None),
        ("house", 512, through_program(512), (), False, {"NPW_BDFAC_PANEL": "house"}),
        ("library", 256, through_program(256), (), False, None),
        ("chain", 256, through_program(256), ("NPW_PALLAS_CHAIN",), False, None),
        ("potrf_inv", 256, through_program(256), ("NPW_PALLAS_FACTOR",), False, None),
    )
    need = {"compensated": "matmul3", "highest": "matmul", "chain": "cholqr2_chain",
            "potrf_inv": "potrf_inv"}
    tile512_seconds = {}
    for label, tile, drive, flags, comp, env in runs:
        bd, row = model_call(torch, drive, flags, comp, env)
        if tile == 512:
            tile512_seconds[label] = row["seconds"]
        q = bdfac_quality(torch, x, bd, tile, sv_ref, x_f)
        emit_row({"run": "bdfac", "route": label, "n": n, "tile": tile, **q, **row,
                  "sv_ref_seconds": ref_s})
        require_bdfac(f"P19 bdfac {label} tile {tile}", q)
        require_chains(f"P19 bdfac {label} tile {tile}", n, tile, row, label != "house")
        if label in need:
            require(row["launches"][need[label]] > 0, f"P19 bdfac {label}: {row['launches']}")
        del bd
    torch.cuda.empty_cache()

    prof = in_new_process("P19", "fresh_bdfac_profile", n, 512)
    emit({"phase": "P19", "run": "profile", **prof, "nvidia_smi": card})
    require(0 < prof["device_busy_ms"] <= prof["call_ms"] and 0 <= prof["idle_share"] <= 1,
            f"P19 profile: busy {prof['device_busy_ms']} ms in a {prof['call_ms']} ms call")
    require(prof["device_ms_by_kernel"]["split_kernels"] > 0 and min(prof["ms_by_part"].values()) > 0,
            f"P19 profile: {prof['device_ms_by_kernel']}, {prof['ms_by_part']}")

    # kappa 1e6 logspace at n_kappa, tile 256: the library route and the chain
    xk = kappa_panel(torch, gen, n_kappa, n_kappa, 1e6)
    xk_f = float(torch.linalg.norm(xk.double()))
    svk = sigma64(torch, xk)
    for label, flags in (("library", ()), ("chain", ("NPW_PALLAS_CHAIN",))):
        def drive():
            prog, bmat, _ = npw.bdfac(xk, tile=(256, 256))
            npw.run_program(prog)
            return bmat.array[:n_kappa, :n_kappa]

        bd, row = model_call(torch, drive, flags)
        q = bdfac_quality(torch, xk, bd, 256, svk, xk_f)
        emit_row({"run": "bdfac_kappa", "route": label, "n": n_kappa, "tile": 256,
                  "kappa": 1e6, **q, **row})
        require_bdfac(f"P19 bdfac kappa 1e6 {label}", q)
        require_chains(f"P19 bdfac kappa 1e6 {label}", n_kappa, 256, row)
        if flags:
            require(row["launches"]["cholqr2_chain"] > 0, f"P19 kappa chain: {row['launches']}")
        del bd
    del xk, svk

    # singular_values at n_sv_default with the default tile, then at n_sv
    # with tile 512, once each (their host finishes take seconds): stage 1,
    # the chase and the host finish timed apart, the tile and the finishes
    # that ran (a finish that raised, as LAPACK's where none is found, is
    # listed with "raised"). Without a LAPACK library the band of 512 goes to the dense host
    # gesdd, so the chase is then timed and checked apart on the same band
    # (the corner-tightened B of stage 1): sigma of the reduced band in
    # fp64 on the card against s_ref
    svd_mod = importlib.import_module("numpywren_tpu_torch.models.svd")  # the module, not svd()
    w = int(os.environ.get("NPW_BAND_REDUCE_W", "64"))

    def sv_entry(case, xs, ss_ref, **kw):
        """One singular_values(xs, **kw) call with its parts timed; emits its
        row, holds it to SV_BAR and returns stage 1's B."""
        stages = dict.fromkeys(("stage1", "chase", "host_finish"), 0.0)
        finishes, bds, tiles = [], [], []
        patched = ((lower, "fused_bdfac", "stage1"),
                   (band_reduce, "band_reduce_packed", "chase"),
                   (band, "band_sigma_packed", "host_finish"),
                   (band, "band_sigma_lapack", "host_finish"),
                   (svd_mod, "_gk_band_sigma", "host_finish"), (np.linalg, "svd", "host_finish"))
        reals = [getattr(mod, name) for mod, name, _ in patched]

        def timed(fn, key):
            def wrapper(*a, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                raised = True
                try:
                    out = fn(*a, **kwargs)
                    torch.cuda.synchronize()
                    raised = False
                finally:
                    stages[key] += time.perf_counter() - t
                    if key == "host_finish":
                        finishes.append(fn.__name__ + (" raised" if raised else ""))
                if key == "stage1":
                    bds.append(out)
                    tiles.append(kwargs.get("tile", a[1] if len(a) > 1 else None))
                return out
            return wrapper

        for (mod, name, key), real in zip(patched, reals):
            setattr(mod, name, timed(real, key))
        try:
            reset_launch_counts()
            s, host_s, dev_s = run_entry(torch, lambda: models.singular_values(xs, **kw))
            sv_launches = launch_counts()
        finally:
            for (mod, name, _), real in zip(patched, reals):
                setattr(mod, name, real)
        err = float((torch.as_tensor(np.ascontiguousarray(s), device="cuda") - ss_ref).abs().max()
                    / ss_ref[0])
        emit_row({"run": "singular_values", "case": case, "n": xs.shape[0],
                  "tile_arg": kw.get("tile"), "tile": tiles, "finishes": finishes,
                  "lapack": band.lapack_available(), "band_reduce_w": w,
                  "stage_seconds": stages, "seconds": dev_s, "host_seconds": host_s,
                  "launches": sv_launches, "s_max_abs_err_rel": err})
        require(err <= SV_BAR, f"P19 singular_values {case}: max |s - s_ref| {err} of s_max "
                f"> {SV_BAR}")
        return bds[-1]

    xd = torch.randn(n_sv_default, n_sv_default, generator=gen, device="cuda")
    sv_entry("default_tile", xd, sigma64(torch, xd))
    del xd
    xs = torch.randn(n_sv, n_sv, generator=gen, device="cuda")
    ss_ref = sigma64(torch, xs)
    bd_sv = sv_entry("tile_512", xs, ss_ref, tile=512)
    t0 = time.perf_counter()  # the host's gesdd on a Gaussian of the same size, in this process
    np.linalg.svd(np.random.default_rng(seed).standard_normal((n_sv, n_sv)), compute_uv=False)
    emit({"phase": "P19", "run": "host_gesdd_yardstick", "n": n_sv,
          "seconds": time.perf_counter() - t0, "nvidia_smi": card})

    bd = bd_sv.double().cpu().numpy()
    t = 512
    s2, d2 = svd_mod._tighten_corner_blocks(bd[-2 * t:-t, -t:], bd[-t:, -t:])
    bd[-2 * t:-t, -t:], bd[-t:, -t:] = s2, d2
    bd_card = torch.as_tensor(bd, dtype=torch.float32, device="cuda")
    del bd_sv, bd
    (ab, ku2, m), row = model_call(torch, lambda: band_reduce.band_reduce_packed(bd_card, t, w=w))
    dense = torch.zeros(m, m, dtype=torch.float64, device="cuda")
    ab_card = torch.as_tensor(ab, dtype=torch.float64, device="cuda")
    for r in range(ku2 + 1):
        dense.diagonal(ku2 - r)[:] = ab_card[r, ku2 - r:]
    sv_band = sigma_by_gram(torch, dense)[:n_sv]
    chase_err = float((sv_band - ss_ref).abs().max() / ss_ref[0])
    emit_row({"run": "band_reduce", "n": n_sv, "ku": t, "w": w, "ku2": ku2, "m": m,
              "hops": band_reduce.chase_hops(n_sv, t, w), "s_max_abs_err_rel": chase_err,
              **row})
    require(chase_err <= SV_BAR, f"P19 band_reduce: sigma off by {chase_err} of s_max")
    del xs, bd_card, dense, ab_card

    # svd(method="bdfac") at n_svd, tile 512, refine 0 and 2; then method=None
    xv = torch.randn(n_svd, n_svd, generator=gen, device="cuda")
    sv_svd = sigma64(torch, xv)
    calls = []
    svd_seconds = {}
    real_fb = lower.fused_bdfac
    lower.fused_bdfac = lambda *a, **kw: calls.append(kw.get("accumulate")) or real_fb(*a, **kw)
    try:
        for label, kw in (("refine_0", dict(method="bdfac", refine=0)),
                          ("refine_2", dict(method="bdfac", refine=2)), ("method_none", {})):
            (u, s, vt), row = model_call(
                torch, lambda: (calls.clear(), models.svd(xv, tile=512, **kw))[1])
            q = svd_bars(torch, xv, u, s, vt, sv_svd)
            svd_seconds[label] = row["seconds"]
            emit_row({"run": "svd", "case": label, "n": n_svd, "tile": 512,
                      "bdfac_calls": len(calls), **q, **row})
            require(q["recon"] < SVD_RECON_BAR and q["ortho_u_max"] < SVD_ORTHO_BAR
                    and q["ortho_v_max"] < SVD_ORTHO_BAR and q["s_within"],
                    f"P19 svd {label}: {q}")
            require(calls and all(calls), f"P19 svd {label}: the accumulating BDFAC did not run")
    finally:
        lower.fused_bdfac = real_fb
    del u, vt
    torch.cuda.empty_cache()

    checks = p19_kernel_checks(torch, gen, n, n_svd, card)
    emit({"phase": "P19", "seconds": time.perf_counter() - t_phase, "launches": launches,
          "nvidia_smi": card})
    for k, cnt in launches.items():
        require(cnt > 0, f"P19: {k} was not launched on the BDFAC path")
    operands = {"x": x, "sv_ref": sv_ref, "x_f": x_f, "xv": xv, "sv_svd": sv_svd,
                "svd_seconds": svd_seconds["refine_0"], "tile512_seconds": tile512_seconds}
    return launches, checks, operands


# ---------------------------------------------------------------------------
# P20: the QDWH route and the out-of-core BDFAC
# ---------------------------------------------------------------------------

OOC_TILE = 512
OOC_PANEL_TILES = 4        # W = 2048
OOC_BAND_BAR = 1e-5        # B's entries below the diagonal and past 2W - 1, over ||X||_F
OOC_INVARIANT_BAR = 1e-3   # ||B||_F and ||BᵀB||_F against X's, relative
REFERENCE_SVD_BAR = 1e-5   # tests/test_models.py:476-524's bars, reported beside P20's


class QdwhProbe:
    """While installed (`with QdwhProbe(torch) as probe:`), counts
    models.qdwh's QR and Cholesky steps and records CUDA events around its
    polar decompositions (qdwh.qdwh) and eigensolves (torch.linalg.eigh);
    `clear()` starts the count again. No host synchronization of its own."""

    def __init__(self, torch):
        from numpywren_tpu_torch.models import qdwh

        self.torch, self.mod = torch, qdwh
        self.clear()

    def clear(self):
        self.steps = {"qr": 0, "cholesky": 0}
        self.spans = {"polar": [], "eigh": []}
        self.iterations = []

    def _counted(self, fn, key):
        def wrapper(*a, **kw):
            self.steps[key] += 1
            return fn(*a, **kw)
        return wrapper

    def _timed(self, fn, key):
        def wrapper(*a, **kw):
            begin, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            begin.record()
            out = fn(*a, **kw)
            end.record()
            self.spans[key].append((begin, end))
            if key == "polar":
                self.iterations.append(out[2])
            return out
        return wrapper

    def __enter__(self):
        mod, linalg = self.mod, self.torch.linalg
        self.saved = [(mod, "_use_qr", mod._use_qr), (mod, "_use_cholesky", mod._use_cholesky),
                      (mod, "qdwh", mod.qdwh), (linalg, "eigh", linalg.eigh)]
        mod._use_qr = self._counted(mod._use_qr, "qr")
        mod._use_cholesky = self._counted(mod._use_cholesky, "cholesky")
        mod.qdwh = self._timed(mod.qdwh, "polar")
        linalg.eigh = self._timed(linalg.eigh, "eigh")
        return self

    def __exit__(self, *exc):
        for obj, name, real in self.saved:
            setattr(obj, name, real)

    def row(self, seconds: float) -> dict:
        """The steps and the seconds by part of the run since clear(),
        whose device seconds are `seconds` (events already reached)."""
        part = {k: sum(b.elapsed_time(e) for b, e in v) / 1e3 for k, v in self.spans.items()}
        part["rest"] = seconds - part["polar"] - part["eigh"]
        scheduled = len(self.mod._schedule(float(self.torch.finfo(self.torch.float32).eps),
                                           10)[1])
        return {"qr_steps": self.steps["qr"], "cholesky_steps": self.steps["cholesky"],
                "halley_steps": self.steps["cholesky"] - scheduled * len(self.iterations),
                "iterations": self.iterations, "seconds_by_part": part}


def host_tier(torch, x, tile: int):
    """The CUDA tensor x (n x n, n a multiple of tile) as a host-tier
    TiledMatrix computing on the card: one pinned slab of tiles, filled by
    one copy a tile row and adopted tile by tile (no tile pinned apart)."""
    from numpywren_tpu_torch.tiled import TiledMatrix

    n = x.shape[0]
    g = n // tile
    slab = torch.empty((g, g, tile, tile), pin_memory=True)
    for i in range(g):
        slab[i].copy_(x[i * tile:(i + 1) * tile].view(tile, g, tile).transpose(0, 1))
    m = TiledMatrix(shape=(n, n), tile=(tile, tile), storage="host", device="cuda")
    for i in range(g):
        for j in range(g):
            m.adopt_block(slab[i, j], i, j)
    return m


def ooc_bdfac_traffic(g: int, tile: int, pt: int) -> tuple:
    """(H2D, D2H) bytes of one out_of_core_bdfac run over a g x g grid of
    fp32 tiles at panel_tiles pt, from its loop's shapes: the real tiles
    of each panel, chunk and band block (padding never crosses)."""
    n_panels = g // pt
    up = down = 0
    for s in range(n_panels):
        rows = g - s * pt
        if rows == pt:  # the final square panel and its R
            up, down = up + pt * pt, down + pt * pt
            break
        remaining = n_panels - s - 1
        up += rows * pt + remaining * rows * pt      # the column panel, its chunks
        down += pt * pt + remaining * rows * pt      # R, the chunks
        if remaining == 1:                           # the superdiagonal block as it is
            down += pt * pt
            continue
        cols = rows - pt
        up += pt * cols + (cols // pt) * pt * cols   # the row panel, its chunks
        down += pt * pt + (cols // pt) * pt * cols   # L, the chunks
    return up * tile * tile * 4, down * tile * tile * 4


def ooc_bdfac_memory_bound(n_pad: int, w: int) -> int:
    """Device bytes out_of_core_bdfac may add (its docstring): 8 n_pad W +
    16 W² fp32 values."""
    return 4 * (8 * n_pad * w + 16 * w * w)


def gram_fro64(torch, m, block: int = 4096) -> float:
    """||mᵀm||_F (the root of the sum of sigma⁴) in fp64 on the card, by
    column blocks of mᵀm."""
    m64 = m.double()
    total = 0.0
    for j in range(0, m.shape[1], block):
        g = m64.T @ m64[:, j:j + block]
        total += float((g * g).sum())
        del g
    return total ** 0.5


def band_excess(torch, b, w: int) -> float:
    """The largest |entry| of b below its diagonal or past its 2w - 1-th
    superdiagonal: what the out-of-core BDFAC's band must leave zero."""
    return max(float(torch.tril(b, -1).abs().max()), float(torch.triu(b, 2 * w).abs().max()))


def ooc_invariants(torch, bc, x_f: float, x_gram: float, w: int) -> tuple:
    """The large out-of-core BDFAC's bars on B = bc (on the card) of an X
    with ||X||_F = x_f and ||XᵀX||_F = x_gram: ||B||_F and ||BᵀB||_F within
    1e-3 of X's, nothing below the diagonal or past 2w - 1 (1e-5 of
    ||X||_F). Returns (the numbers, whether they hold)."""
    q = {"fro_err_over_fro": abs(float(torch.linalg.norm(bc.double())) - x_f) / x_f,
         "gram_fro_err_over_fro": abs(gram_fro64(torch, bc) - x_gram) / x_gram,
         "band_excess_over_fro": band_excess(torch, bc, w) / x_f}
    return q, (q["fro_err_over_fro"] <= OOC_INVARIANT_BAR
               and q["gram_fro_err_over_fro"] <= OOC_INVARIANT_BAR
               and q["band_excess_over_fro"] <= OOC_BAND_BAR)


def fresh_ooc_bdfac_profile(torch, n: int, tile: int, pt: int, seed: int) -> dict:
    """One compensated out_of_core_bdfac of an n x n Gaussian host tier
    (tile `tile`, panel_tiles pt) under torch.profiler (P17's
    spill_profile), in the process that calls it (P20 runs it
    in_new_process), after a warm-up at 2W."""
    from numpywren_tpu_torch import config
    from numpywren_tpu_torch.ops import _build
    from numpywren_tpu_torch.runtime import spill

    _build.build()
    config.default_config().compensated = True
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = tile * pt
    spill.out_of_core_bdfac(host_tier(torch, torch.randn(2 * w, 2 * w, generator=gen,
                                                         device="cuda"), tile), panel_tiles=pt)
    x = host_tier(torch, torch.randn(n, n, generator=gen, device="cuda"), tile)
    torch.cuda.empty_cache()
    return {"n": n, "tile": tile, "w": w, "config": "compensated",
            **spill_profile(torch, lambda: spill.out_of_core_bdfac(x, panel_tiles=pt))}


def p20_kernel_checks(torch, gen, n_qdwh: int, n_ooc: int, card: str) -> list:
    """The kernels of P20's path at its shapes against their plain versions,
    timed in turns with their library call: matmul at QDWH's Gram uᵀu
    (u n_qdwh², ta=True) and at its QR step's e u + alpha q1 q2ᵀ (the
    epilogue, q1, q2 n_qdwh²), also against _matmul_split_ref at three
    planes; matmul3 at the first apply of the n_ooc out-of-core run
    (chunk - W (Sᵀ W1): n_ooc x W by W x W, c the n_ooc x W chunk), also
    against _matmul_split_ref at two planes."""
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()
    n = n_qdwh
    u = torch.randn(n, n, generator=gen, device="cuda") / n ** 0.5
    rows = [product_row(
        torch, "P20", card, "matmul:qdwh_gram", n, n, n,
        lambda: gemm.matmul(u, u, ta=True, precision="highest"),
        lambda: gemm.matmul_ref(u, u, ta=True), lambda: torch.matmul(u.T, u),
        lambda: gemm._matmul_split_ref(u, u, ta=True, planes=3), KERNEL_BAR, 6, with_c=False)]
    q1 = torch.randn(n, n, generator=gen, device="cuda") / n ** 0.5
    q2 = torch.randn(n, n, generator=gen, device="cuda") / n ** 0.5
    alpha, beta = 0.25, 0.75
    rows.append(product_row(
        torch, "P20", card, "matmul:qdwh_qr_step", n, n, n,
        lambda: gemm.matmul(q1, q2, u, tb=True, alpha=alpha, beta=beta, precision="highest"),
        lambda: gemm.matmul_ref(q1, q2, u, tb=True, alpha=alpha, beta=beta),
        lambda: torch.addmm(u, q1, q2.T, alpha=alpha, beta=beta),
        lambda: gemm._matmul_split_ref(q1, q2, u, tb=True, alpha=alpha, beta=beta, planes=3),
        KERNEL_BAR, 6))
    del u, q1, q2
    w = OOC_TILE * OOC_PANEL_TILES
    wv = torch.randn(n_ooc, w, generator=gen, device="cuda") / n_ooc ** 0.5
    sw1 = torch.randn(w, w, generator=gen, device="cuda")
    chunk = torch.randn(n_ooc, w, generator=gen, device="cuda")
    rows.append(product_row(
        torch, "P20", card, "matmul3:ooc_apply", n_ooc, w, w,
        lambda: gemm3.matmul3(wv, sw1, chunk), lambda: gemm3.matmul3_ref(wv, sw1, chunk),
        lambda: torch.addmm(chunk, wv, sw1, alpha=-1.0),
        lambda: gemm._matmul_split_ref(wv, sw1, chunk, alpha=-1.0, beta=1.0, planes=2),
        SPLIT_BAR, 3))
    return rows


def p20_qdwh_ooc(torch, jacobi: dict, bdfac: dict, n_ooc: int, seed: int):
    """The QDWH route and the out-of-core BDFAC (see the module docstring).
    `jacobi` is P18's Gaussian Jacobi operand, `bdfac` P19's operands.
    Returns the launches of matmul, matmul3, potrf_inv and the chain on the
    path, and the kernel checks."""
    from numpywren_tpu_torch import models
    from numpywren_tpu_torch.compiler import lower
    from numpywren_tpu_torch.models import band
    from numpywren_tpu_torch.runtime import spill

    card = gpu_line()
    t_phase = time.perf_counter()
    launches = dict.fromkeys(PATH_KERNELS, 0)

    def emit_row(row):
        for k in launches:
            launches[k] += row.get("launches", {}).get(k, 0)
        emit({"phase": "P20", **row, "nvidia_smi": card})

    def reference_bars(q):
        return {k: q[k] < REFERENCE_SVD_BAR for k in ("recon", "ortho_u_max", "ortho_v_max",
                                                     "s_max_abs_err_rel") if k in q}

    # the QDWH route
    with QdwhProbe(torch) as probe:
        def qdwh_run(label, x, s_ref, call, vectors=True, **extra):
            out, row = model_call(torch, lambda: (probe.clear(), call())[1])
            row.update(probe.row(row["seconds"]))
            if vectors:
                q = svd_bars(torch, x, *out, s_ref)
                ok = (q["recon"] < SVD_RECON_BAR and q["ortho_u_max"] < SVD_ORTHO_BAR
                      and q["ortho_v_max"] < SVD_ORTHO_BAR and q["s_max_abs_err_rel"] <= SV_BAR)
            else:
                err = float((torch.as_tensor(out.copy(), device="cuda") - s_ref).abs().max()
                            / s_ref[0])
                q = {"s_max_abs_err_rel": err}
                ok = err <= SV_BAR
            emit_row({"run": label, "n": x.shape[0], **q,
                      "under_reference_1e-5": reference_bars(q), **extra, **row})
            require(ok, f"P20 {label}: {q}")
            require(row["launches"]["matmul"] > 0, f"P20 {label}: {row['launches']}")

        xj = jacobi["x"]
        qdwh_run("svd_qdwh", xj, jacobi["sv_ref"], lambda: models.svd(xj, method="qdwh"),
                 jacobi_seconds=jacobi["seconds"])
        x, sv_ref = bdfac["x"], bdfac["sv_ref"]
        qdwh_run("svd_qdwh", x, sv_ref, lambda: models.svd(x, method="qdwh"))
        qdwh_run("singular_values_qdwh", x, sv_ref,
                 lambda: models.singular_values(x, finish="qdwh"), vectors=False)
        xv = bdfac["xv"]
        qdwh_run("svd_uv_finish_device", xv, bdfac["sv_svd"],
                 lambda: models.svd(xv, tile=512, uv_finish="device"),
                 tile=512, host_finish_seconds=bdfac["svd_seconds"])
    torch.cuda.empty_cache()

    # the out-of-core BDFAC of host tiers made from P19's X
    link = link_yardstick(torch)
    emit({"phase": "P20", "link": link, "nvidia_smi": card})
    n, x_f = x.shape[0], bdfac["x_f"]

    def ooc_run(label, xh, n_, tile, pt, flags=(), compensated=False, check=None, **kw):
        """One out_of_core_bdfac(xh) through model_call; check(B on the
        card) gives the quality numbers and whether they hold."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        b, row = model_call(torch, lambda: spill.out_of_core_bdfac(xh, panel_tiles=pt, **kw),
                            flags, compensated)
        growth = torch.cuda.max_memory_allocated() - before
        limit = ooc_bdfac_memory_bound(n_, tile * pt)
        up, down = ooc_bdfac_traffic(n_ // tile, tile, pt)
        q, ok = check(host_tiles_to_card(torch, b, n_))
        emit_row({"run": "ooc_bdfac", "route": label, "n": n_, "tile": tile, "w": tile * pt,
                  **kw, **q, "b_storage": b.storage, "h2d_bytes": up, "d2h_bytes": down,
                  "h2d_GBps": up / row["seconds"] / 1e9, "d2h_GBps": down / row["seconds"] / 1e9,
                  "link_GBps": link, "memory_growth": growth, "memory_bound": limit, **row})
        require(ok and b.storage == "host", f"P20 ooc_bdfac {label}: {q}")
        require(growth <= limit, f"P20 ooc_bdfac {label}: device memory grew {growth} B > "
                f"bound {limit}")
        return row

    def sigma_check(w):
        def check(bc):
            q = {"sv_err_over_max": float((sigma_by_gram(torch, bc) - sv_ref).abs().max()
                                          / sv_ref[0]),
                 "fro_err_over_fro": abs(float(torch.linalg.norm(bc.double())) - x_f) / x_f,
                 "band_excess_over_fro": band_excess(torch, bc, w) / x_f}
            return q, (q["sv_err_over_max"] <= BDFAC_BAR and q["fro_err_over_fro"] <= BDFAC_FRO_BAR
                       and q["band_excess_over_fro"] <= OOC_BAND_BAR)
        return check

    t, pt = OOC_TILE, OOC_PANEL_TILES
    xh = host_tier(torch, x, t)
    need = {"compensated": "matmul3", "highest": "matmul", "chain": "cholqr2_chain",
            "potrf_inv": "potrf_inv"}
    for label, kw, comp in (("default", {}, False), ("compensated", {}, True),
                            ("highest", {"precision": "highest"}, False)):
        row = ooc_run(label, xh, n, t, pt, compensated=comp, check=sigma_check(t * pt), **kw)
        if label in need:
            require(row["launches"][need[label]] > 0, f"P20 ooc_bdfac {label}: {row['launches']}")
    xh = host_tier(torch, x, 256)
    for label, flag in (("chain", "NPW_PALLAS_CHAIN"), ("potrf_inv", "NPW_PALLAS_FACTOR")):
        row = ooc_run(label, xh, n, 256, 1, flags=(flag,), check=sigma_check(256))
        require(row["launches"][need[label]] > 0, f"P20 ooc_bdfac {label}: {row['launches']}")
    del xh

    # out_of_core_singular_values where the host has LAPACK: the reference's
    # finish has no other route
    if band.lapack_available():
        xh = host_tier(torch, x, 128)
        s, row = model_call(torch, lambda: spill.out_of_core_singular_values(xh, panel_tiles=1))
        err = float((torch.as_tensor(s.copy(), device="cuda") - sv_ref).abs().max() / sv_ref[0])
        emit_row({"run": "ooc_singular_values", "n": n, "tile": 128, "w": 128,
                  "s_max_abs_err_rel": err, **row})
        require(err <= SV_BAR, f"P20 ooc_singular_values: sigma off by {err} of s_max")
        del xh
    else:
        emit({"phase": "P20", "run": "ooc_singular_values",
              "not_run": "no LAPACK library on this host: out_of_core_singular_values' host "
                         "finish (dgbbrd + dbdsdc) needs one, as the reference's does",
              "nvidia_smi": card})

    # n_ooc: a host tier of 4 GiB at n = 32768, compensated, W = 2048, held by
    # two spectral invariants in fp64 on the card
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    xb = torch.randn(n_ooc, n_ooc, generator=gen, device="cuda")
    t0 = time.perf_counter()
    xb_f = float(torch.linalg.norm(xb.double()))
    xb_gram = gram_fro64(torch, xb)
    ref_s = time.perf_counter() - t0
    xh = host_tier(torch, xb, t)
    del xb
    torch.cuda.empty_cache()

    def invariants(bc):
        q, ok = ooc_invariants(torch, bc, xb_f, xb_gram, t * pt)
        return dict(q, reference_seconds=ref_s), ok

    row = ooc_run("compensated", xh, n_ooc, t, pt, compensated=True, check=invariants)
    require(row["launches"]["matmul3"] > 0, f"P20 ooc_bdfac {n_ooc}: {row['launches']}")
    del xh
    torch.cuda.empty_cache()
    prof = in_new_process("P20", "fresh_ooc_bdfac_profile", n_ooc, t, pt, seed + 20)
    emit({"phase": "P20", "run": "ooc_profile", **prof, "nvidia_smi": card})

    checks = p20_kernel_checks(torch, torch.Generator(device="cuda").manual_seed(seed), n,
                               n_ooc, card)
    emit({"phase": "P20", "seconds": time.perf_counter() - t_phase, "launches": launches,
          "nvidia_smi": card})
    for k, cnt in launches.items():
        require(cnt > 0, f"P20: {k} was not launched on the QDWH and out-of-core BDFAC path")
    return launches, checks


# ---------------------------------------------------------------------------
# P21: the multi-device layer (numpywren_tpu_torch.parallel)
# ---------------------------------------------------------------------------

P21_RANKS = 4             # part (b): four processes, a 2 x 2 mesh, on the one card
P21_TILE = 1024
P21B_N_CHOL = 16384       # part (b)'s sharded Cholesky size (its other sizes are (a)'s)
P21_TILE_ROWS = 4096
P21_SYRK_W = 1024         # summa_syrk's panel width
P21_TIMEOUT = 600         # seconds for part (b)'s ranks
P21_SMALL = {"n_chol": 2048, "n_gemm": 1024, "m": 65536, "b": 512}  # the warm-up's sizes


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def p21_operands(torch, sizes: dict, seed: int, device: str) -> dict:
    """P21's seeded operands, made alike on every rank: A = X Xᵀ/n + 2I
    (the Cholesky's), the GEMMs' A and B (summa_gemm takes them too), the
    TSQR's X and summa_syrk's P (its S is the GEMM's A)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = sizes["n_chol"]
    x = torch.randn(n, n, generator=gen, device=device)
    a = x @ x.T / n
    a.diagonal().add_(2.0)
    del x
    ng = sizes["n_gemm"]
    return {"a": symmetric_from_lower(a.tril()),
            "g_a": torch.randn(ng, ng, generator=gen, device=device),
            "g_b": torch.randn(ng, ng, generator=gen, device=device),
            "x": torch.randn(sizes["m"], sizes["b"], generator=gen, device=device),
            "p": torch.randn(ng, min(P21_SYRK_W, ng), generator=gen, device=device)}


def p21_drive(torch, mesh, ops: dict, tile: int, tile_rows: int) -> tuple:
    """Each P21 entry point once on `mesh` (every rank of it calls this),
    the Cholesky on a copy of each rank's block of A (it factors in place).
    Returns (the results, each case's seconds: host clock from a barrier
    to a synchronize, this rank's kernel launches)."""
    import torch.distributed as dist

    from numpywren_tpu_torch.parallel import sharded_cholesky, sharded_gemm, sharded_tsqr
    from numpywren_tpu_torch.parallel.fabric import summa_gemm, summa_syrk
    from numpywren_tpu_torch.parallel.mesh import as_dtensor, local_block, tile_sharding

    sh = tile_sharding(mesh)
    a_in = as_dtensor(local_block(ops["a"], sh).clone(), ops["a"].shape, sh)
    cases = (
        ("sharded_cholesky", lambda: sharded_cholesky(a_in, tile, mesh)),
        ("sharded_gemm", lambda: sharded_gemm(ops["g_a"], ops["g_b"], mesh)),
        ("sharded_gemm_highest",
         lambda: sharded_gemm(ops["g_a"], ops["g_b"], mesh, precision="highest")),
        ("sharded_tsqr", lambda: sharded_tsqr(ops["x"], tile_rows, mesh, compute_q=True)),
        ("summa_gemm", lambda: summa_gemm(ops["g_a"], ops["g_b"], mesh)),
        ("summa_syrk", lambda: summa_syrk(ops["g_a"], ops["p"], mesh, precision="highest")),
    )
    cuda = ops["a"].device.type == "cuda"
    results, seconds = {}, {}
    reset_launch_counts()
    for name, call in cases:
        if mesh.size() > 1:
            dist.barrier()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = call()
        if cuda:
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    counts = launch_counts()
    return results, seconds, {k: counts[k] for k in ("matmul", "matmul3")}


def p21_warm(torch, mesh, small: dict, seed: int, device: str) -> None:
    """The entry points once at `small` sizes: the libraries' handles and
    the first allocations, before the timed drive."""
    p21_drive(torch, mesh, p21_operands(torch, small, seed, device), small["n_chol"] // 8,
              small["m"] // 16)


def p21_tsqr_quality(torch, mesh, x, q, r, chunk: int = 1 << 17) -> tuple:
    """(||QᵀQ - I||_F / sqrt(b), ||QR - X||_F / ||X||_F) in fp64, each rank
    summing over its own rows of Q and X, then one sum over the mesh (no
    gather of Q). Collective over the mesh."""
    from numpywren_tpu_torch.parallel.mesh import (NamedSharding, is_primary, local_block,
                                                   sum_over_mesh)

    b = x.shape[1]
    sh = NamedSharding(mesh, tuple(q.placements))
    q_loc, x_loc = q.to_local(), local_block(x, sh)
    r64 = r.to_local().double()
    acc = torch.zeros(b * b + 2, dtype=torch.float64, device=x.device)
    if is_primary(sh):
        for i0 in range(0, x_loc.shape[0], chunk):
            qc, xc = q_loc[i0:i0 + chunk].double(), x_loc[i0:i0 + chunk].double()
            acc[:b * b] += (qc.T @ qc).reshape(-1)
            d = qc @ r64 - xc
            acc[b * b] += (d * d).sum()
            acc[b * b + 1] += (xc * xc).sum()
    sum_over_mesh(acc, mesh)
    gram = acc[:b * b].reshape(b, b) - torch.eye(b, dtype=torch.float64, device=x.device)
    return (float(torch.linalg.norm(gram)) / b ** 0.5,
            float((acc[b * b] / acc[b * b + 1]) ** 0.5))


def p21_gather(torch, results: dict) -> dict:
    """Every result whole on every rank of its mesh (distributed.full_tensor:
    all_reduce only, which gloo takes for a CUDA tensor). Collective."""
    from numpywren_tpu_torch.parallel.distributed import full_tensor

    out = {}
    for name, res in results.items():
        if name == "sharded_tsqr":
            out["sharded_tsqr_r"] = full_tensor(res[1])
        else:
            out[name] = full_tensor(res)
    return out


def p21_bars(torch, ops: dict, full: dict, ref: dict = None) -> dict:
    """The bars on whole results (one rank): the factor's residual in fp64
    (<= 1e-4); each GEMM against the fp64 product (<= 1e-5); R against the
    library's QR (signs fixed, <= 3e-5); with `ref`, the 1-rank results:
    the GEMMs within 1e-5, the factor within 1e-4, R within 3e-5."""
    exact = ops["g_a"].double() @ ops["g_b"].double()
    s_exact = ops["g_a"].double() - ops["p"].double() @ ops["p"].double().T
    r_lib = torch.linalg.qr(ops["x"], mode="r")[1]
    row = {"cholesky_residual": residual(torch, ops["a"], full["sharded_cholesky"]),
           "r_rel_diff_vs_library": rel_err(torch, sign_fixed(full["sharded_tsqr_r"]),
                                            sign_fixed(r_lib))}
    for name in ("sharded_gemm", "sharded_gemm_highest", "summa_gemm"):
        row[f"{name}_rel_err_vs_fp64"] = rel_err(torch, full[name], exact)
    row["summa_syrk_rel_err_vs_fp64"] = rel_err(torch, full["summa_syrk"], s_exact)
    del exact, s_exact
    require(row["cholesky_residual"] <= RESID_BAR,
            f"P21: sharded_cholesky residual {row['cholesky_residual']} > {RESID_BAR}")
    require(row["r_rel_diff_vs_library"] <= R_AGREE_BAR,
            f"P21: sharded_tsqr R differs from the library's by {row['r_rel_diff_vs_library']}")
    for k, v in row.items():
        if k.endswith("_vs_fp64"):
            require(v <= KERNEL_BAR, f"P21: {k} {v} > {KERNEL_BAR}")
    if ref is not None:
        row["cholesky_rel_diff_vs_1_rank"] = rel_err(torch, full["sharded_cholesky"],
                                                     ref["sharded_cholesky"])
        row["r_rel_diff_vs_1_rank"] = rel_err(torch, sign_fixed(full["sharded_tsqr_r"]),
                                              sign_fixed(ref["sharded_tsqr_r"]))
        for name in ("sharded_gemm", "sharded_gemm_highest", "summa_gemm", "summa_syrk"):
            row[f"{name}_rel_diff_vs_1_rank"] = rel_err(torch, full[name], ref[name])
        require(row["cholesky_rel_diff_vs_1_rank"] <= RESID_BAR,
                f"P21: the factor differs from the 1-rank one by "
                f"{row['cholesky_rel_diff_vs_1_rank']}")
        require(row["r_rel_diff_vs_1_rank"] <= R_AGREE_BAR,
                f"P21: R differs from the 1-rank R by {row['r_rel_diff_vs_1_rank']}")
        for name in ("sharded_gemm", "sharded_gemm_highest", "summa_gemm", "summa_syrk"):
            v = row[f"{name}_rel_diff_vs_1_rank"]
            require(v <= KERNEL_BAR, f"P21: {name} differs from the 1-rank one by {v}")
    return row


P21_KAPPA = 1e6           # part (b)'s cholqr3s_sharded operand (P10's)
# ||QR - X||_F / ||X||_F of that operand's compensated chain: its applies are
# matmul3 (bf16x3, MATMUL3_FP64_BAR against fp64 each), and the chain on one
# device reaches 1.66e-5 there (the plain versions on the CPU), above
# QR_RESID_BAR, which the true-FP32 chain meets (6.9e-7)
P21_KAPPA_RESID_BAR = 3e-5
P21_M_SMALL, P21_B_SMALL = 65536, 256   # cholqr2_sharded's (a) and the kappa operand's (b) shape
P21_OOC_PANEL_TILES = SPILL_PANEL_TILES  # the mesh out-of-core Cholesky's W: 4 tiles of 512
FABRIC_MATMUL3 = ("cholesky_2d", "cholesky_2d_no_lookahead", "cholesky_1d", "out_of_core_cholesky")


def p21_fabric_operands(torch, sizes: dict, seed: int, device: str) -> dict:
    """The fabric entries' operands beside p21_operands': P11's 65,536 x 256
    (cholqr2_sharded, part (a)) and P10's kappa = 1e6 panel of that shape
    (cholqr3s_sharded, part (b)), made alike on every rank."""
    gen = torch.Generator(device=device).manual_seed(seed + 21)
    m, b = min(P21_M_SMALL, sizes["m"]), min(P21_B_SMALL, sizes["b"])
    u, _ = torch.linalg.qr(torch.randn(m, b, generator=gen, device=device))
    v, _ = torch.linalg.qr(torch.randn(b, b, generator=gen, device=device))
    s = torch.logspace(0, -math.log10(P21_KAPPA), b, device=device)
    return {"x_small": torch.randn(m, b, generator=gen, device=device),
            "x_kappa": (u * s) @ v.T}


def p21_host_tier(torch, a, tile: int):
    """A as a host tier computing on its device (on the CPU, a plain one)."""
    from numpywren_tpu_torch.matrix_init import shard_matrix

    if a.device.type == "cuda":
        return host_tier(torch, a, tile)
    return shard_matrix(a.numpy(), tile=(tile, tile), storage="host", device="cpu")


def p21_fabric_drive(torch, mesh, ops: dict, fab: dict, panel: int, ooc_tile: int,
                     part: str, repeat: int = 1) -> tuple:
    """The fabric entries once each on `mesh` (every rank of it calls
    this): (a) cholesky_2d with lookahead on and off, cholesky_1d,
    cholqr3s_sharded with Q on ops["x"], cholqr2_sharded with Q on
    fab["x_small"], tsqr_butterfly on ops["x"], out_of_core_cholesky(mesh=)
    on a host tier of ops["a"]; (b) the Cholesky forms, the out-of-core
    Cholesky and cholqr3s_sharded with Q on fab["x_kappa"]. Each case runs
    `repeat` times in a row. Returns (the last run's results, each case's
    seconds: host clock from a barrier to a synchronize, every run's,
    each case's matmul / matmul3 launches on this rank in its last run,
    with the cholqr3s chain's chains and extras passes: `run_cases`)."""
    from numpywren_tpu_torch.parallel.fabric import (cholesky_1d, cholesky_2d, cholqr2_sharded,
                                                     cholqr3s_sharded, tsqr_butterfly)
    from numpywren_tpu_torch.runtime import out_of_core_cholesky

    a = ops["a"]
    tier = p21_host_tier(torch, a, ooc_tile)
    cases = [
        ("cholesky_2d", lambda: cholesky_2d(a, mesh, panel=panel)),
        ("cholesky_2d_no_lookahead", lambda: cholesky_2d(a, mesh, panel=panel, lookahead=False)),
        ("cholesky_1d", lambda: cholesky_1d(a, mesh, panel=panel)),
        ("out_of_core_cholesky", lambda: out_of_core_cholesky(
            tier, panel_tiles=P21_OOC_PANEL_TILES, mesh=mesh)),
    ]
    if part == "a":
        cases += [
            ("cholqr3s_sharded", lambda: cholqr3s_sharded(ops["x"], mesh, compute_q=True)),
            ("cholqr2_sharded", lambda: cholqr2_sharded(fab["x_small"], mesh, compute_q=True)),
            ("tsqr_butterfly", lambda: tsqr_butterfly(ops["x"], mesh)),
        ]
    else:
        cases.append(("cholqr3s_sharded_kappa",
                      lambda: cholqr3s_sharded(fab["x_kappa"], mesh, compute_q=True)))
    return run_cases(torch, mesh, cases, repeat, a.device.type == "cuda")


def run_cases(torch, mesh, cases, repeat: int, cuda: bool) -> tuple:
    """Each (name, call) of `cases` `repeat` times in a row on every rank of
    `mesh`: (the last run's results, each case's seconds, host clock from a
    barrier to a synchronize, every run's, each case's matmul / matmul3
    launches on this rank in its last run, with the chains' chains and
    extras passes of a cholqr3s case)."""
    import torch.distributed as dist

    from numpywren_tpu_torch.compiler import lower

    results, seconds, launches = {}, {}, {}
    for name, call in cases:
        seconds[name] = []
        for _ in range(repeat):
            results[name] = None  # the previous run's result goes first
            if mesh.size() > 1:
                dist.barrier()
            if cuda:
                torch.cuda.synchronize()
            reset_launch_counts()
            lower.reset_chain_passes()
            t0 = time.perf_counter()
            results[name] = call()
            if cuda:
                torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
        counts = launch_counts()
        launches[name] = {k: counts[k] for k in ("matmul", "matmul3")}
        if name.startswith("cholqr3s"):
            launches[name]["chain_passes"] = dict(lower.CHAIN_PASSES)
    return results, seconds, launches


def p21_fabric_bars(torch, mesh, ops: dict, fab: dict, results: dict) -> tuple:
    """Each fabric result held to its bar on this rank (collective: Q's
    quality sums over the mesh): the factors' residual in fp64 (<= 1e-4),
    the out-of-core factor's too; Q's orthogonality and residual (<= 1e-4,
    <= 1e-5) and R against the library's QR (<= 3e-5; not the kappa = 1e6
    panel's). Returns (the numbers, each factor or R whole on this rank)."""
    a = ops["a"]
    row, whole = {}, {}
    for name in ("cholesky_2d", "cholesky_2d_no_lookahead", "cholesky_1d"):
        whole[name] = results[name]
    l = results["out_of_core_cholesky"]
    whole["out_of_core_cholesky"] = (host_tiles_to_card(torch, l, a.shape[0])
                                     if a.device.type == "cuda"
                                     else torch.from_numpy(l.numpy())).tril()
    for name, l in whole.items():
        row[f"{name}_residual"] = residual(torch, a, l)
        require(row[f"{name}_residual"] <= RESID_BAR,
                f"P21: {name} residual {row[f'{name}_residual']} > {RESID_BAR}")
    r_lib = {"x": torch.linalg.qr(ops["x"], mode="r")[1]}
    if "cholqr2_sharded" in results:
        r_lib["x_small"] = torch.linalg.qr(fab["x_small"], mode="r")[1]
    for name, x in (("cholqr3s_sharded", "x"), ("cholqr2_sharded", "x_small"),
                    ("cholqr3s_sharded_kappa", "x_kappa")):
        if name not in results:
            continue
        q, r = results[name]
        ortho, resid = p21_tsqr_quality(torch, mesh, ops[x] if x in ops else fab[x], q, r)
        row[f"{name}_ortho"], row[f"{name}_residual"] = ortho, resid
        resid_bar = P21_KAPPA_RESID_BAR if x == "x_kappa" else QR_RESID_BAR
        require(ortho <= ORTHO_BAR and resid <= resid_bar,
                f"P21: {name} ortho {ortho}, residual {resid} (bars {ORTHO_BAR}, {resid_bar})")
        whole[name] = r.to_local()
    if "tsqr_butterfly" in results:
        whole["tsqr_butterfly"] = results["tsqr_butterfly"].to_local()
    for name, x in (("cholqr3s_sharded", "x"), ("cholqr2_sharded", "x_small"),
                    ("tsqr_butterfly", "x")):
        if name in whole:
            v = rel_err(torch, sign_fixed(whole[name]), sign_fixed(r_lib[x]))
            row[f"{name}_r_rel_diff_vs_library"] = v
            # the chain stops once its Gram is within conv_tol = 1e-4 of I,
            # so its R is held to the library's QR at the orthogonality bar,
            # and to the single-device chain's R at R_AGREE_BAR
            bar = ORTHO_BAR if name == "cholqr3s_sharded" else R_AGREE_BAR
            require(v <= bar, f"P21: {name}'s R differs from the library's by {v} > {bar}")
    if "cholqr3s_sharded" in whole:
        from numpywren_tpu_torch.compiler.lower import fused_cholqr3s_fn

        r_chain = fused_cholqr3s_fn()(ops["x"])
        v = row["cholqr3s_sharded_r_rel_diff_vs_one_device"] = rel_err(
            torch, sign_fixed(whole["cholqr3s_sharded"]), sign_fixed(r_chain))
        require(v <= R_AGREE_BAR, f"P21: cholqr3s_sharded's R differs from the single-device "
                                  f"chain's by {v}")
    return row, whole


def p21_fabric_agree(torch, whole: dict, ref: dict) -> dict:
    """This mesh's factors and R against the 1-rank ones: the factors
    within 1e-4, R within 3e-5 (signs fixed)."""
    row = {}
    for name, got in whole.items():
        if name.startswith(("cholesky", "out_of_core")):
            v = row[f"{name}_rel_diff_vs_1_rank"] = rel_err(torch, got, ref[name])
            require(v <= RESID_BAR, f"P21: {name} differs from the 1-rank one by {v}")
        else:
            v = row[f"{name}_r_rel_diff_vs_1_rank"] = rel_err(torch, sign_fixed(got),
                                                              sign_fixed(ref[name]))
            require(v <= R_AGREE_BAR, f"P21: {name}'s R differs from the 1-rank R by {v}")
    return row


def p21_matmul3_bulk(torch, gen, n: int, panel: int, card: str) -> dict:
    """matmul3 at cholesky_2d's first bulk update on one rank at n: c a
    view of an n² buffer from row and column `panel` ((n - panel)² by K =
    panel), against matmul3_ref (KERNEL_BAR) and _matmul_split_ref at two
    planes (SPLIT_BAR), timed in turns with addmm."""
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()
    buf = torch.randn(n, n, generator=gen, device="cuda")
    c = buf[panel:, panel:]
    rows = torch.randn(n - panel, panel, generator=gen, device="cuda")
    cols = torch.randn(n - panel, panel, generator=gen, device="cuda")
    m = n - panel
    row = product_row(torch, "P21", card, "matmul3:cholesky_2d_bulk", m, panel, m,
                      lambda: gemm3.matmul3(rows, cols, c, tb=True),
                      lambda: gemm3.matmul3_ref(rows, cols, c, tb=True),
                      lambda: torch.addmm(c, rows, cols.T, alpha=-1.0),
                      lambda: gemm._matmul_split_ref(rows, cols.T, c, alpha=-1.0, beta=1.0,
                                                     planes=2),
                      SPLIT_BAR, 3)
    del buf, c, rows, cols
    torch.cuda.empty_cache()
    return row

P21_BDFAC_TILE = 512                 # the distributed BDFAC's tile on P19's X
# singular_values(mesh=)'s size and tile in (b): 1024, not 2048, keeps the
# script inside its time limit with P23 (its host Golub-Kahan eigensolve
# took 23-40 s a call at 2048 on every rank at once, 12 s on one)
P21_SV_N, P21_SV_TILE = 1024, 256
FABRIC_BDFAC = ("bdfac_1d", "bdfac_2d", "out_of_core_bdfac")  # each launches matmul3
# B of four ranks against one rank's, by b_agreement (|B|, and the last
# block column's sigma). B itself is fixed only up to Yamamoto signs and
# the last block column's orthogonal factors, and a sign flips at
# rounding level: on an NVIDIA H100 (700 W) at 8192/512, compensated,
# seeds 0-5, four ranks moved B by up to 0.119 raw and |B| by 0.0372, and
# b_agreement by 6.48-6.60e-5 (a one-ulp change of X and "highest" 7.8e-5
# at most); rank 1's Wᵀ·trailing share dropped or its bulk update skipped
# at step 8 moved it by 0.108-0.131 (experiments/torch_bdfac_agreement.py).
P21_BDFAC_B_BAR = 1e-4
DRYRUN_STAGES = 13                   # dryrun_multichip's numbers on a mesh of 4 (stage 4 has 3)


def p21_bdfac_sizes(sizes: dict) -> dict:
    """The BDFAC calls' sizes: n (P19's --n-bdfac) at its tile, the
    out-of-core tier's tile (W = OOC_PANEL_TILES tiles), singular_values' n
    and tile; a rehearsal's small sizes cut them alike."""
    n = sizes.get("n_bdfac", sizes["n_chol"])
    n_sv = sizes.get("n_sv", n // 2)
    return {"n": n, "tile": min(P21_BDFAC_TILE, n // 4), "ooc_tile": min(OOC_TILE, n // 8),
            "n_sv": n_sv, "sv_tile": min(P21_SV_TILE, n_sv // 4)}


def p21_bdfac_cases(mesh, x, tile: int, tier, part: str) -> list:
    """(name, call) of the distributed BDFAC on `mesh`: bdfac_1d and
    bdfac_2d of x at `tile`, in (a) also bdfac_2d without lookahead and at
    "highest", then out_of_core_bdfac(mesh=) of the host tier `tier` (W =
    OOC_PANEL_TILES of its tiles)."""
    from numpywren_tpu_torch.parallel.fabric import bdfac_1d, bdfac_2d
    from numpywren_tpu_torch.runtime.spill import out_of_core_bdfac

    cases = [("bdfac_1d", lambda: bdfac_1d(x, mesh, tile=tile)),
             ("bdfac_2d", lambda: bdfac_2d(x, mesh, tile=tile))]
    if part == "a":
        cases += [("bdfac_2d_no_lookahead", lambda: bdfac_2d(x, mesh, tile=tile, lookahead=False)),
                  ("bdfac_2d_highest", lambda: bdfac_2d(x, mesh, tile=tile, precision="highest"))]
    cases.append(("out_of_core_bdfac",
                  lambda: out_of_core_bdfac(tier, panel_tiles=OOC_PANEL_TILES, mesh=mesh)))
    return cases


def whole_tier(torch, m, n: int, device: str):
    """A host-tier result as one (n, n) tensor on `device`."""
    return host_tiles_to_card(torch, m, n) if device == "cuda" else torch.from_numpy(m.numpy())


def p21_ooc_sigma(torch, bc, sv_ref, x_f: float, w: int) -> tuple:
    """P20's bars on an out-of-core B of a matrix with sigma sv_ref (fp64,
    descending) and ||X||_F = x_f: sigma within 1e-4 of sigma_max, ||B||_F
    within 1e-3, the band. Returns (the numbers, whether they hold)."""
    q = {"sv_err_over_max": float((sigma_by_gram(torch, bc) - sv_ref).abs().max() / sv_ref[0]),
         "fro_err_over_fro": abs(float(torch.linalg.norm(bc.double())) - x_f) / x_f,
         "band_excess_over_fro": band_excess(torch, bc, w) / x_f}
    return q, (q["sv_err_over_max"] <= BDFAC_BAR and q["fro_err_over_fro"] <= BDFAC_FRO_BAR
               and q["band_excess_over_fro"] <= OOC_BAND_BAR)


def p21_matmul3_bdfac_bulk(torch, gen, n: int, tile: int, card: str) -> dict:
    """matmul3 at bdfac_2d's first bulk update on one rank at n: c a view of
    an n² buffer from column `tile` (n x (n - tile)), less W (n x tile) by
    SᵀW1 (tile x (n - tile)), against matmul3_ref (KERNEL_BAR) and
    _matmul_split_ref at two planes (SPLIT_BAR), timed in turns with
    addmm."""
    from numpywren_tpu_torch.ops import gemm3

    gemm = gemm_module()
    buf = torch.randn(n, n, generator=gen, device="cuda")
    c = buf[:, tile:]
    w = torch.randn(n, tile, generator=gen, device="cuda")
    sw1 = torch.randn(tile, n - tile, generator=gen, device="cuda")
    row = product_row(torch, "P21", card, "matmul3:bdfac_2d_bulk", n, tile, n - tile,
                      lambda: gemm3.matmul3(w, sw1, c),
                      lambda: gemm3.matmul3_ref(w, sw1, c),
                      lambda: torch.addmm(c, w, sw1, alpha=-1.0),
                      lambda: gemm._matmul_split_ref(w, sw1, c, alpha=-1.0, beta=1.0, planes=2),
                      SPLIT_BAR, 3)
    del buf, c, w, sw1
    torch.cuda.empty_cache()
    return row


def p21_bdfac_single(torch, mesh, bdfac: dict, n_ooc: int, seed: int, card: str) -> dict:
    """P21 (a)'s distributed BDFAC on the 1 x 1 mesh, compensated: the
    p21_bdfac_cases on P19's X (`bdfac`: its x, sv_ref, x_f) at tile 512,
    each twice, held by P19's bars (sigma(B) by sigma_by_gram); the
    out-of-core one on P20's 32768 Gaussian tier (tile 512, W = 2048), held
    by P20's invariants; bdfac_2d's time split in a new process; matmul3 at
    bdfac_2d's first bulk update. Emits one row; returns the launches of
    matmul and matmul3 summed over the calls."""
    x, sv_ref, x_f = bdfac["x"], bdfac["sv_ref"], bdfac["x_f"]
    n, t = x.shape[0], P21_BDFAC_TILE
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)  # P20's n_ooc operand
    xb = torch.randn(n_ooc, n_ooc, generator=gen, device="cuda")
    xb_f, xb_gram = float(torch.linalg.norm(xb.double())), gram_fro64(torch, xb)
    tier = host_tier(torch, xb, OOC_TILE)
    del xb
    torch.cuda.empty_cache()
    res, sec, launches = run_cases(torch, mesh, p21_bdfac_cases(mesh, x, t, tier, "a"), 2, True)
    bars = {}
    for name in ("bdfac_1d", "bdfac_2d", "bdfac_2d_no_lookahead", "bdfac_2d_highest"):
        bars[name] = bdfac_quality(torch, x, res.pop(name), t, sv_ref, x_f)
        require_bdfac(f"P21 (a) {name}", bars[name])
    bc = host_tiles_to_card(torch, res.pop("out_of_core_bdfac"), n_ooc)
    bars["out_of_core_bdfac"], ok = ooc_invariants(torch, bc, xb_f, xb_gram,
                                                   OOC_TILE * OOC_PANEL_TILES)
    require(ok, f"P21 (a) out_of_core_bdfac: {bars['out_of_core_bdfac']}")
    del bc, tier
    torch.cuda.empty_cache()
    prof = in_new_process("P21", "fresh_bdfac_profile", n, t, "bdfac_2d")
    bulk = p21_matmul3_bdfac_bulk(torch, torch.Generator(device="cuda").manual_seed(seed), n, t,
                                  card)
    emit({"phase": "P21", "part": "a", "entries": "bdfac", "ranks": 1, "mesh": [1, 1],
          "config": "compensated", "n": n, "tile": t,
          "ooc": {"n": n_ooc, "tile": OOC_TILE, "panel_tiles": OOC_PANEL_TILES},
          "seconds": {k: v[-1] for k, v in sec.items()}, "seconds_runs": sec,
          "launches": launches, "bars": bars, "bdfac_2d_profile": prof,
          "matmul3_bulk": {k: bulk[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "rel_err",
                                                 "rel_err_split_ref", "max_abs_err")},
          "nvidia_smi": card})
    for name in FABRIC_BDFAC + ("bdfac_2d_no_lookahead",):
        require(launches[name]["matmul3"] > 0, f"P21 (a): {name} launched no matmul3")
    require(launches["bdfac_2d_highest"]["matmul"] > 0,
            "P21 (a): bdfac_2d at \"highest\" launched no matmul")
    return {k: sum(c[k] for c in launches.values()) for k in ("matmul", "matmul3")}


def b_agreement(torch, b, ref, w: int) -> float:
    """B against ref up to what the sweep leaves free, over ||ref||_F: |B|
    against |ref| but in the last w columns (a Yamamoto sign that differs
    flips a row or a column of B), and the singular values of the last w
    columns (the LQ side's last reflector fixes them up to an orthogonal
    factor on the right, the last QR on the left)."""
    b, ref = b.double(), ref.double()
    head = torch.linalg.norm(b[:, :-w].abs() - ref[:, :-w].abs())
    tail = torch.linalg.norm(sigma_by_gram(torch, b[:, -w:]) - sigma_by_gram(torch, ref[:, -w:]))
    return float(torch.hypot(head, tail) / torch.linalg.norm(ref))


def fingerprint(torch, b) -> list:
    """Three fp64 sums of b (its entries, their squares, row-weighted):
    equal bits give equal sums."""
    b64 = b.double()
    rows = torch.arange(1, b.shape[0] + 1, dtype=torch.float64, device=b.device)
    return [float(b64.sum()), float((b64 * b64).sum()), float((rows @ b64).sum())]


def p21_bdfac_rank(torch, mesh, mesh1, sizes: dict, seed: int, device: str) -> tuple:
    """P21 (b)'s distributed BDFAC on one rank of the 2 x 2 mesh:
    bdfac_1d, bdfac_2d and out_of_core_bdfac(mesh=) of P19's X,
    singular_values(mesh=) on the 2 x 2 mesh (bdfac_2d) and on a 1 x 4 one
    (bdfac_1d), and the dry run. Every rank's B and sigma are the same
    (fingerprints); rank 0 holds each to the same call on its 1-rank mesh
    (sigma within 1e-4 sigma_max, B within P21_BDFAC_B_BAR) and to P19's
    bars against sigma_by_gram of X. Returns (this rank's numbers, its
    launches by call)."""
    import numpy as np

    from numpywren_tpu_torch.models import singular_values
    from numpywren_tpu_torch.parallel import distributed, make_mesh
    from numpywren_tpu_torch.parallel.dryrun import dryrun_multichip

    bs = p21_bdfac_sizes(sizes)
    rank = distributed.process_index()
    mesh14 = make_mesh(shape=(1, 4), device=None if device == "cuda" else device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(bs["n"], bs["n"], generator=gen, device=device)  # P19's X
    x_sv = torch.randn(bs["n_sv"], bs["n_sv"], generator=gen, device=device)
    tier = p21_host_tier(torch, x, bs["ooc_tile"])
    t, w = bs["tile"], bs["ooc_tile"] * OOC_PANEL_TILES

    def svals(m):
        return lambda: torch.as_tensor(singular_values(x_sv, tile=bs["sv_tile"], mesh=m).copy(),
                                       device=device)

    cases = p21_bdfac_cases(mesh, x, t, tier, "b") + [
        ("singular_values_2x2", svals(mesh)), ("singular_values_1x4", svals(mesh14)),
        ("dryrun_multichip", lambda: dryrun_multichip(mesh))]
    res, sec, launches = run_cases(torch, mesh, cases, 1, device == "cuda")
    stages = res.pop("dryrun_multichip")
    res["out_of_core_bdfac"] = whole_tier(torch, res["out_of_core_bdfac"], bs["n"], device)
    names = [k for k in res]
    every = distributed.gather_to_hosts(np.array([fingerprint(torch, res[k]) for k in names]))
    out = {"bdfac_sizes": bs, "bdfac_seconds": sec, "bdfac_launches": launches,
           "dryrun_stages": stages}
    require(len(stages) == DRYRUN_STAGES, f"P21 (b) rank {rank}: dry run stages {sorted(stages)}")
    if rank == 0:
        every = every.reshape(-1, len(names), 3)
        out["same_on_every_rank"] = {k: bool((every[:, i] == every[0, i]).all())
                                     for i, k in enumerate(names)}
        require(all(out["same_on_every_rank"].values()),
                f"P21 (b): results differ between ranks: {out['same_on_every_rank']}")
        ref, ref_sec, _ = run_cases(torch, mesh1, p21_bdfac_cases(mesh1, x, t, tier, "b") + [
            ("singular_values", svals(mesh1))], 1, device == "cuda")
        ref["out_of_core_bdfac"] = whole_tier(torch, ref["out_of_core_bdfac"], bs["n"], device)
        out["bdfac_one_rank_seconds"] = ref_sec
        x_f = float(torch.linalg.norm(x.double()))
        sv_x, sv_ref = sigma_by_gram(torch, x), sigma_by_gram(torch, x_sv)
        checks = {}
        for name in ("bdfac_1d", "bdfac_2d"):
            checks[name] = bdfac_quality(torch, x, res[name], t, sv_x, x_f)
            require_bdfac(f"P21 (b) {name}", checks[name])
        checks["out_of_core_bdfac"], ok = p21_ooc_sigma(torch, res["out_of_core_bdfac"], sv_x,
                                                        x_f, w)
        require(ok, f"P21 (b) out_of_core_bdfac: {checks['out_of_core_bdfac']}")
        for name in FABRIC_BDFAC:
            checks[name]["rel_diff_vs_1_rank"] = rel_err(torch, res[name], ref[name])
            v = checks[name]["agreement_vs_1_rank"] = b_agreement(
                torch, res[name], ref[name], w if name == "out_of_core_bdfac" else t)
            require(v <= P21_BDFAC_B_BAR,
                    f"P21 (b): {name}'s B differs from the 1-rank B by {v} > {P21_BDFAC_B_BAR}")
        for name in ("singular_values_2x2", "singular_values_1x4"):
            s = res[name]
            checks[name] = {
                "err_vs_1_rank_over_max": float((s - ref["singular_values"]).abs().max()
                                                / ref["singular_values"][0]),
                "err_vs_fp64_over_max": float((s.double() - sv_ref).abs().max() / sv_ref[0])}
            require(max(checks[name].values()) <= SV_BAR, f"P21 (b) {name}: {checks[name]}")
        out["bdfac_checks"] = checks
    if device == "cuda":
        for name in FABRIC_BDFAC:
            require(launches[name]["matmul3"] > 0,
                    f"P21 (b) rank {rank}: {name} launched no matmul3")
    return out, launches


def p21_single(torch, npw, sizes: dict, small: dict, seed: int, p2_seconds: float,
               bdfac: dict, n_ooc: int) -> dict:
    """P21 (a): a 1-rank group joined by the usual initialize() through the
    NPW_* variables (the card's backend: NCCL), a 1 x 1 mesh, the entry
    points at full width, compensated, then the distributed BDFAC on P19's
    operands (`bdfac`) and P20's n_ooc tier (p21_bdfac_single); the group
    is closed after. Returns the launches of matmul and matmul3."""
    import torch.distributed as dist

    from numpywren_tpu_torch.parallel import distributed, make_mesh

    card = gpu_line()
    env = {"NPW_COORDINATOR": f"127.0.0.1:{free_port()}", "NPW_NUM_PROCESSES": "1",
           "NPW_PROCESS_ID": "0"}
    os.environ.update(env)
    cfg = npw.default_config()
    compensated = cfg.compensated
    try:
        require(distributed.initialize() is False, "P21: one process is not multi-process")
        require(dist.is_initialized() and dist.get_world_size() == 1, "P21: no 1-rank group")
        backend = dist.get_backend()
        mesh = make_mesh()
        require(tuple(mesh.shape) == (1, 1), f"P21: mesh {tuple(mesh.shape)}")
        cfg.compensated = True
        p21_warm(torch, mesh, small, seed, "cuda")
        ops = p21_operands(torch, sizes, seed, "cuda")
        results, seconds, counts = p21_drive(torch, mesh, ops, P21_TILE, P21_TILE_ROWS)
        q, r = results["sharded_tsqr"]
        ortho, resid = p21_tsqr_quality(torch, mesh, ops["x"], q, r)
        full = p21_gather(torch, results)
        del results, q, r
        bars = p21_bars(torch, ops, full)
        del full
        torch.cuda.empty_cache()
        fab = p21_fabric_operands(torch, sizes, seed, "cuda")
        fres, fsec, flaunch = p21_fabric_drive(torch, mesh, ops, fab, P21_TILE, SPILL_TILE, "a",
                                               repeat=2)
        fbars, _ = p21_fabric_bars(torch, mesh, ops, fab, fres)
        del fres, fab, ops
        torch.cuda.empty_cache()
        bulk = p21_matmul3_bulk(torch, torch.Generator(device="cuda").manual_seed(seed),
                                sizes["n_chol"], P21_TILE, card)
        bd_counts = p21_bdfac_single(torch, mesh, bdfac, n_ooc, seed, card)
    finally:
        cfg.compensated = compensated
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    n = sizes["n_chol"]
    row = {"phase": "P21", "part": "a", "ranks": 1, "mesh": [1, 1], "backend": backend,
           "config": "compensated", "sizes": sizes, "seconds": seconds,
           "cholesky_tflops": n ** 3 / 3 / seconds["sharded_cholesky"] / 1e12,
           "p2_trapezoid_seconds": p2_seconds, "tsqr_ortho": ortho, "tsqr_residual": resid,
           "launches": counts, "nvidia_smi": card, **bars}
    emit(row)
    emit({"phase": "P21", "part": "a", "entries": "fabric", "ranks": 1, "mesh": [1, 1],
          "backend": backend, "config": "compensated", "panel": P21_TILE,
          "ooc": {"tile": SPILL_TILE, "panel_tiles": P21_OOC_PANEL_TILES},
          "seconds": {k: v[-1] for k, v in fsec.items()}, "seconds_runs": fsec,
          "launches": flaunch,
          "cholesky_2d_tflops": n ** 3 / 3 / fsec["cholesky_2d"][-1] / 1e12,
          "cholesky_1d_tflops": n ** 3 / 3 / fsec["cholesky_1d"][-1] / 1e12,
          "matmul3_bulk": {k: bulk[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "rel_err",
                                                 "rel_err_split_ref", "max_abs_err")},
          "nvidia_smi": card, **fbars})
    require(ortho <= ORTHO_BAR and resid <= QR_RESID_BAR,
            f"P21: sharded_tsqr ortho {ortho}, residual {resid}")
    for k, v in counts.items():
        require(v > 0, f"P21 (a): {k} was not launched")
    for name in FABRIC_MATMUL3 + ("cholqr3s_sharded",):
        require(flaunch[name]["matmul3"] > 0, f"P21 (a): {name} launched no matmul3")
    for c in list(flaunch.values()) + [bd_counts]:
        for k in counts:
            counts[k] += c[k]
    return counts


def p21_rank(torch, sizes: dict, small: dict, seed: int, device: str = "cuda") -> dict:
    """One rank of P21 (b): joins a gloo group of NPW_NUM_PROCESSES through
    the NPW_* variables (NCCL refuses two ranks on one card), runs the
    entry points on a 2 x 2 mesh, gathers each result (all_reduce), and
    rank 0 holds them to the bars and to the 1-rank results of the same
    calls on a mesh of its own. Every rank requires that it launched
    matmul3 and matmul (on a card) and imported no jax. Returns this
    rank's seconds and launches; rank 0 its checks too."""
    import numpy as np
    import torch.distributed as dist

    from numpywren_tpu_torch.parallel import distributed, make_mesh

    require(distributed.initialize(backend="gloo"), "P21 (b): not multi-process")
    rank = distributed.process_index()
    dev = None if device == "cuda" else device
    mesh = make_mesh(shape=(2, 2), device=dev)
    mesh1 = make_mesh(devices=[0], shape=(1, 1), device=dev)  # collective: every rank
    p21_warm(torch, mesh, small, seed, device)
    ops = p21_operands(torch, sizes, seed, device)
    tile = min(P21_TILE, sizes["n_chol"] // 2)
    tile_rows = min(P21_TILE_ROWS, sizes["m"] // 8)
    results, seconds, counts = p21_drive(torch, mesh, ops, tile, tile_rows)
    q, r = results["sharded_tsqr"]
    ortho, resid = p21_tsqr_quality(torch, mesh, ops["x"], q, r)
    full = p21_gather(torch, results)
    del results, q, r
    out = {"rank": rank, "seconds": seconds, "launches": counts,
           "device": str(ops["a"].device), "tsqr_ortho": ortho, "tsqr_residual": resid}
    if rank == 0:
        ref_results, ref_seconds, _ = p21_drive(torch, mesh1, ops, tile, tile_rows)
        ref = p21_gather(torch, ref_results)
        del ref_results
        out["one_rank_seconds"] = ref_seconds
        out.update(p21_bars(torch, ops, full, ref))
        del ref
    del full
    # the fabric entries on the 2 x 2 mesh, then (rank 0) on a 1-rank mesh
    fab = p21_fabric_operands(torch, sizes, seed, device)
    ooc_tile = min(SPILL_TILE, sizes["n_chol"] // 8)
    fres, fsec, flaunch = p21_fabric_drive(torch, mesh, ops, fab, tile, ooc_tile, "b")
    passes = flaunch["cholqr3s_sharded_kappa"]["chain_passes"]
    every = distributed.gather_to_hosts(np.array([passes["chains"], passes["extras"]]))
    fbars, whole = p21_fabric_bars(torch, mesh, ops, fab, fres)
    del fres
    out.update(fabric_seconds=fsec, fabric_launches=flaunch, chain_passes=passes, **fbars)
    if rank == 0:
        every = every.reshape(-1, 2)
        out["chain_passes_by_rank"] = every.tolist()
        require((every == every[0]).all(), f"P21 (b): the ranks' chain passes differ: {every}")
        ref_res, ref_sec, _ = p21_fabric_drive(torch, mesh1, ops, fab, tile, ooc_tile, "b")
        _, ref_whole = p21_fabric_bars(torch, mesh1, ops, fab, ref_res)
        del ref_res
        out["fabric_one_rank_seconds"] = ref_sec
        out.update(p21_fabric_agree(torch, whole, ref_whole))
        del ref_whole
    del whole, fab, ops
    bout, blaunch = p21_bdfac_rank(torch, mesh, mesh1, sizes, seed, device)
    out.update(bout)
    dist.barrier()
    require("jax" not in sys.modules, f"P21 (b) rank {rank}: jax was imported")
    require("numpywren_tpu" not in sys.modules,
            f"P21 (b) rank {rank}: the JAX package was imported")
    require(ortho <= ORTHO_BAR and resid <= QR_RESID_BAR,
            f"P21 (b) rank {rank}: sharded_tsqr ortho {ortho}, residual {resid}")
    if device == "cuda":  # the plain versions on the CPU launch nothing
        for k, v in counts.items():
            require(v > 0, f"P21 (b) rank {rank}: {k} was not launched")
        for name in FABRIC_MATMUL3 + ("cholqr3s_sharded_kappa",):
            require(flaunch[name]["matmul3"] > 0,
                    f"P21 (b) rank {rank}: {name} launched no matmul3")
    for c in list(flaunch.values()) + list(blaunch.values()):
        for k in counts:
            counts[k] += c[k]
    dist.destroy_process_group()
    return out


def run_ranks(phase: str, func: str, ranks: int, args: list, env: dict, timeout: int) -> list:
    """chip_smoke.<func>(torch, *args) in `ranks` processes joined through
    the NPW_* variables on a free localhost port, each returning its result
    as JSON on its last line. A rank that fails fails the phase: the others
    get a grace period, then every process still running is killed."""
    import tempfile

    port = free_port()
    code = ("import json, sys, torch, chip_smoke; print(json.dumps(getattr("
            "chip_smoke, sys.argv[1])(torch, *json.loads(sys.argv[2]))), flush=True)")
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        for rank in range(ranks):
            e = dict(os.environ, **env, NPW_COORDINATOR=f"127.0.0.1:{port}",
                     NPW_NUM_PROCESSES=str(ranks), NPW_PROCESS_ID=str(rank))
            out = open(os.path.join(tmp, f"{rank}.out"), "w+")
            err = open(os.path.join(tmp, f"{rank}.err"), "w+")
            procs.append((subprocess.Popen([sys.executable, "-c", code, func, json.dumps(args)],
                                           cwd=here, env=e, stdout=out, stderr=err), out, err))
        deadline, failed_at = time.time() + timeout, None
        try:
            while any(p.poll() is None for p, _, _ in procs):
                if failed_at is None and any(p.poll() not in (None, 0) for p, _, _ in procs):
                    failed_at = time.time()
                if time.time() > deadline or (failed_at and time.time() > failed_at + 30):
                    break
                time.sleep(0.2)
        finally:
            for p, _, _ in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results, bad = [], []
        for rank, (p, out, err) in enumerate(procs):
            out.seek(0)
            err.seek(0)
            lines, tail = out.read().splitlines(), err.read()[-3000:]
            out.close()
            err.close()
            if p.returncode != 0 or not lines:
                bad.append(f"rank {rank} exit {p.returncode}: {tail}")
                continue
            results.append(json.loads(lines[-1]))
    require(not bad, f"{phase}: " + "\n".join(bad))
    return results


def p21_multi(torch, sizes: dict, small: dict, seed: int, device: str = "cuda") -> dict:
    """P21 (b): P21_RANKS processes on the one card (run_ranks), compensated.
    Their times are four processes time-sharing one card: no scaling claim
    is made from them. Returns the launches summed over the ranks."""
    t0 = time.perf_counter()
    # a rehearsal's ranks share the host's cores: one OpenMP thread each
    env = {"NPW_COMPENSATED": "1", **({"OMP_NUM_THREADS": "1"} if device == "cpu" else {})}
    ranks = run_ranks("P21 (b)", "p21_rank", P21_RANKS, [sizes, small, seed, device], env,
                      P21_TIMEOUT)
    counts = {"matmul": 0, "matmul3": 0}
    for res in ranks:
        emit({"phase": "P21", "part": "b", "ranks": P21_RANKS, "mesh": [2, 2],
              "backend": "gloo", "config": "compensated", "sizes": sizes,
              "note": "four processes time-sharing one card", **res})
        for k in counts:
            counts[k] += res["launches"][k]
    emit({"phase": "P21", "part": "b", "seconds": time.perf_counter() - t0, "launches": counts})
    return counts


# ---------------------------------------------------------------------------
# P22: the aux modules (numpywren_tpu_torch.metrics, .cli, .__main__)
# ---------------------------------------------------------------------------

METER_BAR = 0.10       # FlopMeter's wall_s against cuda_ms of the same body, relative
METER_CALLS = 20       # the metered body: matmul3 calls at P22_METER_N³
P22_METER_N = 8192
DOCTOR_CHECKS = 4


def cli_run(args: list, timeout: int = 300):
    """`python -m numpywren_tpu_torch <args>` from the checkout's root, as
    a user runs it."""
    return subprocess.run([sys.executable, "-m", "numpywren_tpu_torch", *args],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=timeout)


def ok_lines(out: str) -> int:
    return sum(ln.startswith("ok   ") for ln in out.splitlines())


def p2_operand(torch, npw, n: int, seed: int):
    """P2's A = X Xᵀ/n + 2I, symmetric, flat on the card."""
    return symmetric_from_lower(npw.TrapezoidMatrix(spd_columns(torch, n, PANEL, seed), n,
                                                    PANEL).to_array())


def require_panel_route(gemm3, phase: str, n: int) -> tuple:
    """matmul3's (calls, device launches) since the counts were zeroed,
    required equal to those one compensated Cholesky of n implies."""
    got, want = (gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES), panel_route_counts(n, PANEL,
                                                                             min(128, PANEL))
    require(got == want, f"{phase}: matmul3 (calls, device launches) {got}, the panel route "
                         f"implies {want}")
    return got


def p22_trace(torch, n: int, seed: int) -> dict:
    """One warm compensated cholesky_trapezoid of P2's operand under
    metrics.trace, in the process that calls it (P22 runs it
    in_new_process: a process's later profiler sessions can lose device
    records). Requires one trace file naming the split GEMM's mainloop and
    cholesky_ex's kernels, matmul3's calls and device launches as
    panel_route_counts gives them, and the factor's residual."""
    import glob
    import tempfile

    import numpywren_tpu_torch as npw
    from numpywren_tpu_torch import metrics
    from numpywren_tpu_torch.ops import gemm3

    npw.default_config().compensated = True
    w = torch.randn(2048, 2048, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    w = w @ w.T / 2048 + 2 * torch.eye(2048, device="cuda")
    npw.cholesky_trapezoid(npw.TrapezoidMatrix.from_array(w, panel=PANEL))  # warm-up
    a = p2_operand(torch, npw, n, seed)
    t = npw.TrapezoidMatrix.from_array(a, panel=PANEL)
    torch.cuda.synchronize()
    gemm3.LAUNCHES = gemm3.DEVICE_LAUNCHES = 0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with metrics.trace(d):
            l = npw.cholesky_trapezoid(t)
        seconds = time.perf_counter() - t0
        files = glob.glob(os.path.join(d, "*.pt.trace.json"))
        require(len(files) == 1, f"P22 trace: {len(files)} trace files written")
        file_bytes = os.path.getsize(files[0])
        with open(files[0]) as f:
            kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    counts = require_panel_route(gemm3, "P22 trace", n)
    split = [k for k in kernels if "gemm_split_" in k]
    mainloop = [k for k in split if "gemm_split_pack" not in k]
    chol = [k for k in kernels if "getrf" in k or "potrf" in k]  # as cholesky_profile groups
    require(bool(mainloop), "P22 trace: no gemm_split_ mainloop kernel in the trace")
    require(bool(chol), "P22 trace: no cholesky_ex kernel in the trace")
    resid = residual(torch, a, l.to_array())
    require(resid <= RESID_BAR, f"P22 trace: residual {resid} > {RESID_BAR}")
    return {"n": n, "seconds": seconds, "trace_bytes": file_bytes, "kernels": len(kernels),
            "gemm_split_kernels": len(split), "mainloop_kernels": len(mainloop),
            "cholesky_ex_kernels": len(chol), "mainloop_name": mainloop[0][:120],
            "cholesky_ex_names": sorted({k[:80] for k in chol})[:4],
            "matmul3_calls": counts[0], "matmul3_device_launches": counts[1],
            "residual": resid}


def p22_aux(torch, npw, gen, n: int, n_local: int, seed: int, p2_tflops: float) -> dict:
    """P22: the aux modules as a user reaches them. `info` and `doctor`
    through `python -m numpywren_tpu_torch`, `doctor` in process with its
    kernel launch counted; `metrics.trace` around P2's Cholesky (a new
    process); `FlopMeter` against cuda_ms of the same body, in turns, then
    around P2's Cholesky; `level_report` and `log_program` of a "local"
    Cholesky at P16's size. Returns the kernels' launches of the path."""
    import contextlib
    import io
    import logging

    from numpywren_tpu_torch import cli, metrics
    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.ops import gemm3
    from numpywren_tpu_torch.parallel.mesh import _factor_2d

    gemm = gemm_module()
    cfg = npw.default_config()
    cfg.compensated = False  # the user's default
    t_phase = time.perf_counter()
    launches = {"matmul": 0, "matmul3": 0}

    # info, as a user runs it
    t0 = time.perf_counter()
    proc = cli_run(["info"])
    require(proc.returncode == 0, f"P22 info: rc {proc.returncode}: {proc.stderr[-2000:]}")
    try:
        info = json.loads(proc.stdout)
    except json.JSONDecodeError as e:
        raise SmokeFailure(f"P22 info: not JSON ({e}): {proc.stdout[-2000:]}") from e
    count = torch.cuda.device_count()
    require(info["backend"] == "gpu" and len(info["devices"]) == count,
            f"P22 info: backend {info['backend']}, {len(info['devices'])} devices of {count}")
    require(all(d["kind"] == torch.cuda.get_device_name(d["id"]) for d in info["devices"]),
            f"P22 info: devices {info['devices']}")
    total = torch.cuda.get_device_properties(0).total_memory
    require(info["hbm_bytes_limit"] == total,
            f"P22 info: hbm_bytes_limit {info['hbm_bytes_limit']}, the card has {total}")
    require(tuple(info["default_mesh"]) == _factor_2d(count),
            f"P22 info: default_mesh {info['default_mesh']}")
    emit({"phase": "P22", "check": "info", "seconds": time.perf_counter() - t0, **info})

    # doctor, in process: its kernel check is one matmul call, three device launches
    t0 = time.perf_counter()
    calls, device = gemm.LAUNCHES, gemm.DEVICE_LAUNCHES
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["doctor"])
    calls, device = gemm.LAUNCHES - calls, gemm.DEVICE_LAUNCHES - device
    lines = out.getvalue().splitlines()
    require(rc == 0 and ok_lines(out.getvalue()) == DOCTOR_CHECKS,
            f"P22 doctor: rc {rc}: {lines}")
    require((calls, device) == (1, 3),
            f"P22 doctor: matmul (calls, device launches) {(calls, device)}, expected (1, 3)")
    launches["matmul"] += calls
    in_process_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = cli_run(["doctor"])
    require(proc.returncode == 0 and ok_lines(proc.stdout) == DOCTOR_CHECKS,
            f"P22 python -m doctor: rc {proc.returncode}: {proc.stdout[-2000:]} "
            f"{proc.stderr[-2000:]}")
    emit({"phase": "P22", "check": "doctor", "lines": lines, "matmul_calls": calls,
          "matmul_device_launches": device, "seconds": in_process_s,
          "python_m_seconds": time.perf_counter() - t0})

    # metrics.trace around P2's Cholesky, in a new process
    t0 = time.perf_counter()
    tr = in_new_process("P22", "p22_trace", n, seed)
    launches["matmul3"] += tr["matmul3_calls"]
    emit({"phase": "P22", "check": "trace", **tr, "process_seconds": time.perf_counter() - t0})

    # FlopMeter against cuda_ms: a body whose device work far outlasts its enqueue
    m_ = P22_METER_N
    a, b, c, o = (torch.randn(m_, m_, generator=gen, device="cuda") for _ in range(4))

    def body():
        for _ in range(METER_CALLS):
            gemm3.matmul3(a, b, c, tb=True, out=o)

    def metered():
        with metrics.FlopMeter(flops=METER_CALLS * 2 * m_ ** 3, label="matmul3") as m:
            body()
        return m.wall_s * 1e3

    body()
    torch.cuda.synchronize()
    meter_ms = [metered()]
    events_ms = [cuda_ms(torch, body, 1), cuda_ms(torch, body, 1)]
    meter_ms.append(metered())
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    body()
    enqueue_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    mean_meter, mean_events = sum(meter_ms) / 2, sum(events_ms) / 2
    ratio = mean_meter / mean_events
    emit({"phase": "P22", "check": "flop_meter", "body": f"{METER_CALLS} matmul3 at {m_}^3",
          "meter_ms": meter_ms, "cuda_ms": events_ms, "enqueue_ms": enqueue_ms,
          "ratio": ratio})
    require(abs(ratio - 1) <= METER_BAR,
            f"P22 FlopMeter: {mean_meter} ms against cuda_ms {mean_events} ms")
    del a, b, c, o

    # FlopMeter around P2's Cholesky, compensated
    cfg.compensated = True
    a = p2_operand(torch, npw, n, seed)
    t = npw.TrapezoidMatrix.from_array(a, panel=PANEL)
    torch.cuda.synchronize()
    gemm3.LAUNCHES = gemm3.DEVICE_LAUNCHES = 0
    with metrics.FlopMeter(flops=n ** 3 / 3, label="cholesky_trapezoid") as m:
        l = npw.cholesky_trapezoid(t)
    counts = require_panel_route(gemm3, "P22 meter", n)
    launches["matmul3"] += counts[0]
    resid = residual(torch, a, l.to_array())
    emit({"phase": "P22", "check": "flop_meter_cholesky", "n": n, "config": "compensated",
          "wall_s": m.wall_s, "tflops": m.tflops, "p2_tflops": p2_tflops, "residual": resid,
          "matmul3_calls": counts[0], "matmul3_device_launches": counts[1]})
    require(resid <= RESID_BAR, f"P22 meter: residual {resid} > {RESID_BAR}")
    cfg.compensated = False
    del a, t, l
    torch.cuda.empty_cache()

    # level_report and log_program of a "local" Cholesky at P16's size, fault-free
    a = spd_flat(torch, gen, n_local)
    prog, lo, _ = npw.cholesky(shard_matrix(a, tile=(256, 256), storage="host"), storage="host")
    status = npw.run_program(prog, executor="local")
    require(status.name == "SUCCESS", f"P22 level_report: status {status.name}")
    resid = residual(torch, a, lo.to_hbm().array[:n_local, :n_local])
    require(resid <= RESID_BAR, f"P22 level_report: residual {resid}")
    recs = metrics.level_report(prog)
    node_flops = sum(prog.node_flops(i) for i in range(prog.num_nodes))
    require(len(recs) == len(prog.levels), f"P22 level_report: {len(recs)} records, "
                                           f"{len(prog.levels)} levels")
    require(sum(sum(r["ops"].values()) for r in recs) == prog.num_nodes,
            "P22 level_report: the ops do not sum to num_nodes")
    require(sum(r["flops"] for r in recs) == node_flops,
            "P22 level_report: the flops do not sum to node_flops")
    require(all("wall_s" in r for r in recs), "P22 level_report: a level without wall_s")

    class Collect(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    lg, handler = logging.getLogger("numpywren_tpu_torch"), Collect()
    level = lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    try:
        metrics.log_program(prog)
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)
    steps = [msg for msg in handler.messages if msg.startswith("npw-step ")]
    require(len(steps) == len(prog.levels),
            f"P22 log_program: {len(steps)} npw-step lines for {len(prog.levels)} levels")
    emit({"phase": "P22", "check": "level_report", "n": n_local, "tile": 256,
          "executor": "local", "levels": len(recs), "nodes": prog.num_nodes,
          "flops": node_flops, "residual": resid, "npw_step_lines": len(steps),
          "first": recs[0], "last": recs[-1]})
    emit({"phase": "P22", "seconds": time.perf_counter() - t_phase, "launches": launches})
    return launches



# ---------------------------------------------------------------------------
# P23: the benchmark harness, bench_torch.py
# ---------------------------------------------------------------------------

P23_TIMEOUT = 900        # seconds for one bench process (the flagship's two stages the longest)
P23_ROUTE_BAR = 0.05     # a bench Cholesky's TFLOP/s against the same route's phase, relative
P23_PEAK_BAR = 1.05      # a bench Cholesky's frac_of_matmul_peak's upper bar
TSQR_GRAM_BAR = 1e-4     # cholqr3s's Gram parity: its chain stops at conv_tol 1e-4
P23_RUNS = (  # (label, arguments after `bench`, extra environment, route, the phase beside it)
    ("flagship", ["--alg", "cholesky"], {"NPW_COMPENSATED": "1"}, "matmul3", "P2"),
    ("cholesky_high", ["--alg", "cholesky", "--n", "32768"], {}, "torch_fp32", "P4"),
    ("cholesky_highest", ["--alg", "cholesky", "--n", "32768", "--precision", "highest"], {},
     "matmul", "P3"),
    ("gemm", ["--alg", "gemm"], {}, "torch_fp32", "P12"),
    ("gemm_compensated", ["--alg", "gemm"], {"NPW_COMPENSATED": "1"}, "matmul3",
     "P12_compensated"),
    ("tsqr_cholqr3s", ["--alg", "tsqr", "--tsqr-method", "cholqr3s"], {}, "torch_fp32", None),
    ("bdfac", ["--alg", "bdfac"], {}, "torch_fp32", "P19"),
    ("numerics", ["--numerics"], {}, None, None),
)
P23_FLAGSHIP = [f"cholesky_n{n}_float32_compensated_tflops" for n in (32768, 65536)]
P23_N = 32768            # the bench's Cholesky size beside P2-P4 (the flagship's quick stage)


def p23_route_tflops(torch, n: int, seed: int) -> dict:
    """P2's factorization (cholesky_trapezoid of P2's operand, panels of
    1024) by each route, compensated (P2's), "highest" (P3's) and the
    default (P4's): the best TFLOP/s of three warm runs each, CUDA events.
    P23 runs it in a new process, as each bench run is one, and compares a
    best with a best: a single reading in this long process can come out a
    few percent low (P2 read 84.50 beside 87.00-88.78 in other runs)."""
    import numpywren_tpu_torch as npw

    cfg = npw.default_config()
    a = p2_operand(torch, npw, n, seed)
    out = {}
    for phase, comp, precision in (("P2", True, None), ("P3", False, "highest"),
                                   ("P4", False, None)):
        cfg.compensated = comp
        seconds = []
        for _ in range(4):  # a warm-up, then three
            t = npw.TrapezoidMatrix.from_array(a, panel=PANEL)
            seconds.append(run_entry(torch, lambda: npw.cholesky_trapezoid(
                t, precision=precision))[2])
            del t
        out[phase] = n ** 3 / 3 / min(seconds[1:]) / 1e12
    cfg.compensated = False
    return out


def bench_run(args: list, env: dict, lastgood: str):
    """`python -m numpywren_tpu_torch bench <args>` from the checkout's root
    in a new process, its last good line at `lastgood` and `env` over this
    process's environment (NPW_COMPENSATED only where `env` sets it).
    Returns (rc, its JSON lines, seconds, the end of its stderr)."""
    full = {k: v for k, v in os.environ.items() if k != "NPW_COMPENSATED"}
    full.update(env, NPW_BENCH_LASTGOOD=lastgood)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "numpywren_tpu_torch", "bench", *args],
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=full,
                          capture_output=True, text=True, timeout=P23_TIMEOUT)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return proc.returncode, lines, time.perf_counter() - t0, proc.stderr[-3000:]


def p23_bench(torch, gen, refs: dict, seed: int) -> dict:
    """P23: bench_torch.py through the command line, each run in a new
    process, held to the bars of the module docstring and set beside the
    earlier phase that `refs` holds for it (P2, P3, P4: TFLOP/s; P12,
    P12_compensated: TFLOP/s; P19: the tile-512 sweeps' seconds by route).
    A bench Cholesky at P23_N is within 5% of its phase's reading, or of
    the same route's best of three in a new process (p23_route_tflops).
    Then matmul3's panel route at the 65536 stage's first trailing updates.
    Returns the kernels' launches of the bench runs."""
    import tempfile

    from numpywren_tpu_torch.ops import gemm3

    card = gpu_line()
    t_phase = time.perf_counter()
    launches = {"matmul": 0, "matmul3": 0}
    fresh = in_new_process("P23", "p23_route_tflops", P23_N, seed)
    emit({"phase": "P23", "run": "route_tflops", "n": P23_N, "fresh_best_of_3": fresh,
          "phases": {k: refs[k] for k in fresh}, "nvidia_smi": card})
    with tempfile.TemporaryDirectory() as d:
        for label, args, env, route, phase in P23_RUNS:
            rc, lines, seconds, err = bench_run(args, env, os.path.join(d, "lastgood.json"))
            emit({"phase": "P23", "run": label, "args": args, "env": env, "rc": rc,
                  "seconds": seconds, "lines": lines, "nvidia_smi": card})
            require(rc == 0 and lines, f"P23 {label}: rc {rc}, {len(lines)} lines: {err}")
            if route is None:  # the numerics gate: one line, every rung passing
                failed = [k for k, v in lines[-1]["rungs"].items() if not v["pass"]]
                require(lines[-1]["vs_baseline"] == 1.0 and not failed,
                        f"P23 numerics: rungs failed {failed}")
                continue
            # a provisional line (another run's, from the last-good file) may come first
            real = [ln for ln in lines if not ln.get("stale")]
            require(bool(real) and real == lines[len(lines) - len(real):],
                    f"P23 {label}: the measured lines are not last: {lines}")
            for ln in real:
                used = ln["launches"]
                for kern in launches:
                    launches[kern] += used[kern]
                require(ln["route"] == route and ln["value"] > 0
                        and {k: v > 0 for k, v in used.items()} == {k: k == route for k in used}
                        and ln["device"] == torch.cuda.get_device_name(0),
                        f"P23 {label}: {ln['metric']} on route {ln['route']}, launches {used}")
            if label == "flagship":
                require([ln["metric"] for ln in real] == P23_FLAGSHIP,
                        f"P23 flagship: {[ln['metric'] for ln in real]}, not {P23_FLAGSHIP}")
            if label == "tsqr_cholqr3s":
                require(real[-1]["gram_rel_err"] <= TSQR_GRAM_BAR,
                        f"P23 tsqr: gram_rel_err {real[-1]['gram_rel_err']} > {TSQR_GRAM_BAR}")
            row = {"phase": "P23", "run": label, "tflops": [ln["value"] for ln in real]}
            if phase is not None:
                row[phase] = refs[phase]
            if phase in fresh:  # a Cholesky: its P23_N line against the phase and the best of 3
                require(real[0]["metric"].startswith(f"cholesky_n{P23_N}_"),
                        f"P23 {label}: {real[0]['metric']}")
                row.update({"over_" + phase: real[0]["value"] / refs[phase],
                            "over_fresh": real[0]["value"] / fresh[phase]})
            emit(row)
            if phase in fresh:
                for ln in real:
                    require(ln["residual_fro"] <= RESID_BAR and ln["residual_full"] is True,
                            f"P23 {label} {ln['metric']}: residual {ln['residual_fro']}")
                    require(0 < ln["frac_of_matmul_peak"] <= P23_PEAK_BAR,
                            f"P23 {label} {ln['metric']}: frac_of_matmul_peak "
                            f"{ln['frac_of_matmul_peak']}")
                require(min(abs(row["over_" + phase] - 1), abs(row["over_fresh"] - 1))
                        <= P23_ROUTE_BAR,
                        f"P23 {label}: {real[0]['value']} TFLOP/s against {phase}'s "
                        f"{refs[phase]} and the best of three {fresh[phase]}")
    # the kernel at the 65536 stage's shapes: its first two trailing updates
    before = gemm3.LAUNCHES
    matmul3_panel_rows(torch, gen, 65536 - PANEL, phase="P23")
    require(gemm3.LAUNCHES > before, "P23: matmul3's panel route did not launch")
    emit({"phase": "P23", "seconds": time.perf_counter() - t_phase, "launches": launches,
          "nvidia_smi": card})
    return launches


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
    ap.add_argument("--m-rand", type=int, default=65536, help="P18's randomized PCA rows")
    ap.add_argument("--n-rand", type=int, default=4096, help="P18's randomized PCA columns")
    ap.add_argument("--n-jacobi", type=int, default=4096, help="P18's square Jacobi SVD size")
    ap.add_argument("--m-jacobi", type=int, default=65536, help="P18's tall Jacobi SVD rows")
    ap.add_argument("--n-jacobi-tall", type=int, default=1024,
                    help="P18's tall Jacobi SVD columns")
    ap.add_argument("--n-bdfac-kappa", type=int, default=4096,
                    help="P19's kappa 1e6 BDFAC size (its Gaussian runs take --n-bdfac)")
    ap.add_argument("--n-sv", type=int, default=4096, help="P19's singular_values size")
    ap.add_argument("--n-sv-default", type=int, default=2560,
                    help="P19's singular_values size with the default tile")
    ap.add_argument("--n-svd", type=int, default=2048, help="P19's svd size")
    ap.add_argument("--n-ooc", type=int, default=32768,
                    help="P20's large out-of-core BDFAC size (its other runs take --n-bdfac)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.n % PANEL:
        raise SmokeFailure(f"--n must be a multiple of {PANEL}")
    if args.n_spill % SPILL_TILE or args.n_spill_small % SPILL_TILE:
        raise SmokeFailure(f"--n-spill and --n-spill-small must be multiples of {SPILL_TILE}")
    if args.n_jacobi % (2 * JACOBI_BLOCK):
        raise SmokeFailure(f"--n-jacobi must be a multiple of {2 * JACOBI_BLOCK}")
    if args.n_bdfac % 1024 or args.n_sv % 1024 or args.n_bdfac_kappa % 256:
        raise SmokeFailure("--n-bdfac and --n-sv must be multiples of 1024, "
                           "--n-bdfac-kappa of 256")
    ooc_w = OOC_TILE * OOC_PANEL_TILES
    if args.n_bdfac % ooc_w or args.n_ooc % ooc_w:
        raise SmokeFailure(f"--n-bdfac and --n-ooc must be multiples of {ooc_w}")

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
    launches, (p2_row, p3_row, p4_row) = main_path(torch, npw, args.n, args.n_flat, args.seed)
    p6 = p6_factor(torch, gen)
    ops_counts = p6_ops_path(torch, gen)
    p7 = p7_chain(torch, gen, args.m)
    tsqr_counts = tsqr_phases(torch, npw, gen, args.m, args.m_small)
    p12_launches, p12_tflops = p12_gemm(torch, npw, gen, args.n_gemm)
    launches["matmul3"] += p12_launches
    p13 = p13_qr(torch, gen)
    launches["qr"] = p14_qr_leaf(torch, gen, args.m_qr)
    p15_generic(torch, npw, gen, args.n_dsl, args.n_gemm_dsl, args.m_tsqr_dsl, args.n_bdfac,
                args.tile_bdfac)
    p16_host_tier(torch, npw, gen, args.n_dsl, args.n_local)
    spill_launches, _ = p17_spill(torch, npw, args.n_spill, args.n_spill_small, args.seed)
    model_launches, jacobi = p18_models(torch, gen, args.m, args.m_rand, args.n_rand,
                                        args.n_jacobi, args.m_jacobi, args.n_jacobi_tall)
    bdfac_launches, _, bdfac = p19_bdfac(torch, npw, args.n_bdfac, args.n_bdfac_kappa, args.n_sv,
                                         args.n_svd, args.seed, args.n_sv_default)
    qdwh_launches, _ = p20_qdwh_ooc(torch, jacobi, bdfac, args.n_ooc, args.seed)
    del jacobi  # P19's operands stay for P21 (a)'s BDFAC
    torch.cuda.empty_cache()
    p21a = p21_single(torch, npw, {"n_chol": args.n, "n_gemm": args.n_gemm, "m": args.m, "b": 512},
                      P21_SMALL, args.seed, p2_row["seconds"], bdfac, args.n_ooc)
    p19_seconds = bdfac["tile512_seconds"]
    del bdfac
    torch.cuda.empty_cache()
    p21b = p21_multi(torch, {"n_chol": P21B_N_CHOL, "n_gemm": args.n_gemm, "m": args.m, "b": 512,
                             "n_bdfac": args.n_bdfac, "n_sv": P21_SV_N},
                     P21_SMALL, args.seed)
    p22 = p22_aux(torch, npw, gen, args.n, args.n_local, args.seed, p2_row["tflops"])
    torch.cuda.empty_cache()  # the bench's processes need the card's memory
    p23 = p23_bench(torch, gen, {"P2": p2_row["tflops"], "P3": p3_row["tflops"],
                                 "P4": p4_row["tflops"], "P12": p12_tflops["default"],
                                 "P12_compensated": p12_tflops["compensated"],
                                 "P19": p19_seconds}, args.seed)
    for name in ("matmul", "matmul3"):
        launches[name] += spill_launches[name]
    launches["matmul"] += ops_counts["matmul"]
    launches.update(potrf=ops_counts["potrf"], trtri=ops_counts["trtri"], **tsqr_counts)
    for counts in (model_launches, bdfac_launches, qdwh_launches, p21a, p21b, p22, p23):
        for name, n in counts.items():
            launches[name] += n

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
