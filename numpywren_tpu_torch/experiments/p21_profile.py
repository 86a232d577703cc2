#!/usr/bin/env python3
"""Where the multi-device layer's time goes on one card: chip_smoke.py's P21
calls at its sizes, each in a fresh process, compensated.

    python3 numpywren_tpu_torch/experiments/p21_profile.py   # with a GPU

- cholesky: `sharded_cholesky` at 32768, tile 1024, on a 1 x 1 mesh of a
  1-rank NCCL group (P21 (a)), one warm call under torch.profiler: the
  call's ms (CUDA events), the device's busy ms (the union of its
  activities), and the device ms and count of each kernel name, with the
  GEMM kernels' (gemm_split_*: matmul3 and matmul) summed apart;
- tsqr: `sharded_tsqr` with Q on 1,048,576 x 512, tile_rows 4096, on the
  same mesh, one warm call with every `torch.linalg.qr` between two CUDA
  events: the leaves' batched QR (256 x 4096 x 512), the combine tree's
  (g x 1024 x 512), the mesh combine's (512 x 512), and the rest of the
  call (the Q sweep's products, the local Q times its combine block, pads
  and copies). Not under torch.profiler: with it this part did not end
  within 600 s on an H100;
- gloo: four processes on the one card in a gloo group, a 2 x 2 mesh
  (P21 (b)): `sharded_cholesky` at 16384, tile 1024, once as it is and once
  with every broadcast and all_reduce timed (the stream synchronized
  before each, the host clock around it) with its bytes; then each
  collective's rate alone, on a 32 MiB CUDA tensor and on the same bytes
  in host memory, in the rank's mesh-row group.

Prints one JSON line a measurement, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout's root
sys.path.insert(0, str(ROOT))

N_CHOL, N_CHOL_B, TILE = 32768, 16384, 1024
M, B, TILE_ROWS = 1 << 20, 512, 4096
RANKS = 4
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def spd(n: int, device) -> torch.Tensor:
    """X Xᵀ/n + 2I from a seeded Gaussian X, symmetric bit for bit."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(n, n, generator=gen, device=device)
    a = x @ x.T / n
    del x
    a.diagonal().add_(2.0)
    low = a.tril()
    return low + low.tril(-1).T


def join(ranks: int, backend=None) -> None:
    """This process's rank of a group of `ranks` through the NPW_* variables
    (a 1-rank group sets its own)."""
    from numpywren_tpu_torch.parallel import distributed

    if ranks == 1:
        port = free_port()
        os.environ.update(NPW_COORDINATOR=f"127.0.0.1:{port}", NPW_NUM_PROCESSES="1",
                          NPW_PROCESS_ID="0")
    distributed.initialize(backend=backend)
    import numpywren_tpu_torch as npw

    npw.default_config().compensated = True


def dist_close() -> None:
    import torch.distributed as dist

    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def profiled(fn):
    """One warm fn() under torch.profiler: (the profiler's events, the
    call's ms by CUDA events, the device's busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    events = prof.events()
    intervals, total, last = sorted((e.time_range.start, e.time_range.end) for e in events
                                    if e.device_type == DeviceType.CUDA), 0.0, None
    for a, b in intervals:  # the union of the device's activities
        if last is None or a > last:
            total, last = total + (b - a), b
        elif b > last:
            total, last = total + (b - last), b
    return events, start.elapsed_time(end), total / 1e3


def device_ms_by_name(events) -> dict:
    """{kernel or copy name: (device ms, count)} of the device activities."""
    from torch.autograd import DeviceType

    out = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            ms, count = out.get(e.name, (0.0, 0))
            out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    return out


def part_cholesky() -> None:
    from numpywren_tpu_torch.parallel import make_mesh, sharded_cholesky

    join(1)
    mesh = make_mesh()
    a = spd(N_CHOL, "cuda")
    work = torch.empty_like(a)
    # the call factors a fresh copy of A (a device-to-device copy of 4 GiB)
    events, call_ms, busy_ms = profiled(lambda: sharded_cholesky(work.copy_(a), TILE, mesh))
    by_kernel = device_ms_by_name(events)
    gemm_ms = sum(ms for k, (ms, _) in by_kernel.items() if "gemm_split" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"part": "cholesky", "n": N_CHOL, "tile": TILE, "mesh": [1, 1],
          "call_ms": call_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / call_ms,
          "gemm_split_ms": gemm_ms, "gemm_split_share_of_busy": gemm_ms / busy_ms,
          "kernels": [{"name": k[:120], "ms": ms, "count": n} for k, (ms, n) in top]})
    dist_close()


def part_tsqr() -> None:
    from numpywren_tpu_torch.parallel import make_mesh, sharded_tsqr

    join(1)
    mesh = make_mesh()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(M, B, generator=gen, device="cuda")
    spans = []  # (the QR's input shape, its start and end events)
    real_qr = torch.linalg.qr

    def timed_qr(a, *args, **kw):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = real_qr(a, *args, **kw)
        ev[1].record()
        spans.append((tuple(a.shape), *ev))
        return out

    call = lambda: sharded_tsqr(x, TILE_ROWS, mesh, compute_q=True)  # noqa: E731
    call()
    torch.linalg.qr = timed_qr
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    torch.linalg.qr = real_qr
    qr_ms = {}
    for shape, t0, t1 in spans:
        ms, count = qr_ms.get(str(list(shape)), (0.0, 0))
        qr_ms[str(list(shape))] = (ms + t0.elapsed_time(t1), count + 1)
    call_ms = start.elapsed_time(end)
    leaf = qr_ms.pop(str([M // TILE_ROWS, TILE_ROWS, B]))[0]
    mesh_combine = qr_ms.pop(str([B, B]))[0]
    tree = sum(ms for ms, _ in qr_ms.values())
    # the rest: the Q sweep's products, the mesh combine's Q product, the pads and copies
    emit({"part": "tsqr", "m": M, "b": B, "tile_rows": TILE_ROWS, "mesh": [1, 1],
          "call_ms": call_ms, "leaf_qr_ms": leaf, "tree_qr_ms": tree,
          "tree_qr_by_shape": {k: v for k, v in qr_ms.items()},
          "mesh_combine_qr_ms": mesh_combine, "rest_ms": call_ms - leaf - tree - mesh_combine})
    dist_close()


def part_gloo_rank() -> None:
    import torch.distributed as dist

    from numpywren_tpu_torch.parallel import distributed, make_mesh, sharded_cholesky
    from numpywren_tpu_torch.parallel.mesh import as_dtensor, local_block, tile_sharding

    join(RANKS, backend="gloo")
    rank = distributed.process_index()
    mesh = make_mesh(shape=(2, 2))
    sh = tile_sharding(mesh)
    small = spd(2048, "cuda")
    sharded_cholesky(as_dtensor(local_block(small, sh).clone(), small.shape, sh), 256, mesh)
    a = spd(N_CHOL_B, "cuda")
    blk = local_block(a, sh)
    del a

    def once() -> float:
        inp = as_dtensor(blk.clone(), (N_CHOL_B, N_CHOL_B), sh)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded_cholesky(inp, TILE, mesh)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain_s = once()
    spent = {"broadcast": [0.0, 0, 0], "all_reduce": [0.0, 0, 0]}
    real = {"broadcast": dist.broadcast, "all_reduce": dist.all_reduce}

    def timed(name):
        def call(tensor, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](tensor, *args, **kw)
            torch.cuda.synchronize()
            s = spent[name]
            s[0] += time.perf_counter() - t0
            s[1] += 1
            s[2] += tensor.numel() * tensor.element_size()
            return out
        return call

    dist.broadcast, dist.all_reduce = timed("broadcast"), timed("all_reduce")
    timed_s = once()
    dist.broadcast, dist.all_reduce = real["broadcast"], real["all_reduce"]
    group = mesh.get_group("cols")  # the two ranks of this rank's mesh row
    root = int(mesh.mesh[mesh.get_coordinate()[0], 0])
    rates = {}
    for where in ("cuda", "cpu"):
        buf = torch.ones(8192, 1024, device=where)
        for name, call in (("broadcast", lambda: dist.broadcast(buf, src=root, group=group)),
                           ("all_reduce", lambda: dist.all_reduce(buf, group=group))):
            call()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            rates[f"{name}_{where}_gb_s"] = 5 * buf.numel() * 4 / (time.perf_counter() - t0) / 1e9
    emit({"rank": rank, "seconds": plain_s, "seconds_timed": timed_s,
          "collective_seconds": {k: v[0] for k, v in spent.items()},
          "collective_calls": {k: v[1] for k, v in spent.items()},
          "collective_bytes": {k: v[2] for k, v in spent.items()}, "rates_32mib": rates})
    dist.destroy_process_group()


def run(part: str, ranks: int = 1) -> list:
    """This script's `part` in `ranks` fresh processes (joined through the
    NPW_* variables when more than one); their JSON lines."""
    env = dict(os.environ)
    if ranks > 1:
        env.update(NPW_COORDINATOR=f"127.0.0.1:{free_port()}", NPW_NUM_PROCESSES=str(ranks))
    procs = [subprocess.Popen([sys.executable, __file__, part], text=True, stdout=subprocess.PIPE,
                              env=dict(env, NPW_PROCESS_ID=str(r)) if ranks > 1 else env)
             for r in range(ranks)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise SystemExit(f"p21_profile: part {part} failed: {[p.returncode for p in procs]}")
    return [json.loads(ln) for out in outs for ln in out.splitlines() if ln.startswith("{")]


def main() -> int:
    if len(sys.argv) > 1:
        {"cholesky": part_cholesky, "tsqr": part_tsqr, "gloo": part_gloo_rank}[sys.argv[1]]()
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("p21_profile: no CUDA device")
    from numpywren_tpu_torch.ops import _build

    _build.build()  # once, before the parts load it
    for part, ranks in (("cholesky", 1), ("tsqr", 1), ("gloo", RANKS)):
        for row in run(part, ranks):
            emit(row)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
