"""How far the port's distributed BDFAC on four ranks lands from one rank's,
and how far a planted fault moves it: the two readings that the bar of
chip_smoke.py's P21 (b) (`P21_BDFAC_B_BAR`) sits between.

Four gloo processes on one card (or on the host with --device cpu) form
a 2 x 2 mesh. For each seed, X (n x n, Gaussian, made on the device from
the seed as P21 makes it) goes through `bdfac_1d` and `bdfac_2d` on the
mesh, compensated, and rank 0 compares B with the same call on a mesh of
itself alone. Rank 0 also measures what moves one rank's B: a one-ulp
change of X[0, 0], and "highest" against compensated. Then, on the first
seed, four planted faults on the 2 x 2 mesh, each at step nb / 2 on rank
1: its Wᵀ·trailing share left out of the all_reduce (``w1_dropped``), or
its bulk update skipped (``bulk_skipped``), for each form. The faults are
made by wrapping the fabric module's collectives and `_sub_matmul` in
this process; the package is not changed.

Each number: B's relative Frobenius difference (``rel``), the same of
|B| (``rel_abs``: a Yamamoto sign that differs flips rows or columns of
B and leaves |B| alone) and of |B| but its last block column
(``rel_abs_head``), chip_smoke.py's `b_agreement` (``agreement``: that,
with the last block column's singular values, which is what P21 holds),
each block row's raw difference (``rel_by_block_row``), the largest
sigma error over sigma_max (sigma from fp64 eigvalsh(BᵀB)), and
||B||_F's. One JSON object a line, on stdout and in --out.

    python experiments/torch_bdfac_agreement.py                  # the card, 8192 / 512
    python experiments/torch_bdfac_agreement.py --device cpu --n 1024 --tile 128
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch

RANKS = 4


def sigma(b: torch.Tensor) -> torch.Tensor:
    b64 = b.double()
    return torch.linalg.eigvalsh(b64.T @ b64).clamp_min(0.0).sqrt().flip(0)


def compare(b: torch.Tensor, ref: torch.Tensor, tile: int) -> dict:
    """b against ref: the numbers named in the module docstring."""
    import chip_smoke

    d, r = (b - ref).double(), ref.double()
    f = float(torch.linalg.norm(r))
    s, s_ref = sigma(b), sigma(ref)
    return {"rel": float(torch.linalg.norm(d)) / f,
            "rel_abs": float(torch.linalg.norm(b.double().abs() - r.abs())) / f,
            "rel_abs_head": float(torch.linalg.norm(b[:, :-tile].double().abs()
                                                    - r[:, :-tile].abs())) / f,
            "agreement": chip_smoke.b_agreement(torch, b, ref, tile),
            "rel_by_block_row": [float(torch.linalg.norm(d[i:i + tile]))
                                 / float(torch.linalg.norm(r[i:i + tile]))
                                 for i in range(0, b.shape[0], tile)],
            "sigma_err_over_max": float((s - s_ref).abs().max() / s_ref[0]),
            "fro_rel": abs(float(torch.linalg.norm(b.double())) - f) / f}


class Fault:
    """On rank `rank`, at step `step` of a BDFAC: `kind` "w1_dropped"
    zeros this rank's share of the Wᵀ·trailing all_reduce (the call after
    the step's "qr_q1" (1-D) or "qr_wbcast" (2-D) log entry), "bulk_skipped"
    skips this rank's first `_sub_matmul` after the step's "qr_bulk" entry.
    Use its two lists as the call's collective_log and schedule_log, and
    `patch(fabric)` around it."""

    def __init__(self, kind: str, rank: int, step: int, me: int):
        self.kind, self.armed = kind, me == rank
        self.step, self.last, self.fired = step, None, 0
        fault = self

        class Log(list):
            def append(self, item):
                fault.last = item
                super().append(item)

        self.clog, self.slog = Log(), Log()

    def _at(self, kinds) -> bool:
        return (self.armed and not self.fired and self.last is not None
                and self.last[0] in kinds and self.last[1] == self.step)

    def patch(self, fabric):
        real_sum, real_dist, real_sub = fabric.sum_over_mesh, fabric.dist, fabric._sub_matmul
        fault = self

        def w1_hook(x):
            if fault.kind == "w1_dropped" and fault._at(("qr_q1", "qr_wbcast")):
                x.zero_()
                fault.fired += 1

        class Dist:
            def __getattr__(self, name):
                return getattr(real_dist, name)

            def all_reduce(self, x, *args, **kw):
                w1_hook(x)
                return real_dist.all_reduce(x, *args, **kw)

        def sum_over_mesh(x, mesh):
            w1_hook(x)
            return real_sum(x, mesh)

        def sub_matmul(c, a, b, **kw):
            if fault.kind == "bulk_skipped" and fault._at(("qr_bulk",)):
                fault.fired += 1
                return c
            return real_sub(c, a, b, **kw)

        fabric.sum_over_mesh, fabric.dist, fabric._sub_matmul = sum_over_mesh, Dist(), sub_matmul

        def restore():
            fabric.sum_over_mesh, fabric.dist, fabric._sub_matmul = real_sum, real_dist, real_sub

        return restore


def rank_main(args) -> None:
    from numpywren_tpu_torch.parallel import distributed, fabric, make_mesh

    distributed.initialize(backend="gloo")
    me = distributed.process_index()
    cuda = args.device == "cuda"
    dev = "cuda" if cuda else "cpu"
    kind = None if cuda else "cpu"
    if cuda:
        from numpywren_tpu_torch.ops import _build

        _build.build()
        _build.library()
    mesh = make_mesh(shape=(2, 2), device=kind)
    mesh1 = make_mesh(devices=[0], shape=(1, 1), device=kind)  # collective: every rank
    t, forms = args.tile, {"bdfac_1d": fabric.bdfac_1d, "bdfac_2d": fabric.bdfac_2d}
    out = open(args.out, "a") if me == 0 else None

    def emit(obj):
        if me == 0:
            line = json.dumps(obj)
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

    def timed(call):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        res = call()
        if cuda:
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    refs = {}
    for seed in args.seeds:
        x = torch.randn(args.n, args.n, generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
        for name, fn in forms.items():
            b4, sec = timed(lambda: fn(x, mesh, tile=t))
            row = {"seed": seed, "form": name, "n": args.n, "tile": t, "seconds_4": sec}
            if me == 0:
                b1 = fn(x, mesh1, tile=t)
                refs[seed, name] = b1
                row["four_ranks_vs_one"] = compare(b4, b1, t)
                xu = x.clone()
                xu[0, 0] = torch.nextafter(xu[0, 0], torch.tensor(float("inf"), device=dev))
                row["one_ulp_of_x"] = compare(fn(xu, mesh1, tile=t), b1, t)
                row["highest_vs_compensated"] = compare(
                    fn(x, mesh1, tile=t, precision="highest"), b1, t)
                del xu
            emit(row)
            del b4
        if seed != args.seeds[0]:
            refs = {k: v for k, v in refs.items() if k[0] == args.seeds[0]}
    seed = args.seeds[0]
    x = torch.randn(args.n, args.n, generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    step = args.n // t // 2
    for name, fn in forms.items():
        for kind_ in ("w1_dropped", "bulk_skipped"):
            fault = Fault(kind_, 1, step, me)
            restore = fault.patch(fabric)
            try:
                b4, sec = timed(lambda: fn(x, mesh, tile=t, collective_log=fault.clog,
                                           schedule_log=fault.slog))
            finally:
                restore()
            fired = torch.tensor([float(fault.fired)], device=dev)
            torch.distributed.all_reduce(fired)
            row = {"seed": seed, "form": name, "fault": kind_, "rank": 1, "step": step,
                   "fired": int(fired.item()), "seconds_4": sec}
            if me == 0:
                row["faulty_vs_one"] = compare(b4, refs[seed, name], t)
            emit(row)
            del b4
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default="chiprun_out/bdfac_agreement.jsonl")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu for the host)")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        line = json.dumps({"nvidia_smi": card.stdout.strip(),
                           "torch": torch.__version__, "cuda": torch.version.cuda})
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, NPW_COMPENSATED="1", NPW_COORDINATOR=f"127.0.0.1:{port}",
               NPW_NUM_PROCESSES=str(RANKS), PYTHONPATH=here)
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *sys.argv[1:],
                               "--rank", str(r)], env=dict(env, NPW_PROCESS_ID=str(r)), cwd=here)
             for r in range(RANKS)]
    failed_at = None
    try:  # a rank that fails leaves the others in a collective: 30 s, then kill
        while any(p.poll() is None for p in procs):
            if failed_at is None and any(p.poll() not in (None, 0) for p in procs):
                failed_at = time.time()
            if failed_at and time.time() > failed_at + 30:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return max(abs(p.returncode) for p in procs)


if __name__ == "__main__":
    raise SystemExit(main())
