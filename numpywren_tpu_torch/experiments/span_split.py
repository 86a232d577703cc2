#!/usr/bin/env python3
"""Where a request's host time and the device's idle time go, by the
program's spans (numpywren_tpu_torch.metrics.span), in the calls of the
benchmark's two cells at their sizes, compensated, TF32 off:

    python3 numpywren_tpu_torch/experiments/span_split.py            # with a GPU
    python3 numpywren_tpu_torch/experiments/span_split.py --device cpu --n 512 \
        --panel 128 --m 8192 --b 64 --tile-rows 1024                # a dry run

- chol: cholesky(TrapezoidMatrix(cols, n, panel), storage="trapezoid",
  panel=panel) + run_program, the column buffers restored from a pristine
  copy before each request (perfbench's chol-n65536: N=65536, panel 1024);
- tsqr: tsqr(X, tile_rows, method="cholqr3s", compute_q=True) +
  run_program (perfbench's tsqr-m1048576-b512: 1,048,576 x 512, 4096).

Each cell: warm-up requests, then requests under torch.profiler (CUDA
activity only, as perfbench traces) with a span recorder open. Per request
(medians): the bind and the run split by their child spans, in ms, the
share of each that its children cover, the host_read ms under the run,
schedule_ms (bind.schedule + bind.program); then the device's idle time
inside the requests' bind and run spans put down to the innermost span
covering it, and the share of it inside a non-root span; the host's ms a
request inside CUDA runtime calls (a launch that waits for room in the
launch queue, a copy), by the innermost span and the call. Then the spans'
cost: requests in turns with a recorder open and with none, the median of
each, and the host ns of one span in a tight loop, on and off, times the
spans a request records. One JSON line a measurement, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout's root
sys.path.insert(0, str(ROOT))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# The cells' requests
# ---------------------------------------------------------------------------

class Chol:
    """perfbench/drivers/cholesky_trapezoid.py's calls and operand."""

    def __init__(self, n: int, panel: int, device, seed: int):
        import numpywren_tpu_torch as npw

        self.npw, self.n, self.panel = npw, n, panel
        s = 0.5 / math.sqrt(n)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.pristine = []
        for c in range(n // panel):
            col = torch.randn(n - c * panel, panel, generator=gen, device=device)
            col.mul_(s * math.sqrt(2.0))
            d = col[:panel]
            d.copy_((d + d.T) / math.sqrt(2.0))
            d.diagonal().add_(2.0)
            self.pristine.append(col)
        self.work = [torch.empty_like(c) for c in self.pristine]

    def restore(self):
        for w, p in zip(self.work, self.pristine):
            w.copy_(p)

    def bind(self):
        t = self.npw.TrapezoidMatrix(self.work, self.n, self.panel)
        return self.npw.cholesky(t, storage="trapezoid", panel=self.panel)[0]


class Tsqr:
    """perfbench/drivers/tsqr.py's call and operand."""

    def __init__(self, m: int, b: int, tile_rows: int, device, seed: int):
        import numpywren_tpu_torch as npw

        self.npw, self.tile_rows = npw, tile_rows
        gen = torch.Generator(device=device).manual_seed(seed)
        self.x = torch.randn(m, b, generator=gen, device=device).mul_(0.1)

    def restore(self):
        pass

    def bind(self):
        return self.npw.tsqr(self.x, tile_rows=self.tile_rows, method="cholqr3s",
                             compute_q=True)[0]


def request(cell, sync) -> dict:
    """One request's phases on the wall clock (ns), as perfbench times
    them: restore, bind, run, sync."""
    t = [time.time_ns()]
    cell.restore()
    t.append(time.time_ns())
    prog = cell.bind()
    t.append(time.time_ns())
    cell.npw.run_program(prog)
    t.append(time.time_ns())
    sync()
    t.append(time.time_ns())
    return {"t": t, "trace": prog.trace_id}


# ---------------------------------------------------------------------------
# Reading the spans
# ---------------------------------------------------------------------------

def union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def covered(intervals) -> int:
    return sum(b - a for a, b in union(intervals))


def split(rec, traces):
    """Per root span (bind, run) of the given traces: its ms, its direct
    children's ms by name (summed), the share its children cover, and the
    ms of each deeper span name under it."""
    out = {"bind": [], "run": []}
    kids = {i: [] for i in range(len(rec))}
    root_of = []
    for i, s in enumerate(rec):
        root_of.append(i if s.parent is None else root_of[s.parent])
        if s.parent is not None:
            kids[s.parent].append(i)
    for i, s in enumerate(rec):
        if s.parent is not None or s.name not in out or s.trace not in traces:
            continue
        total = s.end_ns - s.start_ns
        direct, deep = {}, {}
        for k in kids[i]:
            direct[rec[k].name] = direct.get(rec[k].name, 0) + rec[k].end_ns - rec[k].start_ns
        for j in range(i + 1, len(rec)):
            if root_of[j] == i:
                deep[rec[j].name] = deep.get(rec[j].name, 0) + rec[j].end_ns - rec[j].start_ns
        cover = covered([(rec[k].start_ns, rec[k].end_ns) for k in kids[i]])
        out[s.name].append({"ms": total / 1e6, "cover": cover / total if total else 0.0,
                            "children_ms": {k: v / 1e6 for k, v in direct.items()},
                            "spans_ms": {k: v / 1e6 for k, v in deep.items()}})
    return out


def medians(rows):
    """The median of each number over the requests' rows."""
    if not rows:
        return {}
    keys = sorted({k for r in rows for k in r["spans_ms"]})
    return {"ms": statistics.median(r["ms"] for r in rows),
            "cover": statistics.median(r["cover"] for r in rows),
            "cover_min": min(r["cover"] for r in rows),
            "children_ms": {k: statistics.median(r["children_ms"].get(k, 0.0) for r in rows)
                            for k in sorted({k for r in rows for k in r["children_ms"]})},
            "spans_ms": {k: statistics.median(r["spans_ms"].get(k, 0.0) for r in rows)
                         for k in keys}}


def events(prof):
    """The trace's device activities as (start_ns, end_ns) and the host's
    CUDA runtime calls as (name, start_ns, end_ns), on the host's wall
    clock (perfbench/devtrace.py's reading)."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = int(e.start_ns())
        if e.device_type() == DeviceType.CUDA:
            device.append((s, s + int(e.duration_ns())))
        else:
            host.append((e.name(), s, s + int(e.duration_ns())))
    return sorted(device), sorted(host, key=lambda h: h[1])


class Innermost:
    """The innermost span of the given traces that covers a time point,
    as "<root>" or "<root>/<name>"; None outside every span."""

    def __init__(self, rec, traces):
        self.rec = rec
        self.spans = [(s.start_ns, s.end_ns, i) for i, s in enumerate(rec) if s.trace in traces]
        self.depth, self.root_of = [], []
        for s in rec:
            self.depth.append(0 if s.parent is None else self.depth[s.parent] + 1)
            self.root_of.append(len(self.root_of) if s.parent is None
                                else self.root_of[s.parent])

    def edges(self):
        return sorted({e for a, b, _ in self.spans for e in (a, b)})

    def __call__(self, t):
        inner = max((i for s0, s1, i in self.spans if s0 <= t < s1),
                    key=lambda i: self.depth[i], default=None)
        if inner is None:
            return None
        root = self.rec[self.root_of[inner]].name
        return root if inner == self.root_of[inner] else f"{root}/{self.rec[inner].name}"


def idle_by_span(rec, busy, traces, requests):
    """The device's idle ns inside the requests' window, by the innermost
    span covering each piece of a gap: "<root>/<name>" inside a root span
    (the root's own name where no child covers it), else the request's
    phase ("restore", "sync", "between")."""
    w0, w1 = requests[0]["t"][0], requests[-1]["t"][-1]
    gaps, prev = [], w0
    for a, b in union(busy):
        if a > prev:
            gaps.append((prev, min(a, w1)))
        prev = max(prev, b)
    if prev < w1:
        gaps.append((prev, w1))
    inner = Innermost(rec, traces)
    edges = inner.edges()
    phases = [(r["t"][0], r["t"][1], "restore") for r in requests] + \
             [(r["t"][3], r["t"][4], "sync") for r in requests]
    total = {}
    for g0, g1 in gaps:
        cuts = [g0] + edges[bisect.bisect_right(edges, g0):bisect.bisect_left(edges, g1)] + [g1]
        for a, b in zip(cuts, cuts[1:]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = inner(mid) or next((p for p0, p1, p in phases if p0 <= mid < p1),
                                       "between")
            total[label] = total.get(label, 0) + (b - a)
    return total


def runtime_calls(rec, host, traces, count):
    """The host's ms a request inside CUDA runtime calls, by the innermost
    span its call began in and the call's name: where the host waited in a
    launch (a full launch queue) or a copy rather than in Python."""
    inner = Innermost(rec, traces)
    total = {}
    for name, a, b in host:
        label = inner(a)
        if label is not None:
            key = f"{label}:{name}"
            total[key] = total.get(key, 0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:12]
    return {k: v / 1e6 / count for k, v in ranked}


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------

def run_cell(name, cell, args, device):
    from torch.profiler import ProfilerActivity, profile

    from numpywren_tpu_torch import metrics

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    count = args.chol_requests if name == "chol" else args.tsqr_requests
    for _ in range(2):
        request(cell, sync)
    with metrics.spans() as rec:
        activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profile(activities=activities) as prof:
            reqs = [request(cell, sync) for _ in range(count)]
    traces = {r["trace"] for r in reqs}
    parts = split(rec, traces)
    bind, run = medians(parts["bind"]), medians(parts["run"])
    busy, host = events(prof) if cuda else ([], [])
    emit({"cell": name, "requests": len(reqs),
          "request_ms": statistics.median((r["t"][4] - r["t"][0]) / 1e6 for r in reqs),
          "bind_ms_outside": statistics.median((r["t"][2] - r["t"][1]) / 1e6 for r in reqs),
          "run_host_ms_outside": statistics.median((r["t"][3] - r["t"][2]) / 1e6 for r in reqs),
          "schedule_ms": statistics.median(
              p["children_ms"].get("bind.schedule", 0.0) + p["children_ms"].get("bind.program", 0.0)
              for p in parts["bind"]),
          "host_wait_ms": statistics.median(p["spans_ms"].get("host_read", 0.0)
                                            for p in parts["run"]),
          "bind": bind, "run": run})
    if busy:
        idle = idle_by_span(rec, busy, traces, reqs)
        in_roots = {k: v for k, v in idle.items() if k.split("/")[0] in ("bind", "run")}
        named = sum(v for k, v in in_roots.items() if "/" in k)
        window = reqs[-1]["t"][-1] - reqs[0]["t"][0]
        emit({"cell": name, "idle": {k: v / 1e9 for k, v in sorted(idle.items(),
                                                                     key=lambda kv: -kv[1])},
              "idle_s": sum(idle.values()) / 1e9, "window_s": window / 1e9,
              "idle_in_bind_run_s": sum(in_roots.values()) / 1e9,
              "named_share": named / sum(in_roots.values()) if in_roots else None})
        emit({"cell": name, "runtime_calls_ms": runtime_calls(rec, host, traces, len(reqs))})
    # the spans' cost: requests in turns with a recorder open and with none
    rounds = args.chol_rounds if name == "chol" else args.tsqr_rounds
    per = 1 if name == "chol" else args.tsqr_per_round
    on, off = [], []
    for k in range(rounds):
        for recording in ((True, False) if k % 2 == 0 else (False, True)):
            for _ in range(per):
                if recording:
                    with metrics.spans():
                        r = request(cell, sync)
                else:
                    r = request(cell, sync)
                (on if recording else off).append((r["t"][4] - r["t"][0]) / 1e6)
    m_on, m_off = statistics.median(on), statistics.median(off)
    ns_on, ns_off = span_ns()
    per_request = len(rec) / len(reqs)
    added_ms = per_request * (ns_on - ns_off) / 1e6
    emit({"cell": name, "cost": {"median_ms_on": m_on, "median_ms_off": m_off,
                                 "requests_each": len(on), "delta_pct": 100 * (m_on / m_off - 1),
                                 "span_ns_on": ns_on, "span_ns_off": ns_off,
                                 "spans_per_request": per_request, "added_ms": added_ms,
                                 "added_pct": 100 * added_ms / m_off}})


def span_ns(n: int = 100_000):
    """The host ns one span takes in a tight loop with a recorder open and
    with none (least of three loops each)."""
    from numpywren_tpu_torch import metrics

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with metrics.span("x"):
                pass
        return (time.perf_counter_ns() - t0) / n

    off = min(loop() for _ in range(3))
    with metrics.spans():
        on = min(loop() for _ in range(3))
    return on, off


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--cells", default="chol,tsqr")
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--panel", type=int, default=1024)
    p.add_argument("--m", type=int, default=1 << 20)
    p.add_argument("--b", type=int, default=512)
    p.add_argument("--tile-rows", type=int, default=4096)
    p.add_argument("--chol-requests", type=int, default=4)
    p.add_argument("--tsqr-requests", type=int, default=60)
    p.add_argument("--chol-rounds", type=int, default=12)
    p.add_argument("--tsqr-rounds", type=int, default=10)
    p.add_argument("--tsqr-per-round", type=int, default=20)
    p.add_argument("--seed", type=int, default=2**31 + 4321)
    args = p.parse_args(argv)
    os.environ["NPW_COMPENSATED"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    for name in args.cells.split(","):
        cell = (Chol(args.n, args.panel, device, args.seed) if name == "chol"
                else Tsqr(args.m, args.b, args.tile_rows, device, args.seed))
        run_cell(name, cell, args, device)
        del cell
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
