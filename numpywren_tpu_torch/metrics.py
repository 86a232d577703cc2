"""Metrics and tracing: per-level step records of a program's node
profiles, a profiler trace around a region, and a flop meter for fused
runs (which execute as one launch sequence and have no per-node timings).

The counterpart of numpywren_tpu/metrics.py. Three things differ on
purpose: `trace` runs torch.profiler and lets an exception of the traced
code propagate as itself; `FlopMeter` times the device with CUDA events
(launches return before the work is done, so a host clock would time the
enqueue); and `FlopMeter` takes `device=` as every entry point does."""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Dict, List, Optional

import torch

from numpywren_tpu_torch.ops.common import default_device

logger = logging.getLogger("numpywren_tpu_torch")


def level_report(program) -> List[Dict]:
    """One structured record per wavefront level from node profiles."""
    out = []
    for lv, nodes in enumerate(program.levels):
        ops: Dict[str, int] = {}
        flops = 0
        starts, ends = [], []
        for nid in nodes:
            n = program.node(nid)
            ops[n.op] = ops.get(n.op, 0) + 1
            p = program.profile[nid]
            flops += p.get("flops", 0)
            if "start" in p:
                starts.append(p["start"])
            if "end" in p:
                ends.append(p["end"])
        rec = {"level": lv, "nodes": len(nodes), "ops": ops, "flops": flops}
        if starts and ends:
            wall = max(ends) - min(starts)
            rec["wall_s"] = wall
            rec["tflops_per_s"] = flops / max(wall, 1e-9) / 1e12
        out.append(rec)
    return out


def log_program(program, logger_=None):
    lg = logger_ or logger
    for rec in level_report(program):
        lg.info("npw-step %s", json.dumps(rec))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler around a region, CPU activity and, with a CUDA device,
    CUDA activity; on exit a Chrome trace file (``*.pt.trace.json``) is
    written into `log_dir`. No-op when no log_dir is given or the profiler
    cannot start. An exception raised in the region propagates."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    try:
        prof.start()
    except RuntimeError:  # another profiler session is active in this process
        logger.warning("torch.profiler unavailable; running untraced")
        yield
        return
    try:
        yield
        if cuda:
            torch.cuda.synchronize()  # the region's kernels end inside the trace
    finally:
        prof.stop()


class FlopMeter:
    """Device-time + known-flops meter for fused single-program runs.

    with FlopMeter(flops=n**3/3, label="cholesky") as m: ...
    m.tflops after the block (logged at INFO).

    On a CUDA device the time is between two events recorded on the
    current stream at enter and exit (the exit waits for the second); on
    the CPU it is the host clock. `device=None` is the current CUDA device
    and raises on a host without one unless `device="cpu"`."""

    def __init__(self, flops: float, label: str = "", logger_=None, device=None):
        self.flops = flops
        self.label = label
        self.logger = logger_ or logger
        self.device = default_device() if device is None else torch.device(device)
        self.wall_s: Optional[float] = None
        self.tflops: Optional[float] = None

    def __enter__(self):
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(stream)
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._end.record(torch.cuda.current_stream(self.device))
            self._end.synchronize()
            self.wall_s = self._start.elapsed_time(self._end) / 1e3
        else:
            self.wall_s = time.perf_counter() - self._t0
        self.tflops = self.flops / max(self.wall_s, 1e-9) / 1e12
        self.logger.info(
            "npw-meter %s",
            json.dumps({"label": self.label, "wall_s": self.wall_s,
                        "flops": self.flops, "tflops_per_s": self.tflops}),
        )
        return False
