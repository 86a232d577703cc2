"""Metrics and tracing: per-level step records of a program's node
profiles, spans of the program's layers on the host, a profiler trace
around a region, and a flop meter for fused runs (which execute as one
launch sequence and have no per-node timings).

The counterpart of numpywren_tpu/metrics.py. Three things differ on
purpose: `trace` runs torch.profiler and lets an exception of the traced
code propagate as itself; `FlopMeter` times the device with CUDA events
(launches return before the work is done, so a host clock would time the
enqueue); and `FlopMeter` takes `device=` as every entry point does. The
spans (`span`, `spans`) are the port's own.

Spans. The entries (`alg_wrappers`) and `run_program` open a root span
(`bind`, `run`) and the layers below open named children at their
boundaries (`bind.schedule`, `chol.update`, `host_read`, ...; README lists
them). With no recorder open a span is one shared no-op context. Inside
`spans()` each span appends one `SpanRecord` to every open recorder; its
times are `time.time_ns()`, the clock of torch.profiler's events, so spans
line up with a device trace. A program keeps the trace id its entry gave
it (`TiledProgram.trace_id`): its `bind` and `run` spans, and every span
under them, share it."""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import threading
import time
from typing import Dict, List, Optional

import torch

from numpywren_tpu_torch.ops.common import default_device

logger = logging.getLogger("numpywren_tpu_torch")


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class SpanRecord:
    """One span as a recorder holds it: `parent` is the index of the
    enclosing span in the same recorder (None for a root, or where the
    enclosing span began before the recorder opened); `end_ns` is None
    while the span is open; `error` names the exception that left it."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "trace", "error")

    def __init__(self, name, start_ns, parent, trace):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.trace, self.error = parent, trace, None

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"parent={self.parent}, trace={self.trace}, error={self.error!r})")


_RECORDERS: tuple = ()   # the open recorders (lists), replaced whole on open and close
_PROFILING = 0           # `trace` regions whose profiler runs
_LOCK = threading.Lock()  # both of the above, and a span's place in each recorder
_stacks = threading.local()
_trace_ids = itertools.count(1)


def new_trace() -> int:
    """A fresh trace id: an entry gives one to the program it binds."""
    return next(_trace_ids)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "trace", "records", "annotation")

    def __init__(self, name: str, trace: Optional[int]):
        self.name, self.trace, self.annotation = name, trace, None

    def __enter__(self):
        stack = _stacks.__dict__.setdefault("open", [])
        outer = stack[-1] if stack else None
        if self.trace is None and outer is not None:
            self.trace = outer.trace
        start = time.time_ns()
        self.records = []
        with _LOCK:
            for rec in _RECORDERS:
                parent = next((i for r, i, _ in outer.records if r is rec), None) if outer \
                    else None
                record = SpanRecord(self.name, start, parent, self.trace)
                self.records.append((rec, len(rec), record))
                rec.append(record)
        stack.append(self)
        if _PROFILING:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, typ, exc, tb):
        end = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(typ, exc, tb)
        _stacks.open.pop()
        error = None if typ is None else f"{typ.__name__}: {exc}"
        for _, _, record in self.records:
            record.end_ns, record.error = end, error
        return False


def span(name: str, trace: Optional[int] = None):
    """A context manager timing the region as the span `name`. With no
    recorder open it is one shared no-op. `trace` defaults to the enclosing
    span's. An exception leaves the span recorded with its `error` and
    propagates as itself."""
    if not _RECORDERS:
        return _NO_SPAN
    return _Span(name, trace)


@contextlib.contextmanager
def spans():
    """Open a recorder: yields the list that receives a `SpanRecord` for
    every span entered while it is open, in the order they were entered.
    Recorders may be open together; each receives every span."""
    global _RECORDERS
    rec: List[SpanRecord] = []
    with _LOCK:
        _RECORDERS = _RECORDERS + (rec,)
    try:
        yield rec
    finally:
        with _LOCK:
            _RECORDERS = tuple(r for r in _RECORDERS if r is not rec)


# ---------------------------------------------------------------------------
# Node profiles
# ---------------------------------------------------------------------------

_NO_PROFILE: Dict = {}  # a node that recorded nothing (TiledProgram.profile)


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
            p = program.profile.get(nid, _NO_PROFILE)
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
    written into `log_dir`. The region's spans are recorded (yields their
    list, as `spans` does) and, while the profiler runs, each is also a
    `torch.profiler.record_function` of its name, so the trace shows them
    above the kernels. No-op (yields None) when no log_dir is given; only
    the spans when the profiler cannot start. An exception raised in the
    region propagates."""
    global _PROFILING
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    with spans() as rec:
        try:
            prof.start()
        except RuntimeError:  # another profiler session is active in this process
            logger.warning("torch.profiler unavailable; running untraced")
            yield rec
            return
        with _LOCK:
            _PROFILING += 1
        try:
            yield rec
            if cuda:
                torch.cuda.synchronize()  # the region's kernels end inside the trace
        finally:
            with _LOCK:
                _PROFILING -= 1
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
