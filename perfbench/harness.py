"""The benchmark's harness: finds a cell's files by the names in
BENCHMARK.json, runs the cell, and builds its result line.

What belongs to one unit sits in files of its own, found by name:

    perfbench/configs/<config>.json     the configuration: its entry's
                                        arguments, the program's settings
                                        (env), its driver and reference, and
                                        the limits of its comparison
    perfbench/drivers/<driver>.py       make_operand, work, Driver: the
                                        user's calls of the port's entry
    perfbench/references/<ref>.py       compare(): the plain reference
    perfbench/traffic/<traffic>.json    the generator's parameters
                                        (loadgen.py)
    perfbench/metrics/<metric>.py       a per-layer metric's reader

A metric's name is its quantity, then optionally a dot and the family of
cells it belongs to ("tflops.chol", "bind_ms.tsqr"): a quantity split by
the end-to-end metric it moves, or given a bound of its own, keeps one
reader, perfbench/metrics/<quantity>.py.

A request is one user's call: restore the operand where the entry works in
place, call the entry (the bind), run_program, synchronize. The window runs
requests back to back for --seconds. A traced run runs one stretch of the
traffic's trace_seconds instead, under torch.profiler, and reports its
per-layer metrics.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time
import traceback
import types

import loadgen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load: JAX and the reference package
FORBIDDEN = ("jax", "jaxlib", "flax", "numpywren_tpu")
PHASES = ("restore", "bind", "run", "sync")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Finding a cell's files
# ---------------------------------------------------------------------------

def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """perfbench/<kind>/<name>.py under `root`, loaded as a module of its
    own."""
    path = os.path.join(root, "perfbench", kind, f"{name}.py")
    mod_name = "perfbench_" + re.sub(r"\W", "_", os.path.abspath(path))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def quantity(name: str) -> str:
    """The quantity a metric's name measures: the part before the first
    dot."""
    return name.split(".")[0]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, root: str = ROOT, overrides: dict = None) -> types.SimpleNamespace:
    """The cell `name` of root/BENCHMARK.json with its configuration, its
    traffic and the metrics it reports. `overrides` ({"config": {...},
    "traffic": {...}}) replaces keys of the two files: the tests' tiny
    sizes."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    overrides = overrides or {}
    config = _merge(load_json(os.path.join(root, entry["file"])), overrides.get("config"))
    traffic = _merge(load_json(os.path.join(root, "perfbench", "traffic", f"{w['traffic']}.json")),
                     overrides.get("traffic"))
    return types.SimpleNamespace(
        name=name, root=root, chips=w["chips"], config=config,
        traffic=loadgen.validate(traffic),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def apply_env(cell) -> None:
    """The program's settings as the configuration states them, and no
    other NPW_ setting inherited from the caller's environment."""
    for k in [k for k in os.environ if k.startswith("NPW_")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in cell.config.get("env", {}).items()})


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (numpywren_tpu_torch is not numpywren_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

_COUNTER = re.compile(r"^([\w.]+):(\w+)(?:\[(\w+)\])?$")


def read_counter(spec: str):
    """"module:attr" or "module:attr[key]": an int, a dict's value, or a
    dict's values summed; None where the program has no such counter."""
    mod, attr, key = _COUNTER.match(spec).groups()
    try:
        value = getattr(importlib.import_module(mod), attr)
    except (ImportError, AttributeError):
        return None
    if isinstance(value, dict):
        return value.get(key) if key else sum(value.values())
    return value if key is None else None


def snapshot(specs):
    return {s: read_counter(s) for s in specs}


def deltas(before: dict, after: dict) -> dict:
    return {s: (None if before[s] is None or after[s] is None else after[s] - before[s])
            for s in before}


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

def request(driver, k: int, sync) -> dict:
    """One user's call on operand k: its phases' seconds (host clock) and
    their bounds on the wall clock (ns), for the trace."""
    marks = [(time.perf_counter(), time.time_ns())]
    driver.restore(k)
    marks.append((time.perf_counter(), time.time_ns()))
    driver.bind(k)
    marks.append((time.perf_counter(), time.time_ns()))
    driver.run()
    marks.append((time.perf_counter(), time.time_ns()))
    sync()
    marks.append((time.perf_counter(), time.time_ns()))
    rec = {p: marks[i + 1][0] - marks[i][0] for i, p in enumerate(PHASES)}
    rec["total"] = marks[-1][0] - marks[0][0]
    rec["t0"], rec["t1"] = marks[0][0], marks[-1][0]
    rec["phases_ns"] = [(p, marks[i][1], marks[i + 1][1]) for i, p in enumerate(PHASES)]
    return rec


class Run:
    """One run's state: the schedule, the driver, its requests and the
    answers kept for the check."""

    def __init__(self, cell, seed: int, device):
        import torch

        self.torch, self.cell, self.device = torch, cell, device
        self.sched = loadgen.Schedule(cell.traffic, seed)
        self.driver_mod = load_module(cell.root, "drivers", cell.config["driver"])
        self.ref_mod = load_module(cell.root, "references", cell.config["reference"])
        self.shape, self.entry = self.sched.shape, cell.config["entry"]
        self.cuda = device.type == "cuda"
        self.i = 0           # requests sent after the warm-up
        self.failed = 0
        self.held = {}       # holder slot -> operand index

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def allocated(self) -> int:
        return self.torch.cuda.memory_allocated(self.device) if self.cuda else 0

    def setup(self) -> None:
        """Operands from the seed on the device, the driver, the holders of
        the kept answers, and the warm-up requests. `own_bytes` counts the
        benchmark's own buffers (operands, holders), which peak_mem_gib
        leaves out."""
        t0 = time.perf_counter()
        a0 = self.allocated()
        self.operands = [self.driver_mod.make_operand(self.shape, self.entry, s, self.device)
                         for s in self.sched.operand_seeds]
        a1 = self.allocated()
        self.driver = self.driver_mod.Driver(self.shape, self.entry, self.operands, self.device)
        a2 = self.allocated()
        self.driver.allocate_holders(self.sched.samples)
        self.own_bytes = (a1 - a0) + (self.allocated() - a2)
        self.sync()
        t1 = time.perf_counter()
        for i in range(self.sched.warmup):
            request(self.driver, self.sched.operand(i), self.sync)
        self.driver.hold(0)  # the holder's copy, once
        self.sync()
        self.setup_parts = {"operands_s": t1 - t0, "warmup_s": time.perf_counter() - t1}

    def stretch(self, seconds: float):
        """Requests back to back until `seconds` have passed; each request's
        record, in order. A kept answer is copied after its request has
        synchronized, and the copy is waited for outside every request."""
        records = []
        t0 = time.perf_counter()
        while True:
            k = self.sched.operand(self.i)
            try:
                rec = request(self.driver, k, self.sync)
            except Exception:  # a request that fails counts, and the loop goes on
                self.failed += 1
                log(traceback.format_exc())
                self.sched.sample_slot(self.i)
            else:
                records.append(rec)
                slot = self.sched.sample_slot(self.i)
                if slot is not None:
                    self.driver.hold(slot)
                    self.held[slot] = k
                    self.sync()
            self.i += 1
            if time.perf_counter() - t0 >= seconds:
                return records

    def check(self):
        """Frees the program's state, then makes each operand anew from its
        seed and compares every kept answer with the reference on that
        fresh operand: {name: worst value} and whether each is within its
        limit (a missing value or a NaN is not). `operands_changed` counts
        the benchmark's copies that no longer equal their fresh operand bit
        for bit: an entry that wrote into what it was handed (limit 0)."""
        self.driver.free()
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()
        changed, got = 0, []
        for k, seed in enumerate(self.sched.operand_seeds):
            fresh = self.driver_mod.make_operand(self.shape, self.entry, seed, self.device)
            changed += not _same(self.operands[k], fresh)
            got += [self.ref_mod.compare(fresh, self.driver.held_output(slot), self.entry)
                    for slot, j in sorted(self.held.items()) if j == k]
            del fresh

        def worst(values):
            return math.nan if any(math.isnan(v) for v in values) else max(values)

        checks = {name: {"value": worst([g[name] for g in got]) if got else None, "limit": lim}
                  for name, lim in self.cell.config["limits"].items()}
        checks["operands_changed"] = {"value": changed, "limit": 0}
        ok = bool(got) and all(c["value"] <= c["limit"] for c in checks.values())
        return checks, ok


def _same(a, b) -> bool:
    """Whether two operands (a tensor or a list of tensors) are equal bit
    for bit."""
    import torch

    a, b = (a, b) if isinstance(a, (list, tuple)) else ([a], [b])
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

def p95(values):
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def device_info(cell, device, peak: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": cell.chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def build_seconds() -> float:
    """The seconds this process spent building the port's CUDA library (0
    where it loaded one already built in the checkout)."""
    mod = sys.modules.get("numpywren_tpu_torch.ops._build")
    return float(getattr(mod, "BUILD_SECONDS", None) or 0.0)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, start: float) -> dict:
    """One run of `cell`: the result line as a dict, the numbers compared
    last. `start` is the process's start on the perf_counter clock."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, seed, device)
    t_before = time.perf_counter() - start  # interpreter, imports, CUDA's start
    run.setup()
    setup_s = time.perf_counter() - start
    log(f"setup_s {setup_s:.3f}: before the run {t_before:.3f} s, " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_parts.items()) + f" (build {build_seconds():.3f})")
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    work = run.driver_mod.work(run.shape)
    extra = {"build_s": build_seconds()}
    if trace:
        metrics, dev_extra, breakdown = _traced(run, seconds)
    else:
        records = run.stretch(seconds)
        dev_extra, breakdown = {}, None
        metrics = _end_to_end(cell, run, records, work, setup_s)
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(device))
    checks, ok = run.check()
    result = {
        "correct": ok and run.failed == 0,
        "attempted": run.i,
        "failed": run.failed,
        "metrics": metrics,
        "device": {**device_info(cell, device, peak), **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["seed"] = seed
    result.update(extra)
    result["checks"] = checks  # last: the numbers compared, each beside its limit
    return result


def _end_to_end(cell, run, records, work: float, setup_s: float) -> dict:
    import torch

    window = (records[-1]["t1"] - records[0]["t0"]) if records else 0.0
    times = [r["total"] for r in records]
    peak_window = torch.cuda.max_memory_allocated(run.device) if run.cuda else 0
    values = {
        "tflops": work * len(records) / window / 1e12 if window > 0 else None,
        "p95_ms": p95(times) * 1e3 if times else None,
        "peak_mem_gib": (peak_window - run.own_bytes) / 2**30 if run.cuda else None,
        "setup_s": setup_s,
    }
    out = {}
    for m in cell.end_to_end:
        v = values.get(quantity(m["name"]))
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _traced(run, seconds: float):
    """The traced stretch: its per-layer metrics, and the trace's device
    keys and breakdown."""
    import devtrace
    from torch.profiler import ProfilerActivity, profile

    cell = run.cell
    length = min(seconds, run.sched.trace_seconds)
    readers = {m["name"]: load_module(cell.root, "metrics", quantity(m["name"]))
               for m in cell.per_layer}
    specs = sorted({c for mod in readers.values() for c in getattr(mod, "COUNTERS", ())})
    with contextlib.ExitStack() as stack:
        recs = {name: stack.enter_context(mod.instrument())
                for name, mod in readers.items() if hasattr(mod, "instrument")}
        before = snapshot(specs)
        activities = [ProfilerActivity.CUDA] if run.cuda else [ProfilerActivity.CPU]
        with profile(activities=activities) as prof:
            traced = run.stretch(length)
        after = snapshot(specs)
    device, host = devtrace.events(prof) if run.cuda else ([], [])
    phases = [p for r in traced for p in r["phases_ns"]]
    ctx = types.SimpleNamespace(requests=traced, counters=deltas(before, after),
                                device=device, host=host, phases=phases)
    metrics = {}
    for m in cell.per_layer:
        v = readers[m["name"]].read(ctx, recs.get(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    window_s = traced[-1]["t1"] - traced[0]["t0"] if traced else 0.0
    dev_extra = {"busy_s": devtrace.busy_seconds(device), "window_s": window_s}
    breakdown = {"device_ops": devtrace.device_ops(device),
                 "idle_gaps": devtrace.idle_gaps(device, host, phases)}
    return metrics, dev_extra, breakdown
