"""The harness on the CPU: each cell at a tiny size prints a well-formed
line, every file is found by its name, a file added for a new cell or
metric is taken without another file being edited, and nothing it loads
is JAX or the JAX package."""

import ast
import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

import harness
import loadgen
from conftest import BENCH, ROOT, TINY

CELLS = sorted(TINY)
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def run_tiny(name, trace, seed=2**31 + 12345, root=harness.ROOT, overrides=None):
    cell = harness.load_cell(name, root=root,
                             overrides=TINY[name] if overrides is None else overrides)
    harness.apply_env(cell)
    result = harness.run_cell(cell, seed, 0.3, trace, torch.device("cpu"), time.perf_counter())
    return cell, result


def test_every_cell_has_a_tiny_size():
    assert sorted(w["name"] for w in bench_json()["workloads"]) == CELLS


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_prints_a_well_formed_line(name, trace):
    """The result line as run.py prints it: the contract's keys, the
    cell's metrics with their units, the numbers compared last."""
    import run

    cell, result = run_tiny(name, trace)
    line = json.loads(json.dumps(run.finite(result)))
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == set(cell.config["limits"]) | {"operands_changed"}
    for c in line["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    wanted = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(line["metrics"]) <= set(units)
    for k, m in line["metrics"].items():
        assert m["unit"] == units[k] and math.isfinite(m["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        got = {harness.quantity(k) for k in line["metrics"]}
        assert {"bind_ms", "run_host_ms"} <= got
    else:
        # on the CPU there is no device memory to read: the rest is there
        rate = [k for k in line["metrics"] if harness.quantity(k) == "tflops"]
        assert len(rate) == 1 and "setup_s" in line["metrics"]
        assert line["metrics"][rate[0]]["value"] > 0


def test_every_file_found_by_name():
    b = bench_json()
    assert b["paths"] == ["perfbench"] and b["command"] == ["python3", "perfbench/run.py"]
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        harness.load_module(ROOT, "drivers", cell.config["driver"])
        harness.load_module(ROOT, "references", cell.config["reference"])
        for m in cell.per_layer:
            mod = harness.load_module(ROOT, "metrics", harness.quantity(m["name"]))
            assert mod.SOURCE == per_layer[m["name"]]["source"]
            assert callable(mod.read)
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    e2e = {harness.quantity(m["name"]) for m in b["end_to_end"]}
    assert e2e == {"tflops", "p95_ms", "peak_mem_gib", "setup_s"}
    for w in b["workloads"]:  # each cell: setup_s, another end-to-end metric, a per-layer one
        cell = harness.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        assert all(m["moves"] in names for m in cell.per_layer)


def test_added_files_are_taken_without_editing_another(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a
    per-layer metric as new files, and entries in BENCHMARK.json: its new
    cell runs and reports the new metric."""
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (tmp_path / "perfbench" / p).read_bytes()
              for p in map(str, (tmp_path / "perfbench").rglob("*")) if os.path.isfile(p)}
    b = bench_json()
    cfg = json.loads((tmp_path / "perfbench/configs/chol-trapezoid-compensated.json").read_text())
    cfg.update(name="chol-dummy", entry={"storage": "trapezoid", "panel": 32})
    (tmp_path / "perfbench/configs/chol-dummy.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench/traffic/dummy.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "shape": {"n": 128}, "operands": 1,
         "check_samples": 1, "warmup": 1, "trace_seconds": 0.2}))
    (tmp_path / "perfbench/metrics/dummy_requests.py").write_text(
        'SOURCE = "host_clock"\n\n\n'
        'def read(ctx, rec=None):\n    return float(len(ctx.requests))\n')
    b["configs"].append({"name": "chol-dummy", "source": "https://arxiv.org/abs/1810.09679",
                         "file": "perfbench/configs/chol-dummy.json", "reduced": [],
                         "why": "a dummy"})
    b["workloads"].append({"name": "dummy-cell", "config": "chol-dummy", "traffic": "dummy",
                           "chips": 1, "why": "a dummy"})
    b["per_layer"].append({"name": "dummy_requests", "unit": "requests", "better": "higher",
                           "source": "host_clock", "layer": "entry and DSL bind",
                           "moves": "tflops.chol", "workloads": ["dummy-cell"]})
    for m in b["end_to_end"]:  # the new cell reports the Cholesky family's metrics
        if m["name"] in ("tflops.chol",):
            m["workloads"].append("dummy-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    _, result = run_tiny("dummy-cell", True, root=str(tmp_path), overrides={})
    assert result["correct"] and result["metrics"]["dummy_requests"]["value"] >= 1
    for p, data in before.items():  # no file of the benchmark was edited
        assert open(p, "rb").read() == data


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "numpywren_tpu_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "numpywren_tpu.probe", object())
    assert harness.forbidden_modules() == ["numpywren_tpu"]


def test_a_run_loads_no_jax():
    """In a process of its own, a whole tiny run of every cell (traced and
    not) loads no module whose top-level name is jax, jaxlib, flax or
    numpywren_tpu."""
    code = f"""
import json, sys, time, torch
sys.path[:0] = [{ROOT!r}, {BENCH!r}]
import harness
from conftest import TINY
for name in sorted(TINY):
    for trace in (False, True):
        cell = harness.load_cell(name, overrides=TINY[name])
        harness.apply_env(cell)
        harness.run_cell(cell, 7, 0.2, trace, torch.device("cpu"), time.perf_counter())
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.join(BENCH, "tests"),
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "numpywren_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_references_import_nothing_of_the_program():
    refs = os.path.join(BENCH, "references")
    for f in os.listdir(refs):
        if f.endswith(".py"):
            assert _imports(os.path.join(refs, f)) <= {"__future__", "math", "torch", "numpy"}
    code = f"""
import json, os, sys, importlib.util
for f in sorted(os.listdir({refs!r})):
    if f.endswith(".py"):
        spec = importlib.util.spec_from_file_location(f[:-3], os.path.join({refs!r}, f))
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"numpywren_tpu_torch", "numpywren_tpu", "jax", "jaxlib"}


def test_no_source_imports_the_old_harnesses_or_jax():
    for path in _sources():
        names = _imports(path)
        assert not names & {"bench_torch", "chip_smoke", "bench", "jax", "jaxlib", "flax",
                            "numpywren_tpu"}, path


def test_schedule_is_the_seeds_and_sizes_are_every_seeds():
    traffic = json.load(open(os.path.join(BENCH, "traffic", "n65536.json")))
    big = 2**31 + 2**40 + 17
    a, b, c = loadgen.Schedule(traffic, big), loadgen.Schedule(traffic, big), \
        loadgen.Schedule(traffic, 5)
    assert a.operand_seeds == b.operand_seeds and a.order == b.order
    assert [a.sample_slot(i) for i in range(500)] == [b.sample_slot(i) for i in range(500)]
    assert a.operand_seeds != c.operand_seeds
    assert a.shape == c.shape and sorted(a.order) == sorted(c.order)
    assert all(0 <= s < 2**63 for s in a.operand_seeds)


def test_reservoir_keeps_a_uniform_sample():
    traffic = {"loop": "closed", "clients": 1, "shape": {}, "operands": 1,
               "check_samples": 2, "warmup": 1, "trace_seconds": 1}
    n, kept = 20, [0] * 20
    for seed in range(2000):
        s = loadgen.Schedule(traffic, seed)
        slots = {}
        for i in range(n):
            j = s.sample_slot(i)
            if j is not None:
                slots[j] = i
        for i in slots.values():
            kept[i] += 1
    # each request kept with probability 2/20: 200 of 2000 expected
    assert all(140 < k < 260 for k in kept), kept


def test_run_exits_1_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "chol-n65536", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1 and out.stdout.strip() == ""
