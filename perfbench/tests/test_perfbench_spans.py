"""The span readers on the CPU: a traced line of each cell at its tiny size
carries schedule_ms and host_wait_ms, finite and inside the bind and run
they split; the readers group spans by trace and report nothing where the
program records no spans."""

import json
import math
import types

import pytest

import harness
from conftest import ROOT, TINY
from test_perfbench_harness import run_tiny

CELLS = sorted(TINY)


@pytest.mark.parametrize("name", CELLS)
def test_traced_line_carries_the_span_metrics(name):
    import run

    cell, result = run_tiny(name, True)
    line = json.loads(json.dumps(run.finite(result)))
    assert line["correct"] is True
    got = {harness.quantity(k): (k, m["value"]) for k, m in line["metrics"].items()}
    for q in ("schedule_ms", "host_wait_ms"):
        k, v = got[q]
        assert k in {m["name"] for m in cell.per_layer} and math.isfinite(v) and v >= 0
    assert 0 < got["schedule_ms"][1] <= got["bind_ms"][1]
    assert got["host_wait_ms"][1] <= got["run_host_ms"][1]


def _span(name, start, end, parent, trace):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end, parent=parent,
                                 trace=trace, error=None)


@pytest.mark.parametrize("quantity,want", [("schedule_ms", 5.0), ("host_wait_ms", 3.0)])
def test_readers_group_spans_by_trace(quantity, want):
    """Two requests: the median of their per-trace sums; spans of the same
    name under another root do not count."""
    ms = 1_000_000
    rec = []
    for t, k in ((1, 1), (2, 3)):
        b = len(rec)
        rec += [_span("bind", 0, 10 * ms, None, t),
                _span("bind.schedule", 0, 2 * k * ms, b, t),
                _span("bind.program", 0, 1 * ms, b, t),
                _span("host_read", 0, 5 * ms, b, t)]
        r = len(rec)
        rec += [_span("run", 0, 10 * ms, None, t),
                _span("tsqr.chain", 0, 8 * ms, r, t),
                _span("host_read", 0, k * ms, r + 1, t),
                _span("host_read", 0, 1 * ms, r, t)]
    mod = harness.load_module(ROOT, "metrics", quantity)
    assert mod.read(types.SimpleNamespace(requests=[]), rec) == pytest.approx(want)


@pytest.mark.parametrize("quantity", ["schedule_ms", "host_wait_ms"])
def test_readers_report_nothing_without_spans(quantity, monkeypatch):
    from numpywren_tpu_torch import metrics

    mod = harness.load_module(ROOT, "metrics", quantity)
    ctx = types.SimpleNamespace(requests=[{"bind": 1.0, "run": 1.0}])
    assert mod.read(ctx, None) is None and mod.read(ctx, []) is None
    monkeypatch.delattr(metrics, "spans")  # a program without spans
    with mod.instrument() as rec:
        assert rec is None
    assert mod.read(ctx, rec) is None
