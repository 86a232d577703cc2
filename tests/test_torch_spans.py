"""The port's spans (numpywren_tpu_torch.metrics.span / spans / trace) on
the CPU: the no-op when no recorder is open, nested recorders and parent
links, errors, the spans of the Cholesky and TSQR entries and of
run_program (an entry's bind builds no schedule: `bind.schedule` opens
under `run` where a generic executor builds it), the profiler's trace,
and TiledProgram's node profiles, which only a dynamic run fills.

Small sizes (n 256, panel 64; 2048 x 32); each case takes seconds."""

import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

import numpywren_tpu_torch as npw
from numpywren_tpu_torch import metrics
from numpywren_tpu_torch.compiler import lower
from numpywren_tpu_torch.matrix_init import random_spd

BIND_CHILDREN = ["bind.store", "bind.alloc", "bind.program"]


def tree(rec):
    """{index: [child names in order]} and the root indices of `rec`."""
    kids = {i: [] for i in range(len(rec))}
    roots = []
    for i, s in enumerate(rec):
        if s.parent is None:
            roots.append(i)
        else:
            kids[s.parent].append(s.name)
    return kids, roots


def under(rec, root: int):
    """The spans below rec[root], at any depth."""
    inside = {root}
    out = []
    for i in range(root + 1, len(rec)):
        if rec[i].parent in inside:
            inside.add(i)
            out.append(rec[i])
    return out


def test_no_recorder_is_one_shared_noop():
    assert metrics._RECORDERS == ()
    a, b = metrics.span("a"), metrics.span("b", trace=3)
    assert a is b
    with a as got:
        assert got is None
    with metrics.spans() as rec:
        pass
    assert rec == []


def test_no_recorder_allocates_nothing():
    def loop(n):
        for _ in range(n):
            with metrics.span("x"):
                pass

    loop(10)
    tracemalloc.start()
    try:
        loop(10)
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        loop(20000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # a recorded span holds ~160 bytes: 20000 of them would be ~3 MB
    assert after - before < 1024 and peak - before < 4096


def test_nested_recorders_both_receive_every_span_with_parents():
    with metrics.spans() as outer:
        with metrics.span("a", trace=7):
            with metrics.spans() as inner:
                with metrics.span("b"):
                    with metrics.span("c"):
                        pass
                with metrics.span("d", trace=9):
                    pass
    assert [s.name for s in outer] == ["a", "b", "c", "d"]
    assert [s.parent for s in outer] == [None, 0, 1, 0]
    assert [s.trace for s in outer] == [7, 7, 7, 9]
    # the inner recorder opened inside "a": its first span has no parent there
    assert [s.name for s in inner] == ["b", "c", "d"]
    assert [s.parent for s in inner] == [None, 0, None]
    assert all(s.error is None and s.start_ns <= s.end_ns for s in outer + inner)
    assert outer[1] is not inner[0] and outer[1].start_ns == inner[0].start_ns
    assert metrics._RECORDERS == ()


def test_times_are_the_wall_clock_in_ns():
    with metrics.spans() as rec:
        t0 = time.time_ns()
        with metrics.span("a"):
            time.sleep(0.01)
        t1 = time.time_ns()
    (s,) = rec
    assert t0 <= s.start_ns and s.end_ns <= t1 and s.end_ns - s.start_ns >= 5_000_000


def test_an_exception_is_recorded_and_propagates():
    err = ValueError("in the span")
    with metrics.spans() as rec:
        with pytest.raises(ValueError) as got:
            with metrics.span("outer"):
                with metrics.span("inner"):
                    raise err
        with metrics.span("after"):
            pass
    assert got.value is err
    assert [s.name for s in rec] == ["outer", "inner", "after"]
    assert rec[0].error == rec[1].error == "ValueError: in the span"
    assert rec[2].error is None and rec[2].parent is None  # the stack unwound
    assert all(s.end_ns is not None for s in rec)


def test_a_closed_recorder_receives_nothing_more():
    with metrics.spans() as first:
        with metrics.span("a"):
            pass
    with metrics.spans() as second:
        with metrics.span("b"):
            pass
    assert [s.name for s in first] == ["a"] and [s.name for s in second] == ["b"]


def test_each_thread_has_its_own_stack():
    with metrics.spans() as rec:
        with metrics.span("main", trace=1):
            t = threading.Thread(target=lambda: metrics.span("worker").__enter__().__exit__(
                None, None, None))
            t.start()
            t.join()
    by = {s.name: s for s in rec}
    assert by["worker"].parent is None and by["worker"].trace is None
    assert by["main"].end_ns is not None


def test_threads_opening_recorders_and_spans_together():
    """Eight threads, each opening its own recorder and nesting spans, with
    a short switch interval: every recorder holds its thread's spans, each
    parent link names the enclosing span, and every recorder closes."""
    import sys

    errors, recs = [], {}

    def work(k):
        try:
            with metrics.spans() as rec:
                for _ in range(200):
                    with metrics.span(f"a{k}"):
                        with metrics.span(f"b{k}"):
                            pass
            recs[k] = rec
        except Exception as e:  # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads) and len(recs) == 8
    assert metrics._RECORDERS == ()
    for k, rec in recs.items():
        mine = [(i, s) for i, s in enumerate(rec) if s.name.endswith(str(k))]
        assert len(mine) == 400
        for i, s in mine:
            parent = None if s.parent is None else rec[s.parent].name
            assert parent == (f"a{k}" if s.name == f"b{k}" else None), s
        assert all(s.end_ns is not None for s in rec)


def _trapezoid_cholesky(n=256, panel=64):
    a = random_spd(n, seed=3)
    t = npw.TrapezoidMatrix.from_array(a, panel=panel, device="cpu")
    return a, npw.cholesky(t, storage="trapezoid", panel=panel)


def test_cholesky_trapezoid_spans():
    n, panel = 256, 64
    with metrics.spans() as rec:
        a, (prog, o, _) = _trapezoid_cholesky(n, panel)
        npw.run_program(prog)
    kids, roots = tree(rec)
    assert [rec[i].name for i in roots] == ["bind", "run"]
    bind, run = roots
    assert kids[bind] == BIND_CHILDREN
    assert rec[bind].trace == rec[run].trace == prog.trace_id is not None
    assert all(s.trace == prog.trace_id for s in rec)
    names = [s.name for s in under(rec, run)]
    panels = n // panel
    assert names.count("chol.factor") == panels
    assert names.count("chol.solve") == names.count("chol.update") == panels - 1
    assert names.count("host_read") == 1 and names[-2:] == ["host_read", "run.commit"]
    assert set(kids[run]) == {"chol.factor", "chol.solve", "chol.update", "host_read",
                              "run.commit"}
    l = o.numpy()
    assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-5


def test_a_failed_run_records_its_error():
    a = -np.eye(128, dtype=np.float32)
    with metrics.spans() as rec:
        prog, _, _ = npw.cholesky(npw.TrapezoidMatrix.from_array(a, panel=64, device="cpu"),
                                  storage="trapezoid", panel=64)
        with pytest.raises(torch.linalg.LinAlgError):
            npw.run_program(prog)
    run = next(s for s in rec if s.name == "run")
    assert "not positive-definite" in run.error and run.end_ns is not None
    assert [s.name for s in rec].count("host_read") == 1


@pytest.mark.parametrize("kappa", [1.0, 1e6])
def test_tsqr_cholqr3s_spans(kappa):
    m, b = 2048, 32
    rng = np.random.default_rng(5)
    u, _ = np.linalg.qr(rng.standard_normal((m, b)))
    v, _ = np.linalg.qr(rng.standard_normal((b, b)))
    x = (u * np.logspace(0, -np.log10(kappa), b)) @ v.T if kappa > 1 else \
        rng.standard_normal((m, b))
    x = torch.from_numpy(x.astype(np.float32))
    lower.reset_chain_passes()
    with metrics.spans() as rec:
        prog, out, _ = npw.tsqr(x, tile_rows=256, method="cholqr3s", compute_q=True)
        npw.run_program(prog)
    kids, roots = tree(rec)
    assert [rec[i].name for i in roots] == ["bind", "run"]
    bind, run = roots
    assert kids[bind] == BIND_CHILDREN
    assert kids[run] == ["tsqr.chain", "tsqr.q_pad", "run.commit"]
    assert rec[bind].trace == rec[run].trace == prog.trace_id
    chain = next(i for i, s in enumerate(rec) if s.name == "tsqr.chain")
    extras = lower.CHAIN_PASSES["extras"]
    assert lower.CHAIN_PASSES["chains"] == 1
    assert kids[chain][:4] == ["chain.gram", "chain.factor", "host_read", "chain.factor"]
    assert kids[chain][4] == "chain.apply" and kids[chain].count("chain.extra") == extras
    names = [s.name for s in under(rec, run)]
    assert names.count("host_read") == 1 + extras
    assert names.count("chain.gram") == names.count("chain.apply") == 1 + extras
    if kappa > 1:
        assert extras >= 1
    q = out["Q"].numpy()[:m]
    r = npw.tsqr_r_factor(out)
    assert np.linalg.norm(q @ r - x.numpy()) / np.linalg.norm(x.numpy()) < 1e-4


@pytest.mark.parametrize("entry", ["cholesky-hbm", "cholesky-host", "gemm", "bdfac",
                                   "tsqr-tree"])
def test_every_entry_binds_one_traced_bind_span(entry):
    a = random_spd(64, seed=4)
    calls = {
        "cholesky-hbm": lambda: npw.cholesky(a, tile=(32, 32), device="cpu"),
        "cholesky-host": lambda: npw.cholesky(a, tile=(32, 32), storage="host", device="cpu"),
        "gemm": lambda: npw.gemm(a, a, tile=(32, 32), device="cpu"),
        "bdfac": lambda: npw.bdfac(a, tile=(32, 32), device="cpu"),
        "tsqr-tree": lambda: npw.tsqr(np.vstack([a, a]), tile_rows=64, device="cpu"),
    }
    with metrics.spans() as rec:
        prog = calls[entry]()[0]
        npw.run_program(prog)
    kids, roots = tree(rec)
    assert [rec[i].name for i in roots] == ["bind", "run"]
    assert kids[roots[0]] == (BIND_CHILDREN if entry.startswith(("cholesky", "tsqr"))
                              else BIND_CHILDREN[2:])
    assert "run.commit" in kids[roots[1]]
    assert {s.trace for s in rec} == {prog.trace_id}


def test_trace_carries_the_span_names(tmp_path):
    out = tmp_path / "prof"
    with metrics.trace(str(out)) as rec:
        _, (prog, _, _) = _trapezoid_cholesky(128, 64)
        npw.run_program(prog)
    assert {"bind", "bind.program", "run", "chol.update", "host_read"} <= {s.name for s in rec}
    assert "bind.schedule" not in {s.name for s in rec}
    (f,) = out.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(f.read_text())["traceEvents"]}
    assert {"bind", "bind.program", "run", "chol.factor", "chol.update", "host_read"} <= names
    assert "bind.schedule" not in names


@pytest.mark.parametrize("executor", ["jax", "local", "spill"])
def test_a_generic_run_builds_the_schedule_under_run(executor):
    a = random_spd(96, seed=6)
    with metrics.spans() as rec:
        prog, o, _ = npw.cholesky(a, tile=(32, 32), storage="host", device="cpu")
        npw.run_program(prog, executor=executor)
    kids, roots = tree(rec)
    assert [rec[i].name for i in roots] == ["bind", "run"]
    bind, run = roots
    assert kids[bind] == BIND_CHILDREN
    assert kids[run][0] == "bind.schedule" and kids[run].count("bind.schedule") == 1
    assert [s.name for s in rec].count("bind.schedule") == 1
    assert {s.trace for s in rec} == {prog.trace_id}
    l = o.numpy()
    assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-5


def test_the_plain_recorder_does_not_annotate_the_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with metrics.spans() as rec:
        with metrics.span("a"):
            pass
    assert len(rec) == 1 and calls == []


def test_program_profile_is_empty_after_a_bind_and_a_fused_run():
    _, (prog, _, _) = _trapezoid_cholesky(256, 64)
    assert prog.profile == {} and prog.num_nodes > 0
    npw.run_program(prog)
    assert prog.profile == {}
    assert prog.profile_summary() == {"nodes_done": 0}
    assert all("wall_s" not in r and r["flops"] == 0 for r in metrics.level_report(prog))


def test_level_report_of_a_local_run():
    a = random_spd(96, seed=2)
    prog, _, _ = npw.cholesky(a, tile=(32, 32), storage="host", device="cpu")
    assert prog.profile == {}
    assert npw.run_program(prog, executor="local").name == "SUCCESS"
    assert set(prog.profile) == set(range(prog.num_nodes))
    recs = metrics.level_report(prog)
    assert len(recs) == len(prog.levels)
    for lv, (nodes, r) in enumerate(zip(prog.levels, recs)):
        ops = {}
        for nid in nodes:
            ops[prog.node(nid).op] = ops.get(prog.node(nid).op, 0) + 1
        assert r["level"] == lv and r["nodes"] == len(nodes) and r["ops"] == ops
        assert r["flops"] == sum(prog.node_flops(nid) for nid in nodes)
        p = [prog.profile[nid] for nid in nodes]
        assert r["wall_s"] == max(q["end"] for q in p) - min(q["start"] for q in p)
    summary = prog.profile_summary()
    assert summary["nodes_done"] == prog.num_nodes
    assert summary["total_flops"] == sum(prog.node_flops(i) for i in range(prog.num_nodes))
    prog.free()
    assert prog.profile == {} and prog.profile_summary() == {"nodes_done": 0}
