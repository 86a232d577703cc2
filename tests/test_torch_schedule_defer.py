"""The entries' deferred schedule on the CPU: a program bound by one of the
package's entries builds its task schedule at the first read of it, so a
fused run builds none and a generic executor builds it once, equal to the
eager build; a user's lpcompile program still builds it, and raises its
CompilationErrors, at bind; an entry's input that the schedule would refuse
still raises at bind. The counters are compiler.schedule's BINDS and
SCHEDULES_BUILT.

Small sizes (n 64-128, tiles of 32; 512 x 16); each case takes seconds."""

import threading

import numpy as np
import pytest
import torch

import numpywren_tpu_torch as npw
from numpywren_tpu_torch import alg_wrappers, checkpoint, metrics, native
from numpywren_tpu_torch.compiler import schedule
from numpywren_tpu_torch.exceptions import CompilationError, ShapeError
from numpywren_tpu_torch.frontend import lpcompile
from numpywren_tpu_torch.frontend.ir import BoundArg
from numpywren_tpu_torch.matrix_init import random_spd, shard_matrix
from numpywren_tpu_torch.runtime.program import NS, PS

T = 32


def _counts():
    return schedule.BINDS, schedule.SCHEDULES_BUILT


def _operands():
    rng = np.random.default_rng(11)
    return {
        "spd": random_spd(128, seed=12),
        "a": rng.standard_normal((96, 128)).astype(np.float32),
        "b": rng.standard_normal((128, 64)).astype(np.float32),
        "x": rng.standard_normal((512, 16)).astype(np.float32),
        "sq": rng.standard_normal((64, 64)).astype(np.float32),
    }


def _tsqr(method, q):
    return lambda d: npw.tsqr(d["x"], tile_rows=64, method=method, compute_q=q, device="cpu")


ENTRIES = {
    "cholesky-hbm": lambda d: npw.cholesky(d["spd"], tile=(T, T), device="cpu"),
    "cholesky-host": lambda d: npw.cholesky(d["spd"], tile=(T, T), storage="host",
                                            device="cpu"),
    "cholesky-trapezoid": lambda d: npw.cholesky(d["spd"], tile=(T, T), storage="trapezoid",
                                                 panel=64, device="cpu"),
    "gemm": lambda d: npw.gemm(d["a"], d["b"], tile=(T, T), device="cpu"),
    "tsqr-cholqr2": _tsqr("cholqr2", False),
    "tsqr-cholqr2-q": _tsqr("cholqr2", True),
    "tsqr-cholqr3s": _tsqr("cholqr3s", False),
    "tsqr-cholqr3s-q": _tsqr("cholqr3s", True),
    "tsqr-tree": _tsqr("tree", False),
    "tsqr-tree-q": _tsqr("tree", True),
    "bdfac": lambda d: npw.bdfac(d["sq"], tile=(T, T), device="cpu"),
}


def _outputs(out) -> list:
    if isinstance(out, dict):
        return [npw.tsqr_r_factor(out)] + ([out["Q"].numpy()] if "Q" in out else [])
    return [out.numpy()]


def _eager(monkeypatch):
    """The package's templates with the schedule built at bind."""
    for name in ("cholesky", "gemm", "tsqr", "tsqr_q", "bdfac"):
        monkeypatch.setattr(alg_wrappers._template(name), "defer_schedule", False)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_a_fused_run_builds_no_schedule(entry, monkeypatch):
    d = _operands()
    binds, built = _counts()
    prog, out, _ = ENTRIES[entry](d)
    assert npw.run_program(prog) == PS.SUCCESS
    assert _counts() == (binds + 1, built)
    assert prog.wait(timeout=0) == PS.SUCCESS
    got = _outputs(out)

    _eager(monkeypatch)
    d = _operands()
    eprog, eout, _ = ENTRIES[entry](d)
    assert _counts() == (binds + 2, built + 1)
    assert npw.run_program(eprog) == PS.SUCCESS
    for g, e in zip(got, _outputs(eout), strict=True):
        np.testing.assert_array_equal(g, e)

    # the per-node state after a fused run: every node FINISHED; reading it
    # builds the deferred schedule, once
    n = prog.num_nodes
    assert n == eprog.num_nodes > 0 and _counts()[1] == built + 2
    assert all(prog.get_node_status(i) == NS.FINISHED for i in range(n))
    assert prog._finished_count == n and prog.wait() == PS.SUCCESS
    assert prog.levels == eprog.levels and _counts()[1] == built + 2


def _bindings(prog):
    return dict(prog.dag.matrices, **prog.dag.consts)


def _assert_same_schedule(dag, eager):
    assert dag.nodes == eager.nodes
    assert dag.parents == eager.parents and dag.children == eager.children
    assert dag.levels == eager.levels and dag.node_level == eager.node_level
    assert dag.initial_reads == eager.initial_reads


GENERIC = [
    ("jax", "cholesky-hbm"), ("jax", "gemm"), ("jax", "tsqr-tree-q"), ("jax", "bdfac"),
    ("local", "cholesky-host"), ("spill", "cholesky-host"),
    ("local-resume", "cholesky-host"), ("spill-resume", "cholesky-host"),
]


@pytest.mark.parametrize("executor,entry", GENERIC)
def test_a_generic_run_builds_the_schedule_once(executor, entry, monkeypatch):
    d = _operands()
    binds, built = _counts()
    prog, out, _ = ENTRIES[entry](d)
    assert _counts() == (binds + 1, built)
    name, _, resume = executor.partition("-")
    assert npw.run_program(prog, executor=name, resume=bool(resume)) == PS.SUCCESS
    assert _counts() == (binds + 1, built + 1)
    assert all(prog.get_node_status(i) == NS.FINISHED for i in range(prog.num_nodes))

    monkeypatch.setattr(prog.dag.template, "defer_schedule", False)
    eager = schedule.compile_schedule(prog.dag.template, _bindings(prog))
    assert _counts() == (binds + 2, built + 2)
    _assert_same_schedule(prog.dag, eager.dag)
    if entry.startswith("cholesky"):
        a, l = d["spd"], out.numpy()
        assert np.linalg.norm(a - l @ l.T) / np.linalg.norm(a) < 1e-5
    assert _counts() == (binds + 2, built + 2)


READERS = {
    "nodes": lambda p: p.dag.nodes,
    "parents": lambda p: p.dag.parents,
    "children": lambda p: p.dag.children,
    "levels": lambda p: p.levels,
    "node_level": lambda p: p.dag.node_level,
    "initial_reads": lambda p: p.dag.initial_reads,
    "num_nodes": lambda p: p.num_nodes,
    "node_status": lambda p: p.get_node_status(0),
    "node_flops": lambda p: p.node_flops(0),
    "repr": repr,
    "level_report": metrics.level_report,
    "frontier": checkpoint.program_frontier,
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_each_reader_builds_the_schedule_once(reader):
    prog, _, _ = ENTRIES["cholesky-host"](_operands())
    built = schedule.SCHEDULES_BUILT
    assert prog.dag._built is False
    READERS[reader](prog)
    assert schedule.SCHEDULES_BUILT == built + 1 and prog.dag._built
    for read in READERS.values():
        read(prog)
    assert schedule.SCHEDULES_BUILT == built + 1


def test_threads_that_read_first_build_once():
    """Sixteen threads read a deferred schedule at once, with a short switch
    interval: one build, and every thread sees the same tables."""
    import sys

    prog, _, _ = ENTRIES["cholesky-host"](_operands())
    built = schedule.SCHEDULES_BUILT
    start, seen = threading.Barrier(16), []

    def read():
        start.wait()
        seen.append((id(prog.dag.nodes), id(prog.dag.parents), prog.num_nodes))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(seen) == 16 and len(set(seen)) == 1
    assert schedule.SCHEDULES_BUILT == built + 1


def test_the_native_mode_is_the_binds(monkeypatch):
    monkeypatch.setenv("NPW_NATIVE", "0")
    prog, _, _ = ENTRIES["cholesky-hbm"](_operands())
    monkeypatch.delenv("NPW_NATIVE")
    assert prog.num_nodes > 0 and prog.dag._native is None
    fresh, _, _ = ENTRIES["cholesky-hbm"](_operands())
    assert (fresh.num_nodes and fresh.dag._native is not None) == native.available()
    _assert_same_schedule(prog.dag, fresh.dag)


USER_ERRORS = {
    "double write": ("def f(A, B, N):\n"
                     "    for i in range(0, N):\n"
                     "        B[0, 0] = copy(A[i, 0])\n", "double write"),
    "own output": ("def f(A, N):\n"
                   "    for i in range(0, N):\n"
                   "        A[i, 0] = copy(A[i, 0])\n", "its own output"),
    "unbound version": ("def f(A, S, N):\n"
                        "    for i in range(0, N):\n"
                        "        A[i, 0] = copy(S[i, 0, 1])\n", "which nothing writes"),
}


@pytest.mark.parametrize("native", ["auto", "0"])
@pytest.mark.parametrize("case", sorted(USER_ERRORS))
def test_a_user_program_raises_at_bind(case, native, monkeypatch):
    monkeypatch.setenv("NPW_NATIVE", native)
    src, words = USER_ERRORS[case]
    tmpl = lpcompile(src)
    assert tmpl.defer_schedule is False
    mats = {name: shard_matrix(np.zeros((64, 32), np.float32), tile=(T, T), device="cpu")
            for name in tmpl.arg_names if name != "N"}
    if "S" in mats:
        mats["S"] = BoundArg(name="S", matrix=mats["S"], versioned=True)
    binds, built = _counts()
    with pytest.raises(CompilationError, match=words):
        tmpl.bind(N=2, **mats)
    assert _counts() == (binds, built)


def test_a_user_program_builds_at_bind():
    tmpl = lpcompile("def f(A, B, N):\n"
                     "    for i in range(0, N):\n"
                     "        B[i, 0] = copy(A[i, 0])\n")
    a = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    mats = {k: shard_matrix(a, tile=(T, T), device="cpu") for k in "AB"}
    binds, built = _counts()
    with metrics.spans() as rec:
        prog = tmpl.bind(N=2, **mats)
    assert _counts() == (binds + 1, built + 1)
    assert [s.name for s in rec] == ["bind.schedule", "bind.program"]
    assert prog.num_nodes == 2 and schedule.SCHEDULES_BUILT == built + 1
    assert npw.run_program(prog) == PS.SUCCESS
    np.testing.assert_array_equal(prog.matrices["B"].matrix.numpy(), a)


@pytest.mark.parametrize("truncate", [-1, -3])
@pytest.mark.parametrize("storage,error", [("hbm", CompilationError),
                                           ("host", CompilationError),
                                           ("trapezoid", ShapeError)])
def test_a_negative_truncate_raises_at_bind(storage, error, truncate):
    kw = dict(panel=64) if storage == "trapezoid" else {}
    with pytest.raises(error, match="truncate"):
        npw.cholesky(random_spd(128, seed=1), tile=(T, T), storage=storage,
                     truncate=truncate, device="cpu", **kw)


@pytest.mark.parametrize("storage", ["hbm", "host"])
def test_a_truncated_cholesky_defers_and_runs(storage):
    a = random_spd(128, seed=1)
    built = schedule.SCHEDULES_BUILT
    prog, o, _ = npw.cholesky(a, tile=(T, T), storage=storage, truncate=2, device="cpu")
    assert npw.run_program(prog) == PS.SUCCESS and schedule.SCHEDULES_BUILT == built
    l = torch.linalg.cholesky(torch.from_numpy(a).double()).numpy()
    np.testing.assert_allclose(o.numpy()[:, :64], l[:, :64], rtol=1e-4, atol=1e-5)
    assert prog.num_nodes == sum(1 + (3 - k) + (3 - k) * (4 - k) // 2 for k in range(2))
