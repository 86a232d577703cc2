"""`correct` comes out false when the timed path is broken underneath, on
the CPU at each cell's tiny size: the rest of a run is driven as on the
card, past the harness's look for a chip.

The faults a solver's cell can have: a step that returns its state
unchanged (run_program does nothing: the Cholesky's buffers keep A, the
TSQR's outputs stay unwritten), half of the answer left out (the
factorization stops halfway; Q's lower half is not written), and an answer
altered where it is produced (one entry of L, of R, or of Q). A cell runs
on one chip, so no exchange between chips can be left out. Besides, an
entry that writes into the operand it was handed (TSQR's, which the
benchmark does not restore) changes the traffic and the reference's input.
"""

import time

import pytest
import torch

import harness
from conftest import TINY

CHOL = ["chol-n65536"]
TSQR = ["tsqr-m1048576-b512"]


def run_broken(name):
    cell = harness.load_cell(name, overrides=TINY[name])
    harness.apply_env(cell)
    result = harness.run_cell(cell, 2**32 + 99, 0.2, False, torch.device("cpu"),
                              time.perf_counter())
    return result, result["checks"]


def test_sound_runs_are_correct():
    for name in CHOL + TSQR:
        assert run_broken(name)[0]["correct"]


@pytest.mark.parametrize("name", CHOL + TSQR)
def test_state_returned_unchanged(name, monkeypatch):
    import numpywren_tpu_torch as npw

    monkeypatch.setattr(npw, "run_program", lambda program, *a, **k: None)
    result, checks = run_broken(name)
    assert result["correct"] is False


@pytest.mark.parametrize("name", CHOL)
def test_half_the_factor_left_out(name, monkeypatch):
    from numpywren_tpu_torch import trapezoid

    real = trapezoid.cholesky_trapezoid

    def half(t, *, precision=None, stop_panels=None):
        return real(t, precision=precision, stop_panels=max(1, t.nb // 2))

    monkeypatch.setattr(trapezoid, "cholesky_trapezoid", half)
    result, checks = run_broken(name)
    assert result["correct"] is False and checks["l_err"]["value"] > checks["l_err"]["limit"]


@pytest.mark.parametrize("name", TSQR)
def test_half_of_q_left_out(name, monkeypatch):
    from numpywren_tpu_torch.compiler import lower

    real = lower.fused_tsqr

    def half(a, tile_rows, **kw):
        q, r = real(a, tile_rows, **kw)
        q[q.shape[0] // 2:] = 0
        return q, r

    monkeypatch.setattr(lower, "fused_tsqr", half)
    result, checks = run_broken(name)
    assert result["correct"] is False and checks["q_err"]["value"] > checks["q_err"]["limit"]


@pytest.mark.parametrize("name", CHOL)
def test_factor_entry_altered(name, monkeypatch):
    from numpywren_tpu_torch import trapezoid

    real = trapezoid.cholesky_trapezoid

    def altered(t, **kw):
        out = real(t, **kw)
        out.cols[-1][-1, -1] += 1.0
        return out

    monkeypatch.setattr(trapezoid, "cholesky_trapezoid", altered)
    result, checks = run_broken(name)
    assert result["correct"] is False


@pytest.mark.parametrize("part", ["q", "r"])
@pytest.mark.parametrize("name", TSQR)
def test_qr_entry_altered(name, part, monkeypatch):
    from numpywren_tpu_torch.compiler import lower

    real = lower.fused_tsqr

    def altered(a, tile_rows, **kw):
        q, r = real(a, tile_rows, **kw)
        (q if part == "q" else r)[0, -1] += 0.5
        return q, r

    monkeypatch.setattr(lower, "fused_tsqr", altered)
    result, checks = run_broken(name)
    assert result["correct"] is False


@pytest.mark.parametrize("name", TSQR)
def test_operand_written_in_place(name, monkeypatch):
    import numpywren_tpu_torch as npw

    real = npw.tsqr

    def in_place(x, *a, **k):
        out = real(x, *a, **k)
        x[0, 0] += 1.0
        return out

    monkeypatch.setattr(npw, "tsqr", in_place)
    result, checks = run_broken(name)
    assert result["correct"] is False and checks["operands_changed"]["value"] > 0
