"""On the card: the spans' clock is the device trace's. TSQR at 131,072 x
512 (cholqr3s, Q, compensated applies, the TSQR cell's call) runs its entry
and run_program under torch.profiler (CUDA activity) with a span recorder
open; every kernel launch, copy and memset the host asked for lies inside
the program's `bind` or `run` span, within 50 us.

    python -m pytest perfbench/tests/test_perfbench_spans_card.py -q   # with a card
"""

import pytest
import torch

import devtrace

CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
SLACK_NS = 50_000


@pytest.mark.card
def test_spans_share_the_device_traces_clock(cuda, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    import numpywren_tpu_torch as npw
    from numpywren_tpu_torch import metrics

    monkeypatch.setenv("NPW_COMPENSATED", "1")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(2**31 + 7)
    x = torch.randn(131072, 512, generator=gen, device=cuda).mul_(0.1)

    def request():
        prog, out, _ = npw.tsqr(x, tile_rows=4096, method="cholqr3s", compute_q=True)
        npw.run_program(prog)
        return prog

    request()  # builds and warms the kernels
    torch.cuda.synchronize(cuda)
    with metrics.spans() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prog = request()
            torch.cuda.synchronize(cuda)
    _, host = devtrace.events(prof)
    roots = [(s.start_ns, s.end_ns) for s in rec
             if s.parent is None and s.trace == prog.trace_id]
    assert [s.name for s in rec if s.parent is None] == ["bind", "run"] and len(roots) == 2
    calls = [(name, a, b) for name, a, b in host if name in CALLS]
    assert len(calls) >= 5, sorted({name for name, _, _ in host})
    outside = [(name, a, b) for name, a, b in calls
               if not any(r0 - SLACK_NS <= a and b <= r1 + SLACK_NS for r0, r1 in roots)]
    assert not outside, (outside[:5], roots)
