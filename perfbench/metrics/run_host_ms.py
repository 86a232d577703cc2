"""run_host_ms: the median host time of run_program(program) until it
returns, before the request's synchronize (runtime/executor.run_program,
compiler/lower), over the traced stretch's requests, in ms. Where it is
above the device's time a request, the host paces the device."""

import statistics

SOURCE = "host_clock"


def read(ctx, rec=None):
    spans = [r["run"] for r in ctx.requests]
    return statistics.median(spans) * 1e3 if spans else None
