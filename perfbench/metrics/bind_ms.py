"""bind_ms: the median host time of the entry call (numpywren_tpu_torch.cholesky
or .tsqr: the DSL bind, alg_wrappers, frontend/, compiler/schedule.py,
native/) over the traced stretch's requests, in ms."""

import statistics

SOURCE = "host_clock"


def read(ctx, rec=None):
    spans = [r["bind"] for r in ctx.requests]
    return statistics.median(spans) * 1e3 if spans else None
