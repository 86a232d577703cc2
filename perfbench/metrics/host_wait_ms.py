"""host_wait_ms: the median over the traced stretch's requests of the host
time inside the `host_read` spans under the request's `run` span, in ms:
the part of run_host_ms that the host spends blocked on the device
(compiler/lower: `_raise_if_not_spd`, the TSQR chain's reads). The spans
are numpywren_tpu_torch.metrics's, one trace a request; nothing to read
where the program records none."""

import contextlib
import statistics

SOURCE = "host_clock"
ROOT, NAMES = "run", ("host_read",)


@contextlib.contextmanager
def instrument():
    """The program's span recorder while the stretch runs (None where the
    program has none)."""
    from numpywren_tpu_torch import metrics

    if not hasattr(metrics, "spans"):
        yield None
        return
    with metrics.spans() as rec:
        yield rec


def per_trace(rec, root: str, names) -> dict:
    """{trace: ns} spent in the spans named in `names` under each root span
    named `root`."""
    roots, out = [], {}
    for i, s in enumerate(rec):
        r = i if s.parent is None else roots[s.parent]
        roots.append(r)
        if rec[r].name == root:
            out.setdefault(s.trace, 0)
            if s.name in names and s.end_ns is not None:
                out[s.trace] += s.end_ns - s.start_ns
    return out


def read(ctx, rec=None):
    per = per_trace(rec or [], ROOT, NAMES)
    return statistics.median(per.values()) / 1e6 if per else None
