"""schedule_ms: the median over the traced stretch's requests of the host
time inside the `bind.schedule` and `bind.program` spans of the request's
`bind` (compiler/schedule.compile_schedule: the DSL schedule, native/, and
the TiledProgram built on it), in ms: the schedule that the fused lowering
does not read. The spans are numpywren_tpu_torch.metrics's, one trace a
request; nothing to read where the program records none."""

import contextlib
import statistics

SOURCE = "host_clock"
ROOT, NAMES = "bind", ("bind.schedule", "bind.program")


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
