"""idle_pct: the device's idle share over the traced stretch, in %:
1 − (the time at least one device activity ran) / (the first activity's
start to the last one's end), from torch.profiler's CUDA activity
(chip_smoke.py's union arithmetic, copied into devtrace.py)."""

import devtrace

SOURCE = "device_trace"


def read(ctx, rec=None):
    if not ctx.device:
        return None
    span = max(e for _, _, e in ctx.device) - ctx.device[0][1]
    if span <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy_seconds(ctx.device) * 1e9 / span)
