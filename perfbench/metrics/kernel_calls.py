"""kernel_calls: calls of the port's hand-written kernels a request over
the traced stretch: matmul3 calls and panel updates (ops/gemm3.LAUNCHES),
matmul calls (ops/gemm.LAUNCHES) and the factor kernels
(ops/pallas_factor.LAUNCHES, summed over its kinds). A call on a CPU tensor
runs the plain version and counts nothing."""

SOURCE = "program_counter"
COUNTERS = ("numpywren_tpu_torch.ops.gemm3:LAUNCHES",
            "numpywren_tpu_torch.ops.gemm:LAUNCHES",
            "numpywren_tpu_torch.ops.pallas_factor:LAUNCHES")


def read(ctx, rec=None):
    deltas = [ctx.counters.get(c) for c in COUNTERS]
    if not ctx.requests or all(d is None for d in deltas):
        return None
    return sum(d for d in deltas if d is not None) / len(ctx.requests)
