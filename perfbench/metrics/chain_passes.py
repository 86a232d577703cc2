"""chain_passes: CholeskyQR passes a request over the traced stretch: the
adaptive chains that compiler/lower._cholqr_adaptive ran plus their extras
passes (lower.CHAIN_PASSES). Nothing to read where no chain ran."""

SOURCE = "program_counter"
COUNTERS = ("numpywren_tpu_torch.compiler.lower:CHAIN_PASSES[chains]",
            "numpywren_tpu_torch.compiler.lower:CHAIN_PASSES[extras]")


def read(ctx, rec=None):
    chains, extras = (ctx.counters.get(c) for c in COUNTERS)
    if not ctx.requests or not chains:
        return None
    return (chains + (extras or 0)) / len(ctx.requests)
