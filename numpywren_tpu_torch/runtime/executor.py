"""Running a compiled program (counterpart of the fused part of
numpywren_tpu/runtime/executor.py).

Only the region-fused lowering is ported. The generic static-schedule
executor ("jax"), the threaded numpy runtime ("local") and the out-of-core
executor ("spill") are not yet: see ROADMAP.md, Queue 1.
"""

from __future__ import annotations

from typing import Optional

from numpywren_tpu_torch.runtime.program import NS, PS, TiledProgram

_NOT_PORTED = {
    "jax": "the generic static-schedule executor (ROADMAP Queue 1: generic executor)",
    "local": "the threaded local executor (ROADMAP Queue 1: generic executor)",
    "spill": "the out-of-core executor (ROADMAP Queue 1: host tier and spill)",
}


def _mark_success(program: TiledProgram):
    """Fused lowerings complete atomically; sync the node state machine so
    wait()/get_node_status keep working. Sets the final state directly:
    program.start() would first count every node's parents, which costs
    ~0.2 s of host time at N=32768 (45,760 nodes) for counters that are
    overwritten at once."""
    with program._lock:
        if program.program_status == PS.SUCCESS:
            return
        if program.program_status != PS.NOT_STARTED:
            raise RuntimeError("program already started")
        n = program.num_nodes
        program.node_status = [NS.FINISHED] * n
        program.dep_count = [0] * n
        program._finished_count = n
        program.program_status = PS.SUCCESS
        program._cv.notify_all()


def run_program(
    program: TiledProgram,
    executor: str = "auto",
    num_workers: Optional[int] = None,
    resume: bool = False,
    **kw,
) -> PS:
    """One-call execution (the alg_wrappers run helper).

    executor:
      - "fused" / "auto": the region-fused lowering (compiler.lower).
        cholesky, gemm and the tsqr family have one in the port; another
        program (bdfac) raises.
      - "jax", "local", "spill": not ported yet (NotImplementedError).
    """
    if executor in _NOT_PORTED:
        raise NotImplementedError(f"executor {executor!r}: {_NOT_PORTED[executor]} is not ported yet")
    if executor not in ("auto", "fused"):
        raise ValueError(f"unknown executor {executor!r}")
    if resume:
        raise NotImplementedError(f"resume needs {_NOT_PORTED['local']}")
    from numpywren_tpu_torch.compiler.lower import lower_fused

    fn = lower_fused(program)
    if fn is None:
        name = program.dag.template.name
        if executor == "fused":
            raise ValueError(f"no fused lowering for program {name!r}")
        raise NotImplementedError(
            f"program {name!r} has no fused lowering and {_NOT_PORTED['jax']} is not ported yet")
    fn()
    _mark_success(program)
    return PS.SUCCESS
