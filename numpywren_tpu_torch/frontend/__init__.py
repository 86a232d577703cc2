"""LambdaPACK-style DSL frontend (rebuild of numpywren/frontend.py).

Algorithms are restricted Python over tiled matrices:

    def cholesky(O, S, N):
        for k in range(0, N):
            O[k, k] = potrf(S[k, k, k])
            for i in range(k + 1, N):
                O[i, k] = trsm(S[i, k, k], O[k, k])
            for i in range(k + 1, N):
                for j in range(k + 1, i + 1):
                    S[i, j, k + 1] = syrk(S[i, j, k], O[i, k], O[j, k])

Supported statements: `for v in range(lo, hi[, step])`, `if`/`else` on index
expressions, and (tuple) assignments of registered tile kernels to matrix
block refs. Index expressions may use +,-,*,//,%,**, min/max — the reference
restricts itself to affine expressions because its dependency solver runs
symbolically per post_op; ours enumerates concretely at compile time (the
static-schedule inversion, SURVEY §7), so non-affine constructs like the
2**level TSQR tree compile directly. A sympy on-demand solver with the
reference's get_children/get_parents semantics is provided in
frontend.solver for the affine subset.
"""

from numpywren_tpu_torch.frontend.ir import (
    BlockRef,
    BoundArg,
    ConstRef,
    ForLoop,
    IfBlock,
    KernelCall,
    ProgramTemplate,
)
from numpywren_tpu_torch.frontend.parser import lpcompile
from numpywren_tpu_torch.frontend.solver import DependencySolver

__all__ = [
    "lpcompile",
    "ProgramTemplate",
    "KernelCall",
    "ForLoop",
    "IfBlock",
    "BlockRef",
    "ConstRef",
    "BoundArg",
    "DependencySolver",
]
