"""Loop-nest IR for the tiled-program DSL.

Rebuild analog of the reference's statement/loop IR + BigMatrixBlock refs
(numpywren/frontend.py). Index expressions are kept as Python AST and
compiled once per expression; enumeration evaluates them concretely, the
sympy solver converts them symbolically.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from numpywren_tpu_torch.exceptions import CompilationError

# names usable inside index expressions, beyond loop vars and program consts
_EXPR_HELPERS = {
    "min": min,
    "max": max,
    "abs": abs,
    "cdiv": lambda a, b: -(-a // b),
}


class IndexExpr:
    """One integer index expression: AST + compiled code + free variables."""

    __slots__ = ("src", "_code", "names", "tree")

    def __init__(self, node: ast.expr):
        self.tree = node
        self.src = ast.unparse(node)
        expr = ast.Expression(body=node)
        ast.fix_missing_locations(expr)
        self._code = compile(expr, "<lpdsl>", "eval")
        self.names = sorted(
            {n.id for n in ast.walk(node) if isinstance(n, ast.Name) and n.id not in _EXPR_HELPERS}
        )

    def eval(self, env: Dict[str, int]) -> int:
        v = eval(self._code, {"__builtins__": {}, **_EXPR_HELPERS}, env)
        if isinstance(v, bool):
            return v
        if not isinstance(v, (int,)):
            raise CompilationError(f"index expression {self.src!r} evaluated to non-int {v!r}")
        return v

    def __repr__(self):
        return f"IndexExpr({self.src})"


@dataclasses.dataclass(frozen=True)
class BlockRef:
    """A tiled-matrix block reference M[e0, e1, ...] (BigMatrixBlock analog)."""

    matrix: str
    idxs: Tuple[IndexExpr, ...]

    def addr(self, env: Dict[str, int]) -> Tuple:
        return (self.matrix,) + tuple(ix.eval(env) for ix in self.idxs)

    def __repr__(self):
        return f"{self.matrix}[{', '.join(ix.src for ix in self.idxs)}]"


@dataclasses.dataclass(frozen=True)
class ConstRef:
    """A scalar constant argument to a kernel call."""

    expr: IndexExpr

    def __repr__(self):
        return f"Const({self.expr.src})"


Ref = Union[BlockRef, ConstRef]


@dataclasses.dataclass(frozen=True)
class LoopSpec:
    """One enclosing loop of a statement: var + bound expressions (bounds may
    reference outer loop vars — triangular nests)."""

    var: str
    start: IndexExpr
    stop: IndexExpr
    step: Optional[IndexExpr]


@dataclasses.dataclass
class KernelCall:
    """outputs = op(inputs) — one statement; instances of it are DAG nodes."""

    stmt_id: int
    op: str
    outputs: Tuple[BlockRef, ...]
    inputs: Tuple[Ref, ...]
    loop_vars: Tuple[str, ...]  # enclosing loop variables, outermost first
    loops: Tuple["LoopSpec", ...] = ()           # bounds, outermost first
    conds: Tuple[Tuple[IndexExpr, bool], ...] = ()  # (condition, branch-taken)

    def __repr__(self):
        outs = ", ".join(map(repr, self.outputs))
        ins = ", ".join(map(repr, self.inputs))
        return f"S{self.stmt_id}: {outs} = {self.op}({ins})"


@dataclasses.dataclass
class ForLoop:
    var: str
    start: IndexExpr
    stop: IndexExpr
    step: Optional[IndexExpr]
    body: List["Stmt"]


@dataclasses.dataclass
class IfBlock:
    cond: IndexExpr
    body: List["Stmt"]
    orelse: List["Stmt"]


Stmt = Union[KernelCall, ForLoop, IfBlock]


@dataclasses.dataclass
class BoundArg:
    """Binding of a DSL matrix name to physical storage.

    versioned=True marks the reference's scratch-matrix trick: the DSL
    addresses the matrix with one extra trailing "version" index to stay
    single-assignment (e.g. S[i, j, k]); physically all versions share one
    (i, j) tile, and the schedule compiler adds the write-after-read edges
    that make in-place version reuse safe (SSA -> memory lowering).
    """

    name: str
    matrix: Any  # _TiledBase
    versioned: bool = False
    # highest version written per physical tile (versioned matrices only).
    # The reference stores each version as its own S3 key, so its resume
    # scan (block_idxs_exist) distinguishes versions for free; here all
    # versions alias one physical tile, so the frontier scan needs this map.
    written_versions: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict, repr=False
    )

    @property
    def phys_rank(self) -> int:
        return 2

    def note_write(self, idx: Tuple[int, int], version) -> None:
        if self.versioned and version is not None:
            cur = self.written_versions.get(idx, 0)
            if version > cur:
                self.written_versions[idx] = version

    def version_of(self, idx: Tuple[int, int]) -> int:
        """Current version held by physical tile idx (0 = the bind-time
        contents, e.g. scratch initialized from the input)."""
        return self.written_versions.get(idx, 0)


class ProgramTemplate:
    """Parsed DSL program: arg names + loop-nest body + flat statement list.

    `defer_schedule` is False for a template from lpcompile: its bind builds
    the schedule. The package's entries (alg_wrappers) set it on the
    templates they own, whose binds leave the schedule to its first read."""

    def __init__(self, name: str, arg_names: Sequence[str], body: List[Stmt], source: str):
        self.name = name
        self.arg_names = list(arg_names)
        self.body = body
        self.source = source
        self.statements: List[KernelCall] = []
        self.defer_schedule = False
        self._collect(body)

    def _collect(self, stmts: List[Stmt]):
        for s in stmts:
            if isinstance(s, KernelCall):
                self.statements.append(s)
            elif isinstance(s, ForLoop):
                self._collect(s.body)
            elif isinstance(s, IfBlock):
                self._collect(s.body)
                self._collect(s.orelse)

    def bind(self, **bindings):
        """Bind matrices (TiledMatrix / BoundArg) and integer constants;
        returns a compiled TiledProgram with its static schedule, built here
        (the program's CompilationErrors are raised here) unless
        `defer_schedule` leaves it to the schedule's first read."""
        from numpywren_tpu_torch.compiler.schedule import compile_schedule

        return compile_schedule(self, bindings)

    def __repr__(self):
        return f"ProgramTemplate({self.name}, args={self.arg_names}, {len(self.statements)} statements)"
