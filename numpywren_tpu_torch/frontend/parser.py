"""DSL parser: restricted Python -> loop-nest IR (reference: lpcompile in
numpywren/frontend.py, which also parses via the `ast` module).

lpcompile accepts a function (or its source) whose body consists solely of
`for ... in range(...)` loops, `if` blocks over index expressions, and
(tuple-)assignments of registered kernels to matrix block refs.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import List

from numpywren_tpu_torch import kernels
from numpywren_tpu_torch.exceptions import CompilationError
from numpywren_tpu_torch.frontend.ir import (
    BlockRef,
    ConstRef,
    ForLoop,
    IfBlock,
    IndexExpr,
    KernelCall,
    LoopSpec,
    ProgramTemplate,
    Stmt,
)


def lpcompile(fn_or_source) -> ProgramTemplate:
    """Parse a DSL function into a ProgramTemplate (compile-time half of the
    reference's lpcompile; the schedule is built at bind() time)."""
    if isinstance(fn_or_source, str):
        source = textwrap.dedent(fn_or_source)
    else:
        source = textwrap.dedent(inspect.getsource(fn_or_source))
    tree = ast.parse(source)
    fndefs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    if len(fndefs) != 1:
        raise CompilationError("lpcompile expects exactly one function definition")
    fndef = fndefs[0]
    arg_names = [a.arg for a in fndef.args.args]
    parser = _Parser(arg_names)
    body = parser.parse_block(fndef.body, loops=(), conds=())
    return ProgramTemplate(fndef.name, arg_names, body, source)


class _Parser:
    def __init__(self, arg_names):
        self.arg_names = set(arg_names)
        self.stmt_counter = 0

    def parse_block(self, nodes, loops, conds) -> List[Stmt]:
        out: List[Stmt] = []
        for node in nodes:
            if isinstance(node, ast.For):
                out.append(self.parse_for(node, loops, conds))
            elif isinstance(node, ast.If):
                out.append(self.parse_if(node, loops, conds))
            elif isinstance(node, ast.Assign):
                out.append(self.parse_assign(node, loops, conds))
            elif (
                isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Name)
                and node.value.func.id == "reducer"
            ):
                out.append(self.expand_reducer(node.value, loops, conds))
            elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
                continue  # docstring
            elif isinstance(node, ast.Pass):
                continue
            else:
                raise CompilationError(
                    f"unsupported statement at line {node.lineno}: {ast.dump(node)[:120]}"
                )
        return out

    def parse_for(self, node: ast.For, loops, conds) -> ForLoop:
        if not isinstance(node.target, ast.Name):
            raise CompilationError(f"line {node.lineno}: loop target must be a name")
        it = node.iter
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name) and it.func.id == "range"):
            raise CompilationError(f"line {node.lineno}: loops must iterate over range(...)")
        args = [IndexExpr(a) for a in it.args]
        if len(args) == 1:
            start, stop, step = IndexExpr(ast.Constant(0)), args[0], None
        elif len(args) == 2:
            start, stop, step = args[0], args[1], None
        elif len(args) == 3:
            start, stop, step = args
        else:
            raise CompilationError(f"line {node.lineno}: range takes 1-3 args")
        if node.orelse:
            raise CompilationError(f"line {node.lineno}: for/else not supported")
        var = node.target.id
        spec = LoopSpec(var, start, stop, step)
        body = self.parse_block(node.body, loops + (spec,), conds)
        return ForLoop(var, start, stop, step, body)

    def parse_if(self, node: ast.If, loops, conds) -> IfBlock:
        cond = IndexExpr(node.test)
        body = self.parse_block(node.body, loops, conds + ((cond, True),))
        orelse = self.parse_block(node.orelse, loops, conds + ((cond, False),))
        return IfBlock(cond, body, orelse)

    def parse_assign(self, node: ast.Assign, loops, conds) -> KernelCall:
        if len(node.targets) != 1:
            raise CompilationError(f"line {node.lineno}: chained assignment not supported")
        target = node.targets[0]
        if isinstance(target, ast.Tuple):
            out_nodes = target.elts
        else:
            out_nodes = [target]
        outputs = tuple(self.parse_block_ref(t) for t in out_nodes)

        call = node.value
        if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)):
            raise CompilationError(f"line {node.lineno}: rhs must be a kernel call")
        op = call.func.id
        if op not in kernels.KERNELS:
            raise CompilationError(f"line {node.lineno}: unknown kernel {op!r}")
        n_out = kernels.N_OUTPUTS[op]
        if len(outputs) != n_out:
            raise CompilationError(
                f"line {node.lineno}: kernel {op} produces {n_out} outputs, got {len(outputs)} targets"
            )
        if call.keywords:
            raise CompilationError(f"line {node.lineno}: keyword args not supported in kernel calls")
        inputs = []
        for a in call.args:
            if isinstance(a, ast.Subscript):
                inputs.append(self.parse_block_ref(a))
            else:
                inputs.append(ConstRef(IndexExpr(a)))
        kc = KernelCall(
            stmt_id=self.stmt_counter,
            op=op,
            outputs=outputs,
            inputs=tuple(inputs),
            loop_vars=tuple(l.var for l in loops),
            loops=loops,
            conds=conds,
        )
        self.stmt_counter += 1
        return kc

    def expand_reducer(self, call: ast.Call, loops, conds) -> ForLoop:
        """The `reducer` construct (reference: numpywren frontend's reducer,
        compiled into log-depth tree-reduction loop levels with a branching
        factor `b_fac` — SURVEY §2 L5):

            reducer(ACC, *extras, combine, passthrough, N, L, b_fac=2)

        With the default b_fac=2 it expands to the binary combine tree

            for l in range(0, L):
                for i in range(0, cdiv(N, 2 ** (l + 1))):
                    if 2 * i + 1 < cdiv(N, 2 ** l):
                        extras[...][i, l], ACC[i, l + 1] = combine(
                            ACC[2 * i, l], ACC[2 * i + 1, l])
                    else:
                        ACC[i, l + 1] = passthrough(ACC[2 * i, l])

        For b_fac = b > 2, `combine` names an arity FAMILY: the registry
        must hold kernels f"{combine}{m}" for every group size m in 2..b
        (e.g. qr_combine_r2..qr_combine_r4 for b_fac=4), and each level
        combines groups of b children with a nested if-chain handling the
        one ragged tail group (size 1 falls through to `passthrough`).

        ACC is versioned by tree level; `extras` receive the combine
        kernel's side outputs (len == kernel outputs - 1); N is the leaf
        count, L the tree depth ceil(log_b(N)) (both index expressions);
        b_fac must be a literal int (the expansion is static)."""
        args = call.args
        b_fac = 2
        if call.keywords:
            if (len(call.keywords) != 1 or call.keywords[0].arg != "b_fac"
                    or not isinstance(call.keywords[0].value, ast.Constant)
                    or not isinstance(call.keywords[0].value.value, int)):
                raise CompilationError(
                    f"line {call.lineno}: reducer's only keyword is "
                    f"b_fac=<int literal>"
                )
            b_fac = call.keywords[0].value.value
            if not 2 <= b_fac <= kernels.MAX_REDUCER_ARITY:
                raise CompilationError(
                    f"line {call.lineno}: b_fac must be in "
                    f"[2, {kernels.MAX_REDUCER_ARITY}], got {b_fac}"
                )
        if len(args) < 5:
            raise CompilationError(
                f"line {call.lineno}: reducer(ACC, *extras, combine, "
                f"passthrough, N, L) requires >= 5 positional args"
            )
        n_src = ast.unparse(args[-2])
        l_src = ast.unparse(args[-1])
        names = args[:-2]
        if not all(isinstance(a, ast.Name) for a in names):
            raise CompilationError(
                f"line {call.lineno}: reducer matrices/kernels must be names"
            )
        acc = names[0].id
        combine = names[-2].id
        passthrough = names[-1].id
        extras = [a.id for a in names[1:-2]]
        if passthrough not in kernels.KERNELS:
            raise CompilationError(f"line {call.lineno}: unknown kernel {passthrough!r}")
        if b_fac == 2:
            arity_ops = {2: combine}
        else:
            arity_ops = {m: f"{combine}{m}" for m in range(2, b_fac + 1)}
        n_out = None
        for op in arity_ops.values():
            if op not in kernels.KERNELS:
                raise CompilationError(f"line {call.lineno}: unknown kernel {op!r}")
            if n_out is None:
                n_out = kernels.N_OUTPUTS[op]
            elif kernels.N_OUTPUTS[op] != n_out:
                raise CompilationError(
                    f"line {call.lineno}: combine family {combine!r} has "
                    f"inconsistent output counts across arities"
                )
        want = n_out - 1
        if len(extras) != want:
            raise CompilationError(
                f"line {call.lineno}: {arity_ops[b_fac]} has {want + 1} outputs; "
                f"reducer got {len(extras)} extra output matrices, need {want}"
            )
        lv = f"_rl{self.stmt_counter}"
        iv = f"_ri{self.stmt_counter}"
        extra_outs = "".join(f"{e}[{iv}, {lv}], " for e in extras)
        b = b_fac
        lines = [
            f"for {lv} in range(0, {l_src}):",
            f"    for {iv} in range(0, cdiv({n_src}, {b} ** ({lv} + 1))):",
        ]
        # nested if-chain over the tail group's size: a group of m children
        # exists iff its last child b*i + m - 1 is below the level's live
        # count cdiv(N, b**l); m == 1 degenerates to passthrough
        pad = "        "
        for m in range(b, 1, -1):
            child_args = ", ".join(
                (f"{acc}[{b} * {iv}, {lv}]" if c == 0
                 else f"{acc}[{b} * {iv} + {c}, {lv}]") for c in range(m)
            )
            lines.append(
                f"{pad}if {b} * {iv} + {m - 1} < cdiv({n_src}, {b} ** {lv}):"
            )
            lines.append(
                f"{pad}    {extra_outs}{acc}[{iv}, {lv} + 1] = "
                f"{arity_ops[m]}({child_args})"
            )
            lines.append(f"{pad}else:")
            pad += "    "
        lines.append(
            f"{pad}{acc}[{iv}, {lv} + 1] = {passthrough}({acc}[{b} * {iv}, {lv}])"
        )
        tree = ast.parse("\n".join(lines)).body[0]
        return self.parse_for(tree, loops, conds)

    def parse_block_ref(self, node) -> BlockRef:
        if not isinstance(node, ast.Subscript):
            raise CompilationError(
                f"line {getattr(node, 'lineno', '?')}: expected matrix[block index] reference"
            )
        if not isinstance(node.value, ast.Name):
            raise CompilationError(f"line {node.lineno}: matrix must be a plain name")
        mat = node.value.id
        sl = node.slice
        if isinstance(sl, ast.Tuple):
            idxs = tuple(IndexExpr(e) for e in sl.elts)
        else:
            idxs = (IndexExpr(sl),)
        return BlockRef(mat, idxs)
