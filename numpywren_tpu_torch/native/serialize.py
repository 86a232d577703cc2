"""Serialize a bound ProgramTemplate into the native core's int64 protocol.

Expressions become postfix bytecode (see schedule_core.cpp enum Op); the
loop-nest body becomes a prefix-encoded FOR/IF/CALL stream. Anything the
bytecode cannot express raises NativeUnsupported and the compiler falls back
to the Python passes.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from numpywren_tpu_torch import kernels
from numpywren_tpu_torch.frontend.ir import (
    BlockRef,
    ConstRef,
    ForLoop,
    IfBlock,
    IndexExpr,
    KernelCall,
    ProgramTemplate,
)

PUSH_CONST, PUSH_VAR, ADD, SUB, MUL, FLOORDIV, MOD, POW, NEG, CDIV, MIN2, MAX2, \
    LT, LE, GT, GE, EQ, NE, AND2, OR2, NOT1, ABS1 = range(22)

T_FOR, T_IF, T_CALL = 1, 2, 3

OP_IDS = {name: i for i, name in enumerate(sorted(kernels.KERNELS))}
OP_NAMES = {i: name for name, i in OP_IDS.items()}


class NativeUnsupported(Exception):
    pass


_BINOPS = {
    ast.Add: ADD, ast.Sub: SUB, ast.Mult: MUL, ast.FloorDiv: FLOORDIV,
    ast.Mod: MOD, ast.Pow: POW,
}
_CMPS = {
    ast.Lt: LT, ast.LtE: LE, ast.Gt: GT, ast.GtE: GE, ast.Eq: EQ, ast.NotEq: NE,
}


class ExprEncoder:
    def __init__(self, var_slots: Dict[str, int]):
        self.var_slots = var_slots
        self.code: List[Tuple[int, int]] = []
        self.offsets: List[int] = []
        self.lengths: List[int] = []
        self._cache: Dict[str, int] = {}

    def encode(self, expr: IndexExpr) -> int:
        key = expr.src
        if key in self._cache:
            return self._cache[key]
        start = len(self.code)
        self._emit(expr.tree)
        eid = len(self.offsets)
        self.offsets.append(start)
        self.lengths.append(len(self.code) - start)
        self._cache[key] = eid
        return eid

    def _emit(self, node: ast.expr):
        code = self.code
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, int) or isinstance(node.value, bool):
                raise NativeUnsupported(f"non-int constant {node.value!r}")
            code.append((PUSH_CONST, node.value))
        elif isinstance(node, ast.Name):
            slot = self.var_slots.get(node.id)
            if slot is None:
                raise NativeUnsupported(f"unknown name {node.id!r}")
            code.append((PUSH_VAR, slot))
        elif isinstance(node, ast.BinOp):
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise NativeUnsupported(f"operator {type(node.op).__name__}")
            self._emit(node.left)
            self._emit(node.right)
            code.append((op, 0))
        elif isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                self._emit(node.operand)
                code.append((NEG, 0))
            elif isinstance(node.op, ast.Not):
                self._emit(node.operand)
                code.append((NOT1, 0))
            elif isinstance(node.op, ast.UAdd):
                self._emit(node.operand)
            else:
                raise NativeUnsupported(f"unary {type(node.op).__name__}")
        elif isinstance(node, ast.Compare):
            # chain a < b < c  =>  (a < b) and (b < c)
            self._emit(node.left)
            self._emit(node.comparators[0])
            op = _CMPS.get(type(node.ops[0]))
            if op is None:
                raise NativeUnsupported(f"compare {type(node.ops[0]).__name__}")
            code.append((op, 0))
            left = node.comparators[0]
            for cmp_op, right in zip(node.ops[1:], node.comparators[1:]):
                self._emit(left)
                self._emit(right)
                op = _CMPS.get(type(cmp_op))
                if op is None:
                    raise NativeUnsupported(f"compare {type(cmp_op).__name__}")
                code.append((op, 0))
                code.append((AND2, 0))
                left = right
        elif isinstance(node, ast.BoolOp):
            op = AND2 if isinstance(node.op, ast.And) else OR2
            self._emit(node.values[0])
            for v in node.values[1:]:
                self._emit(v)
                code.append((op, 0))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            fn = node.func.id
            if fn == "cdiv" and len(node.args) == 2:
                self._emit(node.args[0])
                self._emit(node.args[1])
                code.append((CDIV, 0))
            elif fn == "abs" and len(node.args) == 1:
                self._emit(node.args[0])
                code.append((ABS1, 0))
            elif fn in ("min", "max") and len(node.args) >= 2:
                self._emit(node.args[0])
                for a in node.args[1:]:
                    self._emit(a)
                    code.append((MIN2 if fn == "min" else MAX2, 0))
            else:
                raise NativeUnsupported(f"call {fn}/{len(node.args)}")
        else:
            raise NativeUnsupported(f"ast node {type(node).__name__}")


def serialize(template: ProgramTemplate, matrices: Dict, consts: Dict[str, int]):
    """-> (expr arrays, program stream, matrix table, var init, matrix order)

    matrices: name -> BoundArg (for the versioned flag). Raises
    NativeUnsupported for constructs outside the bytecode.
    """
    # variable slots: consts first (preloaded), then loop vars in discovery order
    var_slots: Dict[str, int] = {}
    init_vars: List[int] = []
    for name, val in consts.items():
        var_slots[name] = len(init_vars)
        init_vars.append(int(val))

    def loop_slot(var: str) -> int:
        if var not in var_slots:
            var_slots[var] = len(init_vars)
            init_vars.append(0)
        return var_slots[var]

    matrix_ids = {name: i for i, name in enumerate(sorted(matrices))}
    versioned = [0] * len(matrix_ids)
    for name, ba in matrices.items():
        versioned[matrix_ids[name]] = 1 if getattr(ba, "versioned", False) else 0

    enc = ExprEncoder(var_slots)
    prog: List[int] = []

    def emit_access(ref: BlockRef, is_versioned: bool):
        idxs = ref.idxs
        if is_versioned:
            if len(idxs) != 3:
                raise NativeUnsupported(f"versioned ref rank {len(idxs)} != 3")
            phys, ver = idxs[:2], idxs[2]
        else:
            if len(idxs) != 2:
                raise NativeUnsupported(f"ref rank {len(idxs)} != 2")
            phys, ver = idxs, None
        prog.append(matrix_ids[ref.matrix])
        prog.append(enc.encode(phys[0]))
        prog.append(enc.encode(phys[1]))
        prog.append(enc.encode(ver) if ver is not None else -1)

    def emit_list(stmts):
        prog.append(len(stmts))
        for s in stmts:
            emit_one(s)

    def emit_one(s):
        if isinstance(s, ForLoop):
            prog.append(T_FOR)
            prog.append(loop_slot(s.var))
            prog.append(enc.encode(s.start))
            prog.append(enc.encode(s.stop))
            prog.append(enc.encode(s.step) if s.step is not None else -1)
            emit_list(s.body)
        elif isinstance(s, IfBlock):
            prog.append(T_IF)
            prog.append(enc.encode(s.cond))
            emit_list(s.body)
            emit_list(s.orelse)
        elif isinstance(s, KernelCall):
            prog.append(T_CALL)
            prog.append(s.stmt_id)
            prog.append(OP_IDS[s.op])
            prog.append(len(s.loop_vars))
            for v in s.loop_vars:
                prog.append(loop_slot(v))
            prog.append(len(s.inputs))
            for inp in s.inputs:
                if isinstance(inp, ConstRef):
                    prog.append(1)
                    prog.append(enc.encode(inp.expr))
                else:
                    if inp.matrix not in matrix_ids:
                        raise NativeUnsupported(f"unbound matrix {inp.matrix!r}")
                    prog.append(0)
                    emit_access(inp, bool(versioned[matrix_ids[inp.matrix]]))
            prog.append(len(s.outputs))
            for out in s.outputs:
                if out.matrix not in matrix_ids:
                    raise NativeUnsupported(f"unbound matrix {out.matrix!r}")
                emit_access(out, bool(versioned[matrix_ids[out.matrix]]))
        else:
            raise NativeUnsupported(f"IR node {type(s).__name__}")

    emit_list(template.body)

    matrix_order = sorted(matrices)  # index == matrix id
    return enc, prog, versioned, init_vars, matrix_order
