"""On-demand symbolic dependency solver (reference parity:
numpywren/frontend.py :: get_children / get_parents, SURVEY §3.4).

The reference never materializes its task DAG: given "statement e just wrote
block W", it solves  read_access(e', vars') == W  with sympy over the loop
bounds, at runtime, inside every post_op. The TPU rebuild schedules
statically (compiler.schedule enumerates the DAG once), but this solver is
kept as a first-class component because it is what makes program metadata
O(program text): resumption, distributed-controller variants, and the
compiler's own cross-checks (tests) use it.

Method per query: for each candidate statement and access on the same
matrix, sympy-solve the affine equations for as many loop vars as possible,
then enumerate any remaining free vars over their (numerically evaluated)
loop ranges, checking bounds and if-conditions. This solves affine systems
exactly and degrades to bounded enumeration for non-affine programs (e.g.
the 2**level TSQR tree).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import sympy

from numpywren_tpu_torch.frontend.ir import BlockRef, KernelCall, ProgramTemplate


class DependencySolver:
    def __init__(self, template: ProgramTemplate, consts: Dict[str, int]):
        self.template = template
        self.consts = dict(consts)
        self._sym_cache: Dict[str, sympy.Expr] = {}

    # ------------------------------------------------------------ helpers
    def _sympify(self, src: str) -> sympy.Expr:
        if src not in self._sym_cache:
            expr = sympy.sympify(src, locals={"cdiv": sympy.Function("cdiv")})
            self._sym_cache[src] = expr.subs(
                {sympy.Symbol(k): v for k, v in self.consts.items()}
            )
        return self._sym_cache[src]

    def _env(self, stmt: KernelCall, var_values: Sequence[int]) -> Dict[str, int]:
        env = dict(self.consts)
        env.update(zip(stmt.loop_vars, var_values))
        return env

    def _instance_addrs(self, stmt: KernelCall, var_values, which: str):
        env = self._env(stmt, var_values)
        refs = stmt.outputs if which == "writes" else tuple(
            r for r in stmt.inputs if isinstance(r, BlockRef)
        )
        return [r.addr(env) for r in refs]

    # ---------------------------------------------------------- public API
    def get_children(self, stmt_id: int, var_values: Tuple[int, ...]) -> List[Tuple[int, Tuple[int, ...]]]:
        """All statement instances that READ a block this instance writes."""
        stmt = self.template.statements[stmt_id]
        targets = self._instance_addrs(stmt, var_values, "writes")
        out = set()
        for t in targets:
            for other in self.template.statements:
                reads = [r for r in other.inputs if isinstance(r, BlockRef) and r.matrix == t[0]]
                for ref in reads:
                    for vals in self._solve(other, ref, t[1:]):
                        if other.stmt_id == stmt_id and vals == tuple(var_values):
                            continue
                        out.add((other.stmt_id, vals))
        return sorted(out)

    def get_parents(self, stmt_id: int, var_values: Tuple[int, ...]) -> List[Tuple[int, Tuple[int, ...]]]:
        """All statement instances that WRITE a block this instance reads."""
        stmt = self.template.statements[stmt_id]
        targets = self._instance_addrs(stmt, var_values, "reads")
        out = set()
        for t in targets:
            for other in self.template.statements:
                writes = [w for w in other.outputs if w.matrix == t[0]]
                for ref in writes:
                    for vals in self._solve(other, ref, t[1:]):
                        if other.stmt_id == stmt_id and vals == tuple(var_values):
                            continue
                        out.add((other.stmt_id, vals))
        return sorted(out)

    # ------------------------------------------------------------- solving
    def _solve(self, stmt: KernelCall, ref: BlockRef, target: Tuple[int, ...]):
        """Yield loop-var assignments of `stmt` for which ref's indices equal
        `target`, within loop bounds and if-conditions."""
        if len(ref.idxs) != len(target):
            return
        # 1) symbolic solve for determined vars
        syms = [sympy.Symbol(v, integer=True) for v in stmt.loop_vars]
        solved: Dict[str, sympy.Expr] = {}
        try:
            eqs = [
                sympy.Eq(self._sympify(ix.src), int(tv))
                for ix, tv in zip(ref.idxs, target)
            ]
            sol = sympy.solve(eqs, syms, dict=True)
            if isinstance(sol, list) and len(sol) == 1:
                for s, e in sol[0].items():
                    solved[str(s)] = e
            elif sol == []:
                # either inconsistent (no solution) or solve gave up; fall
                # back to enumeration (inconsistency is caught by the final
                # equation check there)
                pass
        except Exception:
            pass  # non-affine (cdiv / **): pure enumeration below

        # 2) walk loops outermost-in: substitute solved vars, enumerate free
        env = dict(self.consts)

        def rec(li: int):
            if li == len(stmt.loops):
                # all vars bound: verify equations + conditions
                e2 = {k: v for k, v in env.items()}
                for ix, tv in zip(ref.idxs, target):
                    if ix.eval(e2) != tv:
                        return
                for cond, taken in stmt.conds:
                    if bool(cond.eval(e2)) != taken:
                        return
                yield tuple(env[v] for v in stmt.loop_vars)
                return
            loop = stmt.loops[li]
            start = loop.start.eval(env)
            stop = loop.stop.eval(env)
            step = loop.step.eval(env) if loop.step is not None else 1
            expr = solved.get(loop.var)
            if expr is not None:
                val = expr.subs({sympy.Symbol(k): v for k, v in env.items() if isinstance(v, int)})
                if val.free_symbols:
                    candidates = range(start, stop, step)  # still underdetermined here
                else:
                    v = int(val)
                    in_range = (
                        (start <= v < stop and (v - start) % step == 0)
                        if step > 0
                        else (stop < v <= start and (start - v) % (-step) == 0)
                    )
                    candidates = [v] if in_range else []
            else:
                candidates = range(start, stop, step)
            for v in candidates:
                env[loop.var] = v
                yield from rec(li + 1)
            env.pop(loop.var, None)

        yield from rec(0)
