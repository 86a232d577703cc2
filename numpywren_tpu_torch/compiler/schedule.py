"""Enumerate a bound DSL program into a scheduled task DAG.

Pipeline (the reference does step 3 lazily per post_op at runtime, see
SURVEY §3.4):

1. walk the loop nest with concrete bounds, emitting one node per
   KernelCall instance (node id = (stmt_id, loop-var values), exactly the
   reference's (expr_idx, var_values) node identity);
2. build the write map  (matrix, *block idx) -> writer node  and resolve
   every read to its writer (RAW edges); unresolved reads become the
   program's initial-input set;
3. lower versioned scratch matrices onto in-place physical tiles, adding
   write-after-read (WAR) edges so version v+1 may only overwrite (i, j)
   after every reader of version v has run;
4. Kahn-level the DAG: level(n) = 1 + max(level(parents)) — these wavefront
   levels are the static schedule (each level is one SPMD step).

A user's program runs these passes at bind, so its CompilationErrors are
raised there. A template of the package's own entries (`defer_schedule`,
set by alg_wrappers) runs them at the schedule's first read instead: the
fused lowering reads none of it, so a fused run never builds it.

Counters (program counters, as gemm3.LAUNCHES): `BINDS` counts programs
bound, `SCHEDULES_BUILT` schedules built (native core or Python passes);
1 - SCHEDULES_BUILT / BINDS is the share of binds that built nothing.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from numpywren_tpu_torch import kernels
from numpywren_tpu_torch.exceptions import CompilationError
from numpywren_tpu_torch.metrics import span
from numpywren_tpu_torch.frontend.ir import (
    BlockRef,
    BoundArg,
    ConstRef,
    ForLoop,
    IfBlock,
    KernelCall,
    ProgramTemplate,
)

BINDS = 0  # programs bound (compile_schedule calls that returned a program)
SCHEDULES_BUILT = 0  # schedules built, by the native core or the Python passes
_COUNTERS = threading.Lock()  # both of the above


@dataclasses.dataclass
class Node:
    """One statement instance (the reference's DAG node / InstructionBlock)."""

    node_id: int
    stmt_id: int
    op: str
    var_values: Tuple[int, ...]
    # physical addresses: (matrix_name, i, j)
    reads: Tuple[Tuple, ...]       # block reads, physical
    writes: Tuple[Tuple, ...]      # block writes, physical
    consts: Tuple[int, ...]        # scalar args, in input position order
    input_kinds: Tuple[str, ...]   # "block" | "const" per input position
    read_versions: Tuple[Optional[int], ...] = ()
    write_versions: Tuple[Optional[int], ...] = ()


class ScheduledDAG:
    """The compiled program: nodes + edges + wavefront levels + bindings.

    It keeps the template, the bound matrices and the consts, which is all
    the schedule is made from, and builds the schedule (`build`) once, under
    a lock, at bind for a user's program and at the first read of `nodes`,
    `parents`, `children`, `levels`, `node_level`, `initial_reads` or
    `num_nodes` for a deferred one (LocalExecutor's threads may be the first
    readers). The build is the `bind.schedule` span wherever it runs: under
    `bind` at an eager bind, under `run` when a generic executor is the
    first reader. The native (C++) core leaves raw int64 tables in
    `_native`; the Python-facing Node list and edge lists materialize from
    them at first access, so giant grids never pay for 10^5-10^6 Python
    objects that nothing reads. NPW_NATIVE is read at bind."""

    def __init__(self, template, matrices: Dict[str, BoundArg], consts: Dict[str, int]):
        self.template = template
        self.matrices = matrices
        self.consts = consts
        self._native_mode = os.environ.get("NPW_NATIVE", "auto")
        self._lock = threading.Lock()
        self._built = False
        self._nodes: Optional[List[Node]] = None
        self._parents: Optional[List[List[int]]] = None
        self._children: Optional[List[List[int]]] = None
        self._levels: Optional[List[List[int]]] = None
        self._node_level: Optional[List[int]] = None
        self._initial_reads: set = set()
        self._native = None  # raw tables from the C++ core

    def build(self) -> None:
        """Enumerate, resolve the edges and level the DAG, once: the native
        core where it takes the program, else the Python passes. Raises the
        program's CompilationError (and raises it again at a later read)."""
        global SCHEDULES_BUILT
        if self._built:
            return
        with self._lock:
            if self._built:
                return
            with span("bind.schedule"):
                self._initial_reads = set()
                if not _try_native(self):
                    self._nodes = []
                    _enumerate(self.template.body, dict(self.consts), self, self.matrices)
                    _resolve_edges(self)
                    _level(self)
            with _COUNTERS:
                SCHEDULES_BUILT += 1
            self._built = True

    # --- views, built and materialized at first access ------------------
    @property
    def nodes(self) -> List[Node]:
        self.build()
        if self._nodes is None:
            from numpywren_tpu_torch.native.schedule_native import materialize_nodes

            with self._lock:
                if self._nodes is None:
                    self._nodes = materialize_nodes(self)
        return self._nodes

    def _edges(self) -> None:
        self.build()
        if self._parents is None:
            from numpywren_tpu_torch.native.schedule_native import materialize_edges

            with self._lock:
                if self._parents is None:
                    materialize_edges(self)

    @property
    def parents(self) -> List[List[int]]:
        self._edges()
        return self._parents

    @property
    def children(self) -> List[List[int]]:
        self._edges()
        return self._children

    @property
    def levels(self) -> List[List[int]]:
        self._edges()
        return self._levels

    @property
    def node_level(self) -> List[int]:
        self._edges()
        return self._node_level

    @property
    def initial_reads(self) -> set:
        self.build()
        return self._initial_reads

    @property
    def num_nodes(self) -> int:
        self.build()
        if self._nodes is None:
            return self._native["n"]
        return len(self._nodes)

    def total_flops(self) -> int:
        total = 0
        for n in self.nodes:
            shapes = [self.matrices[r[0]].matrix.tile for r in n.reads]
            total += kernels.flop_count(n.op, shapes)
        return total

    def stats(self) -> Dict[str, Any]:
        ops: Dict[str, int] = {}
        for n in self.nodes:
            ops[n.op] = ops.get(n.op, 0) + 1
        return {
            "nodes": self.num_nodes,
            "levels": len(self.levels),
            "edges": sum(len(p) for p in self.parents),
            "ops": ops,
            "flops": self.total_flops(),
        }


def compile_schedule(template: ProgramTemplate, bindings: Dict[str, Any]):
    """Bind the arguments and return a runtime TiledProgram: the bindings
    are checked here, and the schedule (enumerate + DAG + levels) is built
    here too unless the template defers it to its first read
    (`template.defer_schedule`, the package's entries)."""
    global BINDS
    matrices: Dict[str, BoundArg] = {}
    consts: Dict[str, int] = {}
    for name, val in bindings.items():
        if name not in template.arg_names:
            raise CompilationError(f"{template.name}: unknown argument {name!r}")
        if isinstance(val, BoundArg):
            val.name = name
            matrices[name] = val
        elif isinstance(val, (int,)):
            consts[name] = int(val)
        elif hasattr(val, "get_block"):
            matrices[name] = BoundArg(name=name, matrix=val)
        else:
            raise CompilationError(f"argument {name!r}: expected TiledMatrix/BoundArg/int, got {type(val)}")
    missing = set(template.arg_names) - set(matrices) - set(consts)
    if missing:
        raise CompilationError(f"{template.name}: unbound arguments {sorted(missing)}")

    dag = ScheduledDAG(template, matrices, consts)
    if not template.defer_schedule:
        dag.build()

    from numpywren_tpu_torch.runtime.program import TiledProgram

    with span("bind.program"):
        program = TiledProgram(dag)
    with _COUNTERS:
        BINDS += 1
    return program


def _try_native(dag) -> bool:
    """Run the C++ schedule core (numpywren_tpu_torch/native) when available.
    NPW_NATIVE (as it was at bind) =0 disables it, =1 makes unavailability
    an error; default: use it opportunistically, fall back to the Python
    passes."""
    mode = dag._native_mode
    if mode == "0":
        return False
    try:
        from numpywren_tpu_torch.native.schedule_native import compile_native
    except ImportError:
        if mode == "1":
            raise CompilationError("NPW_NATIVE=1 but native core not importable")
        return False
    ok = compile_native(dag)
    if ok is None and mode == "1":
        raise CompilationError("NPW_NATIVE=1 but native core unavailable/unsupported")
    return bool(ok)


# ---------------------------------------------------------------------------
# Pass 1: enumeration
# ---------------------------------------------------------------------------

def _addr(ref: BlockRef, env, matrices) -> Tuple[Tuple, Optional[int]]:
    """Evaluate a block ref to (physical addr, version). The version is the
    trailing index of a versioned matrix (BoundArg.versioned)."""
    ba = matrices.get(ref.matrix)
    if ba is None:
        raise CompilationError(f"reference to unbound matrix {ref.matrix!r}")
    idxs = tuple(ix.eval(env) for ix in ref.idxs)
    if ba.versioned:
        if len(idxs) < 2:
            raise CompilationError(f"{ref!r}: versioned matrix needs >= 2 indices + version")
        phys = (ref.matrix,) + idxs[:-1]
        return phys, idxs[-1]
    return (ref.matrix,) + idxs, None


def _enumerate(stmts, env, dag: ScheduledDAG, matrices):
    for s in stmts:
        if isinstance(s, ForLoop):
            start = s.start.eval(env)
            stop = s.stop.eval(env)
            step = s.step.eval(env) if s.step is not None else 1
            for v in range(start, stop, step):
                env[s.var] = v
                _enumerate(s.body, env, dag, matrices)
            env.pop(s.var, None)
        elif isinstance(s, IfBlock):
            branch = s.body if s.cond.eval(env) else s.orelse
            _enumerate(branch, env, dag, matrices)
        elif isinstance(s, KernelCall):
            reads, consts_args, kinds = [], [], []
            rvers = []
            for inp in s.inputs:
                if isinstance(inp, ConstRef):
                    consts_args.append(inp.expr.eval(env))
                    kinds.append("const")
                else:
                    a, ver = _addr(inp, env, matrices)
                    reads.append(a)
                    rvers.append(ver)
                    kinds.append("block")
            writes, wvers = [], []
            for out in s.outputs:
                a, ver = _addr(out, env, matrices)
                writes.append(a)
                wvers.append(ver)
            node = Node(
                node_id=len(dag._nodes),
                stmt_id=s.stmt_id,
                op=s.op,
                var_values=tuple(env[v] for v in s.loop_vars),
                reads=tuple(reads),
                writes=tuple(writes),
                consts=tuple(consts_args),
                input_kinds=tuple(kinds),
                read_versions=tuple(rvers),
                write_versions=tuple(wvers),
            )
            dag._nodes.append(node)
        else:
            raise CompilationError(f"unexpected IR node {s!r}")


# ---------------------------------------------------------------------------
# Pass 2: RAW edges from the write map (+ WAR edges for versioned reuse)
# ---------------------------------------------------------------------------

def _resolve_edges(dag: ScheduledDAG):
    matrices = dag.matrices
    # write map keyed on (phys addr, version) for versioned, (addr, None) else
    write_map: Dict[Tuple, int] = {}
    for n in dag._nodes:
        for a, v in zip(n.writes, n.write_versions):
            key = (a, v)
            if key in write_map:
                other = dag._nodes[write_map[key]]
                raise CompilationError(
                    f"double write to {a} (version {v}) by S{other.stmt_id}{other.var_values} "
                    f"and S{n.stmt_id}{n.var_values}; programs must be single-assignment "
                    f"(use a versioned scratch matrix)"
                )
            write_map[key] = n.node_id

    n_nodes = len(dag._nodes)
    parent_sets: List[set] = [set() for _ in range(n_nodes)]
    readers_of: Dict[Tuple, List[int]] = {}

    for n in dag._nodes:
        for a, v in zip(n.reads, n.read_versions):
            w = write_map.get((a, v))
            if w is None:
                # initial input: must pre-exist in physical storage
                if v not in (None, 0) and matrices[a[0]].versioned:
                    raise CompilationError(
                        f"S{n.stmt_id}{n.var_values} reads {a} version {v}, which nothing writes"
                    )
                dag._initial_reads.add(a)
            elif w == n.node_id:
                raise CompilationError(
                    f"S{n.stmt_id}{n.var_values} reads its own output {a}; use a versioned scratch"
                )
            else:
                parent_sets[n.node_id].add(w)
            if matrices[a[0]].versioned:
                readers_of.setdefault((a, v), []).append(n.node_id)

    # WAR: writer of (addr, v+1) must wait for all readers of (addr, v)
    for n in dag._nodes:
        for a, v in zip(n.writes, n.write_versions):
            if v is None or v == 0:
                continue
            for r in readers_of.get((a, v - 1), ()):
                if r != n.node_id:
                    parent_sets[n.node_id].add(r)

    parents = [sorted(s) for s in parent_sets]
    children: List[List[int]] = [[] for _ in range(n_nodes)]
    for nid, ps in enumerate(parents):
        for p in ps:
            children[p].append(nid)
    dag._children, dag._parents = children, parents


# ---------------------------------------------------------------------------
# Schedule transforms: critical-path priority + lookahead grouping
# ---------------------------------------------------------------------------

def critical_path_priority(dag: ScheduledDAG) -> List[int]:
    """priority[n] = number of nodes on the longest path from n to any sink
    (n included). The panel-factor chain of a factorization gets the highest
    values — the static analog of the reference's priority queues (upstream:
    numpywren/lambdapack.py post_op queue choice: critical-path children go
    to the high-priority SQS queue)."""
    prio = [1] * dag.num_nodes
    children = dag.children
    # dag.levels is ASAP order, so reverse-level iteration is reverse-topo
    for level in reversed(dag.levels):
        for nid in level:
            for c in children[nid]:
                if prio[c] + 1 > prio[nid]:
                    prio[nid] = prio[c] + 1
    return prio


def grouped_schedule(dag: ScheduledDAG, policy: str = "wavefront"):
    """The executable schedule: an ordered list of groups
    ``(stmt_id, consts, [node_ids])``. Nodes inside one group are mutually
    independent (one batched device op); executing groups in list order
    respects every DAG edge — groups may depend on earlier groups, there is
    no barrier requirement between them.

    policy="wavefront": statement groups inside each Kahn level (the strict
    wavefront the executors ran through round 3).

    policy="lookahead": depth-priority list scheduling (SURVEY §7 layer 4,
    VERDICT r3 missing #3). Ready nodes are bucketed by (statement,
    critical-path priority) and the highest-priority bucket is emitted
    first, so e.g. for cholesky the k+1 panel's potrf/trsm are emitted
    BEFORE step k's bulk trailing updates — a pipelined executor then
    overlaps the next panel's I/O and factor with the bulk GEMMs, the
    reference's signature DAG-overlap benefit for ARBITRARY DSL programs.
    """
    nodes = dag.nodes
    if policy == "wavefront":
        out = []
        for level in dag.levels:
            groups: Dict = {}
            for nid in level:
                n = nodes[nid]
                groups.setdefault((n.stmt_id, n.consts), []).append(nid)
            out.extend(
                (sid, consts, members)
                for (sid, consts), members in sorted(groups.items(), key=lambda kv: kv[0])
            )
        return out
    if policy != "lookahead":
        raise ValueError(f"unknown schedule policy {policy!r}")

    import heapq

    prio = critical_path_priority(dag)
    indeg = [len(p) for p in dag.parents]
    children = dag.children
    # ready buckets keyed by (-priority, stmt_id, consts); heap orders them
    buckets: Dict[Tuple, List[int]] = {}
    heap: List[Tuple] = []

    def push(nid: int):
        n = nodes[nid]
        key = (-prio[nid], n.stmt_id, n.consts)
        b = buckets.get(key)
        if b is None:
            buckets[key] = [nid]
            heapq.heappush(heap, key)
        else:
            b.append(nid)

    for nid in range(dag.num_nodes):
        if indeg[nid] == 0:
            push(nid)
    out = []
    emitted = 0
    while heap:
        key = heapq.heappop(heap)
        members = buckets.pop(key)
        # mutually independent by construction: all were simultaneously ready
        out.append((key[1], key[2], members))
        emitted += len(members)
        for nid in members:
            for c in children[nid]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    push(c)
    if emitted != dag.num_nodes:
        raise CompilationError("dependency cycle detected in tiled program")
    return out


# ---------------------------------------------------------------------------
# Pass 3: wavefront levels (Kahn)
# ---------------------------------------------------------------------------

def _level(dag: ScheduledDAG):
    from collections import deque

    n_nodes = len(dag._nodes)
    indeg = [len(p) for p in dag._parents]
    level = [0] * n_nodes
    q = deque(i for i in range(n_nodes) if indeg[i] == 0)
    seen = 0
    while q:
        nid = q.popleft()
        seen += 1
        for c in dag._children[nid]:
            if level[nid] + 1 > level[c]:
                level[c] = level[nid] + 1
            indeg[c] -= 1
            if indeg[c] == 0:
                q.append(c)
    if seen != n_nodes:
        raise CompilationError("dependency cycle detected in tiled program")
    n_levels = (max(level) + 1) if level else 0
    levels: List[List[int]] = [[] for _ in range(n_levels)]
    for nid, lv in enumerate(level):
        levels[lv].append(nid)
    dag._node_level = level
    dag._levels = levels
