"""TiledProgram: the compiled program object + node state machine.

Parity with numpywren/lambdapack.py :: LambdaPackProgram — node lifecycle
enum NS (NOT_READY -> READY -> RUNNING -> POST_OP -> FINISHED) with atomic
compare-and-swap transitions, program enum PS, start()/post_op()/wait()/
free()/get_node_status(), and per-node profiling counters (start/end time,
flops — the reference keeps these in Redis, SURVEY §5 tracing), which only
the dynamic executors fill: `profile` holds a node's dict from its first
record on, so a fused run's program never builds one. The per-node state
(`node_status`, `dep_count`) comes into being at start(), or at its first
read: a program that completed without start() (a fused run) then reads
every node FINISHED. Neither the constructor nor a fused run reads the
node count, so neither builds a deferred schedule.

Differences by design: the DAG is fully materialized (static schedule), so
post_op returns the precomputed children instead of re-solving them with
sympy; state lives in process memory guarded by one lock instead of Redis.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Dict, List, Optional

from numpywren_tpu_torch import kernels
from numpywren_tpu_torch.compiler.schedule import ScheduledDAG


class NS(enum.IntEnum):
    """Node state (reference enum NS)."""

    NOT_READY = 0
    READY = 1
    RUNNING = 2
    POST_OP = 3
    FINISHED = 4


class PS(enum.IntEnum):
    """Program state (reference enum PS)."""

    NOT_STARTED = 0
    RUNNING = 1
    SUCCESS = 2
    EXCEPTION = 3


class TiledProgram:
    """A bound program: its schedule (`dag`, built at its first read where
    the bind deferred it), its bindings, and the state machine the dynamic
    executors drive."""

    def __init__(self, dag: ScheduledDAG):
        self.dag = dag
        self.matrices = dag.matrices
        self.consts = dag.consts
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.program_status = PS.NOT_STARTED
        self.exception: Optional[BaseException] = None
        self._node_status: Optional[List[NS]] = None  # made by start() or at first read
        self._dep_count: Optional[List[int]] = None
        self._done = 0
        self.profile: Dict[int, Dict] = {}  # node id -> its record, once it has one
        self.trace_id: Optional[int] = None  # the entry's (metrics.span)

    # ------------------------------------------------------ per-node state
    def _node_state(self) -> List[NS]:
        """The per-node lists, made here where start() did not make them:
        every node FINISHED once the program succeeded, else NOT_READY."""
        if self._node_status is None:
            n = self.dag.num_nodes
            done = self.program_status == PS.SUCCESS
            self._dep_count = [0] * n
            self._done = n if done else 0
            self._node_status = [NS.FINISHED if done else NS.NOT_READY] * n
        return self._node_status

    @property
    def node_status(self) -> List[NS]:
        return self._node_state()

    @property
    def dep_count(self) -> List[int]:
        self._node_state()
        return self._dep_count

    @property
    def _finished_count(self) -> int:
        self._node_state()
        return self._done

    @_finished_count.setter
    def _finished_count(self, value: int):
        self._done = value

    # ------------------------------------------------------------ schedule
    @property
    def num_nodes(self) -> int:
        return self.dag.num_nodes

    @property
    def levels(self) -> List[List[int]]:
        return self.dag.levels

    def get_children(self, node_id: int) -> List[int]:
        """Static-schedule equivalent of the reference's on-demand sympy
        child solve (SURVEY §3.4): precomputed at compile time."""
        return self.dag.children[node_id]

    def get_parents(self, node_id: int) -> List[int]:
        return self.dag.parents[node_id]

    def node(self, node_id: int):
        return self.dag.nodes[node_id]

    def node_flops(self, node_id: int) -> int:
        n = self.dag.nodes[node_id]
        shapes = [self.matrices[r[0]].matrix.tile for r in n.reads]
        return kernels.flop_count(n.op, shapes)

    # ------------------------------------------------------- state machine
    def start(self, done=()) -> List[int]:
        """Initialize counters, mark root nodes READY, return them (the
        reference enqueues these to SQS).

        ``done`` seeds already-completed nodes for a resume (the reference's
        restart path re-scans block_idxs_exist and re-enqueues only the
        frontier — SURVEY §5 checkpoint/resume): those nodes start FINISHED,
        dependency counters exclude them, and the returned roots are the
        resume frontier's ready set."""
        done_set = set(done)
        with self._lock:
            if self.program_status != PS.NOT_STARTED:
                raise RuntimeError("program already started")
            n = self.num_nodes
            status = self._node_status = [NS.NOT_READY] * n
            deps = self._dep_count = [0] * n
            parents = self.dag.parents
            roots = []
            for nid in range(n):
                if nid in done_set:
                    status[nid] = NS.FINISHED
                    continue
                deps[nid] = sum(1 for p in parents[nid] if p not in done_set)
                if deps[nid] == 0:
                    status[nid] = NS.READY
                    roots.append(nid)
            self._done = len(done_set)
            if self._done == n:
                self.program_status = PS.SUCCESS
                self._cv.notify_all()
            else:
                self.program_status = PS.RUNNING
            return roots

    def cas_node_status(self, node_id: int, expect: NS, new: NS) -> bool:
        """Atomic compare-and-swap (reference: Redis transaction). A message
        delivered to two workers loses the race here and is dropped."""
        with self._lock:
            if self.node_status[node_id] != expect:
                return False
            self.node_status[node_id] = new
            if new == NS.RUNNING:
                self.profile.setdefault(node_id, {})["start"] = time.perf_counter()
            return True

    def get_node_status(self, node_id: int) -> NS:
        with self._lock:
            return self.node_status[node_id]

    def set_node_status(self, node_id: int, status: NS):
        with self._lock:
            self.node_status[node_id] = status

    def post_op(self, node_id: int, success: bool = True) -> List[int]:
        """Completion protocol: record profile, decrement children dependency
        counters, return newly-READY children (reference post_op enqueues
        them to SQS, choosing a queue by priority)."""
        with self._cv:
            if self.node_status[node_id] == NS.FINISHED:
                return []  # duplicate completion (at-least-once delivery)
            self.node_status[node_id] = NS.POST_OP
            if not success:
                self.program_status = PS.EXCEPTION
                self._cv.notify_all()
                return []
            newly_ready = []
            for c in self.dag.children[node_id]:
                self.dep_count[c] -= 1
                if self.dep_count[c] == 0:
                    self.node_status[c] = NS.READY
                    newly_ready.append(c)
            self.node_status[node_id] = NS.FINISHED
            p = self.profile.setdefault(node_id, {})
            p["end"] = time.perf_counter()
            p["flops"] = self.node_flops(node_id)
            self._finished_count += 1
            if self._finished_count == self.num_nodes:
                self.program_status = PS.SUCCESS
            self._cv.notify_all()
            return newly_ready

    def wait(self, timeout: Optional[float] = None) -> PS:
        """Block until the program reaches a terminal state (reference wait
        polls program state in Redis)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self.program_status == PS.RUNNING or self.program_status == PS.NOT_STARTED:
                remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
                if deadline is not None and remaining == 0.0:
                    break
                self._cv.wait(remaining if remaining is not None else 1.0)
            return self.program_status

    def free(self):
        """Reset runtime state so the program can run again (reference free
        tears down queues/Redis keys)."""
        with self._lock:
            self.program_status = PS.NOT_STARTED
            self._node_status = self._dep_count = None
            self._done = 0
            self.profile = {}
            self.exception = None

    # ----------------------------------------------------------- reporting
    def profile_summary(self) -> Dict:
        done = [p for p in self.profile.values() if "end" in p]
        total_flops = sum(p.get("flops", 0) for p in done)
        if not done:
            return {"nodes_done": 0}
        t0 = min(p["start"] for p in done if "start" in p)
        t1 = max(p["end"] for p in done)
        wall = max(t1 - t0, 1e-9)
        return {
            "nodes_done": len(done),
            "wall_s": wall,
            "total_flops": total_flops,
            "tflops_per_s": total_flops / wall / 1e12,
        }

    def __repr__(self):
        s = self.dag.stats()
        return (
            f"TiledProgram({self.dag.template.name}, nodes={s['nodes']}, "
            f"levels={s['levels']}, edges={s['edges']}, status={self.program_status.name})"
        )
