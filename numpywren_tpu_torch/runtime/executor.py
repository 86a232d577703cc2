"""Executors: run a compiled TiledProgram (counterpart of
numpywren_tpu/runtime/executor.py).

LocalExecutor: the in-process rebuild of the reference worker loop
(numpywren/job_runner.py :: lambdapack_run): N threads stand in for Lambda
workers, a shared queue for SQS, program CAS transitions for Redis. Delivery
is at least once and writes are idempotent; fault injection (reference:
lambdapack_run_with_failures) kills a fraction of tasks mid-flight to
exercise redelivery, and duplicate delivery the CAS. It runs the numpy
reference kernels on tiles read to numpy.

TorchTaskExecutor: the generic static-schedule executor on the device
(JaxTaskExecutor is the same class under the JAX package's name). Each
matrix becomes a tile stack (n_tiles, Tm, Tn); each schedule group is one
gather -> batched op -> scatter. PyTorch runs eagerly, so there is no
whole-schedule trace: the stack geometry and the gather/scatter plan are
built once per executor and reused by repeated run() calls.

SpillTaskExecutor: the same schedule for host-tier matrices: per group the
input tiles go host -> device, the batched op runs, the outputs come back to
the host tier, with a prefetch thread gathering the next groups' tiles.

The batched ops are library calls, as the reference's are jnp.matmul and
jnp.linalg calls: torch.matmul in true FP32 (TF32 stays off, see
ops/common.py), torch.linalg.cholesky_ex, solve_triangular and batched
torch.linalg.qr. NPW_PALLAS_QR does not reach them, as it does not in the
reference; it steers ops.qr_leaf (TORCH_KERNELS["qr_leaf"]).
"""

from __future__ import annotations

import concurrent.futures
import queue
import random
import threading
from typing import Dict, List, Optional, Tuple

import torch

from numpywren_tpu_torch import kernels
from numpywren_tpu_torch.compiler.schedule import critical_path_priority, grouped_schedule
from numpywren_tpu_torch.config import default_config
from numpywren_tpu_torch.exceptions import TiledProgramExecutionError
from numpywren_tpu_torch.metrics import span
from numpywren_tpu_torch.ops import factor
from numpywren_tpu_torch.ops.common import check_precision, to_numpy
from numpywren_tpu_torch.runtime.program import NS, PS, TiledProgram


# ---------------------------------------------------------------------------
# Shared: execute one node with numpy kernels against TiledMatrix storage
# ---------------------------------------------------------------------------

def _node_args(program: TiledProgram, node):
    args = []
    r_it = iter(node.reads)
    c_it = iter(node.consts)
    for kind in node.input_kinds:
        if kind == "block":
            name, i, j = next(r_it)
            args.append(to_numpy(program.matrices[name].matrix.get_block(i, j)))
        else:
            args.append(next(c_it))
    return args


def execute_node_numpy(program: TiledProgram, node_id: int):
    node = program.node(node_id)
    outs = kernels.KERNELS[node.op](*_node_args(program, node))
    if not isinstance(outs, tuple):
        outs = (outs,)
    wvers = node.write_versions or (None,) * len(node.writes)
    for (name, i, j), out, ver in zip(node.writes, outs, wvers):
        ba = program.matrices[name]
        ba.matrix.put_block(out, i, j)
        ba.note_write((i, j), ver)


# ---------------------------------------------------------------------------
# LocalExecutor: dynamic queue semantics, threads, fault injection
# ---------------------------------------------------------------------------

class LocalExecutor:
    def __init__(self, program: TiledProgram, num_workers: Optional[int] = None,
                 fault_rate: float = 0.0, seed: int = 0, duplicate_rate: float = 0.0,
                 prioritize: bool = True):
        self.program = program
        self.num_workers = num_workers if num_workers is not None else default_config().max_workers
        self.fault_rate = fault_rate
        self.duplicate_rate = duplicate_rate
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        # critical-path priority queue (the reference's SQS queues as
        # priority levels, upstream:numpywren/lambdapack.py post_op): the
        # next panel's factor and solve nodes jump ahead of bulk trailing
        # updates. prioritize=False keeps plain FIFO.
        self._prio = critical_path_priority(program.dag) if prioritize else None
        self._q: "queue.Queue" = queue.PriorityQueue() if prioritize else queue.Queue()
        self._error: Optional[BaseException] = None
        self.execution_order: List[int] = []  # completed node ids, in order

    def _rand(self) -> float:
        with self._rng_lock:
            return self._rng.random()

    def _entry(self, nid: int):
        return (-self._prio[nid], nid) if self._prio is not None else nid

    def _put(self, nid: int):
        self._q.put(self._entry(nid))
        if self._rand() < self.duplicate_rate:  # at-least-once: a duplicate message
            self._q.put(self._entry(nid))

    def run(self, timeout: Optional[float] = None, resume: bool = False) -> PS:
        """resume=True re-scans the output blocks (the reference's
        block_idxs_exist restart path) and enqueues only the frontier."""
        if resume:
            from numpywren_tpu_torch.checkpoint import program_frontier

            roots = self.program.start(done=program_frontier(self.program)["done"])
            if self.program.program_status == PS.SUCCESS:
                return PS.SUCCESS
        else:
            roots = self.program.start()
        for nid in roots:
            self._put(nid)
        workers = [threading.Thread(target=self._worker_loop, name=f"npw-worker-{w}", daemon=True)
                   for w in range(self.num_workers)]
        for w in workers:
            w.start()
        status = self.program.wait(timeout=timeout)
        for w in workers:
            w.join(timeout=5.0)
        if self._error is not None and status != PS.SUCCESS:
            raise TiledProgramExecutionError("<worker>", self._error)
        return status

    def _worker_loop(self):
        """The reference hot loop: dequeue -> CAS READY->RUNNING -> read
        blocks -> kernel -> write blocks -> post_op -> enqueue children.
        Losing the CAS race (duplicate delivery) drops the message."""
        program = self.program
        while program.program_status == PS.RUNNING:
            try:
                entry = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            nid = entry[1] if self._prio is not None else entry
            if not program.cas_node_status(nid, NS.READY, NS.RUNNING):
                continue  # another worker won the race
            try:
                # fault injection: the worker "dies" mid-task; the node goes
                # back to READY and the message is redelivered (the stand-in
                # for an SQS visibility-timeout expiry)
                if self._rand() < self.fault_rate:
                    program.set_node_status(nid, NS.READY)
                    self._q.put(self._entry(nid))
                    continue
                execute_node_numpy(program, nid)
            except BaseException as e:  # noqa: BLE001 - the worker must report
                self._error = e
                program.post_op(nid, success=False)
                return
            children = program.post_op(nid)
            self.execution_order.append(nid)
            for child in children:
                self._put(child)


# ---------------------------------------------------------------------------
# The batched ops of the static-schedule executors
# ---------------------------------------------------------------------------

def _batched_kernels(trsm_inv: bool = True):
    def mm(a, b, ta=False, tb=False):
        return torch.matmul(a.mT if ta else a, b.mT if tb else b)

    def trsm(a, l):
        # solve X Lᵀ = A (right side, lower L). trsm_inv: one small inverse
        # and one batched GEMM, X = A L⁻ᵀ, the reference's default
        # (its batched triangular_solve ran sequentially per batch element)
        if trsm_inv:
            eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
            return mm(a, torch.linalg.solve_triangular(l, eye, upper=False), tb=True)
        if l.dim() < a.dim():  # a broadcast-read pivot tile
            l = l.expand(a.shape[:-2] + l.shape[-2:])
        return torch.linalg.solve_triangular(l.mT, a, upper=True, left=False)

    def qr_combine(rt, rb):
        n = rt.shape[-2]
        q, r = torch.linalg.qr(torch.cat([rt, rb], dim=-2), mode="reduced")
        return q[..., :n, :], q[..., n:, :], r

    def lq_leaf(a):
        q, r = torch.linalg.qr(a.mT, mode="reduced")
        return r.mT, q.mT

    def identity(a):
        eye = torch.eye(a.shape[-2], a.shape[-1], dtype=a.dtype, device=a.device)
        return eye.expand(a.shape)

    def qr_combine_r(*rs):
        return torch.linalg.qr(torch.cat(rs, dim=-2), mode="r")[1]

    return {
        **{f"qr_combine_r{m}": qr_combine_r for m in range(2, kernels.MAX_REDUCER_ARITY + 1)},
        "potrf": factor.potrf,
        "trsm": trsm,
        "syrk": lambda s, x, y: s - mm(x, y, tb=True),
        "gemm": mm,
        "gemm_nt": lambda a, b: mm(a, b, tb=True),
        "gemm_tn": lambda a, b: mm(a, b, ta=True),
        "gemm_acc": lambda c, a, b: c + mm(a, b),
        "add": lambda a, b: a + b,
        "sub": lambda a, b: a - b,
        "identity": identity,
        "copy": lambda a: a,
        "transpose": lambda a: a.mT,
        "qr_leaf": lambda a: torch.linalg.qr(a, mode="reduced"),
        "qr_combine": qr_combine,
        "qr_r": lambda a: torch.linalg.qr(a, mode="r")[1],
        "lq_leaf": lq_leaf,
        "small_qr_apply": lambda q, a: mm(q, a, ta=True),
        # batched-safe full-Q pairwise ops
        "qr_factor2": factor.qr_factor2,
        "qr_apply2": factor.qr_apply2,
        "lq_factor2": factor.lq_factor2,
        "lq_apply2": factor.lq_apply2,
    }


# ops whose batched entry broadcasts an UNBATCHED (Tm, Tn) operand against
# batched (k, Tm, Tn) ones; any other op gets the operand expanded
_BCAST_SAFE_OPS = frozenset({
    "trsm", "syrk", "gemm", "gemm_nt", "gemm_tn", "gemm_acc",
    "add", "sub", "copy", "transpose", "small_qr_apply",
})


def _runs(lin: List[int]) -> Optional[List[Tuple[int, int]]]:
    """Contiguous ascending runs [(start_pos, end_pos), ...] of a strictly
    ascending index list, or None when it is not strictly ascending or has
    too many runs for slices to beat one index_select."""
    if any(a >= b for a, b in zip(lin, lin[1:])):
        return None
    runs, s = [], 0
    for t in range(1, len(lin) + 1):
        if t == len(lin) or lin[t] != lin[t - 1] + 1:
            runs.append((s, t))
            s = t
    return runs if len(runs) <= max(16, len(lin) // 4) else None


def _group_inputs(group, consts):
    """Per input of the group's statement: ("const", value) or ("block",
    matrix name, [the members' read addresses])."""
    specs, c_pos, b_pos = [], 0, 0
    for kind in group[0].input_kinds:
        if kind == "const":
            specs.append(("const", consts[c_pos]))
            c_pos += 1
        else:
            specs.append(("block", group[0].reads[b_pos][0], [n.reads[b_pos] for n in group]))
            b_pos += 1
    return specs


class TorchTaskExecutor:
    """Run the grouped schedule on the device: tile stacks, one gather ->
    batched op -> scatter per group. Works for any DSL program (the
    "generic" lowering). Host-tier matrices are copied to the device tier
    for the run and their computed blocks written back after it.

    precision ("default", "high", "highest" or None for the tiles' dtype
    default) is checked and kept, as the reference takes it; no batched op
    has a product it changes: every one is a batched torch.matmul or
    torch.linalg call on (k, Tm, Tn) stacks, true FP32 on fp32 tiles, and
    the port's compensated product (ops.gemm3) takes 2-D operands only.
    donate is accepted for the reference's signature and does nothing:
    PyTorch has no buffer donation (the run writes its stacks in place).

    groups_run counts the groups of the last run()."""

    def __init__(self, program: TiledProgram, precision: Optional[str] = None,
                 donate: bool = True, schedule_policy: str = "wavefront",
                 trsm_inv: bool = True):
        self.program = program
        self.precision = None if precision is None else check_precision(precision)
        self.donate = donate
        # "lookahead" emits the next panel's critical-path groups before bulk
        # trailing updates (compiler.schedule.grouped_schedule)
        self.schedule_policy = schedule_policy
        self.trsm_inv = trsm_inv
        self.groups_run = 0
        self._plan = None

    def run(self) -> PS:
        program = self.program
        originals = {name: ba.matrix for name, ba in program.matrices.items()}
        for ba in program.matrices.values():
            if ba.matrix.storage != "hbm":
                ba.matrix = ba.matrix.to_hbm()
        for name, i, j in sorted(program.dag.initial_reads):
            m = program.matrices[name].matrix
            if not m.block_exists(i, j):
                m.get_block(i, j)  # a parent_fn fallback stages into the array
        self._build()
        kers, plan, geom, written = self._plan
        stacks = {}
        for name, ((gm, gn), (tm, tn), _) in geom.items():
            arr = program.matrices[name].matrix.array
            stacks[name] = arr.reshape(gm, tm, gn, tn).permute(0, 2, 1, 3).reshape(gm * gn, tm, tn)
        self.groups_run = 0
        for op, ins, outs, k in plan:
            args = [spec[1] if spec[0] == "const" else _gather(stacks[spec[1]], spec) for spec in ins]
            res = kers[op](*args)
            if not isinstance(res, tuple):
                res = (res,)
            for (name, dst), out in zip(outs, res):
                st = stacks[name]
                if out.dim() == 2:  # every input was an unbatched broadcast read
                    out = out.expand((k,) + tuple(out.shape))
                out = out.to(st.dtype)
                if out.untyped_storage().data_ptr() == st.untyped_storage().data_ptr():
                    out = out.clone()  # an op that returned its input (copy)
                if isinstance(dst, list):
                    for s0, s1, t0 in dst:
                        st[t0:t0 + s1 - s0].copy_(out[s0:s1])
                else:
                    st.index_copy_(0, dst, out)
            self.groups_run += 1
        for name in written:
            (gm, gn), (tm, tn), (pm, pn) = geom[name]
            m = program.matrices[name].matrix
            m.replace_array(stacks[name].reshape(gm, gn, tm, tn).permute(0, 2, 1, 3).reshape(pm, pn))
        for name, orig in originals.items():
            cur = program.matrices[name].matrix
            if cur is not orig:
                if name in written:
                    for (i, j) in cur.block_idxs_exist:
                        orig.put_block(cur.get_block(i, j), i, j)
                program.matrices[name].matrix = orig
        _mark_success(program)
        return PS.SUCCESS

    def _build(self):
        """The geometry and the per-group gather/scatter plan, built once
        and reused by later run() calls."""
        if self._plan is not None:
            return
        program = self.program
        mats = {name: ba.matrix for name, ba in program.matrices.items()}
        geom = {name: (m.grid, m.tile, m.padded_shape) for name, m in mats.items()}
        dev = next(iter(mats.values())).device
        nodes = program.dag.nodes
        plan = []
        written = set()
        for _sid, consts, members in grouped_schedule(program.dag, self.schedule_policy):
            group = [nodes[nid] for nid in members]
            # members in the order of their first write's linear tile: sorted
            # unique scatter indices, mostly contiguous runs
            gw = geom[group[0].writes[0][0]][0][1]
            group.sort(key=lambda n: n.writes[0][1] * gw + n.writes[0][2])
            op = group[0].op
            ins = []
            for spec in _group_inputs(group, consts):
                if spec[0] == "const":
                    ins.append(spec)
                    continue
                _, name, addrs = spec
                gn = geom[name][0][1]
                lin = [i * gn + j for _, i, j in addrs]
                if len(lin) > 1 and len(set(lin)) == 1:
                    # a broadcast read (every trsm of a panel reads its pivot)
                    ins.append(("bcast", name, lin[0], op in _BCAST_SAFE_OPS, len(lin)))
                    continue
                runs = _runs(lin)
                if runs is not None:
                    ins.append(("runs", name, [(lin[s0], lin[s1 - 1] + 1) for s0, s1 in runs]))
                else:
                    ins.append(("index", name, torch.tensor(lin, dtype=torch.long, device=dev)))
            outs = []
            for w_pos in range(len(group[0].writes)):
                name = group[0].writes[w_pos][0]
                gn = geom[name][0][1]
                lin = [n.writes[w_pos][1] * gn + n.writes[w_pos][2] for n in group]
                # same-tile writes inside one group would be a data race the
                # scheduler must never emit
                assert len(set(lin)) == len(lin), f"duplicate write tiles in group: {lin}"
                runs = _runs(lin)
                if runs is not None:
                    outs.append((name, [(s0, s1, lin[s0]) for s0, s1 in runs]))
                else:
                    outs.append((name, torch.tensor(lin, dtype=torch.long, device=dev)))
                written.add(name)
            plan.append((op, ins, outs, len(group)))
        self._plan = (_batched_kernels(self.trsm_inv), plan, geom, written)


JaxTaskExecutor = TorchTaskExecutor  # the JAX package's name, for callers


def _gather(st: torch.Tensor, spec) -> torch.Tensor:
    kind = spec[0]
    if kind == "bcast":
        _, _, t, safe, k = spec
        return st[t] if safe else st[t].expand((k,) + tuple(st.shape[1:]))
    if kind == "runs":
        parts = [st[a:b] for a, b in spec[2]]
        return parts[0] if len(parts) == 1 else torch.cat(parts)
    return st.index_select(0, spec[2])


class SpillTaskExecutor:
    """The static schedule for HOST-RESIDENT matrices: per group, the input
    tiles go host -> device, the batched op runs there, the outputs are
    scattered back to the host tier. The working set never has to fit on
    the card: the arbitrary-program analog of the reference worker loop
    (read blocks -> kernel -> write blocks, job_runner.py) with the card as
    the worker. The device is the matrices' (the host tier names it).

    Pipelining (reference job_runner.py pipeline_width): a prefetch thread
    gathers upcoming groups' input tiles, those whose writer group has
    already scattered, while the current group computes; the rest are
    gathered at group start ("late" tiles). With the default lookahead
    policy the next panel's factor nodes come before bulk trailing updates,
    so their I/O hides under the big GEMMs.

    on_event(kind, group_idx) test/trace hook, kinds: prefetch_issue /
    prefetch_done / compute / scatter. h2d_bytes / d2h_bytes count the
    last run's copies to and from the device.

    precision is checked and kept as TorchTaskExecutor keeps it: the same
    batched ops, with no product it changes."""

    def __init__(self, program: TiledProgram, precision: Optional[str] = None,
                 schedule_policy: str = "lookahead",
                 pipeline_width: Optional[int] = None, on_event=None):
        self.program = program
        self.precision = None if precision is None else check_precision(precision)
        self.schedule_policy = schedule_policy
        self.pipeline_width = int(pipeline_width if pipeline_width is not None
                                  else default_config().pipeline_width)
        self.on_event = on_event or (lambda kind, g: None)
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    def run(self, resume: bool = False) -> PS:
        program = self.program
        dev = next(iter(program.matrices.values())).matrix.device
        pin = dev.type == "cuda"
        kers = _batched_kernels()
        nodes = program.dag.nodes
        event = self.on_event
        self.h2d_bytes = self.d2h_bytes = 0

        done = set()
        if resume:
            from numpywren_tpu_torch.checkpoint import program_frontier

            done = set(program_frontier(program)["done"])
            program.start(done=sorted(done))
            if program.program_status == PS.SUCCESS:
                return PS.SUCCESS
        else:
            program.start()

        # the live schedule (a resume drops completed nodes: their outputs
        # are on the host tier, so their reads resolve as initial tiles)
        sched = []
        for _sid, consts, members in grouped_schedule(program.dag, self.schedule_policy):
            live = [nid for nid in members if nid not in done]
            if live:
                sched.append((consts, [nodes[nid] for nid in live], live))

        # (addr, version) -> index of the LIVE group that writes it; reads of
        # addresses with no live writer come from tiles already on the host
        writer_of: Dict[Tuple, int] = {}
        for g, (_consts, group, _ids) in enumerate(sched):
            for n in group:
                for a, v in zip(n.writes, n.write_versions or (None,) * len(n.writes)):
                    writer_of[(a, v)] = g

        def read_addr(n, b_pos):
            rvers = n.read_versions or (None,) * len(n.reads)
            return n.reads[b_pos], rvers[b_pos]

        def gather(g: int, tiles, late: bool, wmax: int):
            """Group g's input tiles whose writer group is <= wmax (already
            scattered), or > wmax when late. Safe against in-place version
            reuse: the schedule's WAR edges place the writer of (addr, v+1)
            after every reader of (addr, v)."""
            group = sched[g][1]
            for b_pos in range(len(group[0].reads)):
                for k, n in enumerate(group):
                    a, v = read_addr(n, b_pos)
                    if (writer_of.get((a, v), -1) > wmax) == late:
                        name, bi, bj = a
                        tiles[(b_pos, k)] = program.matrices[name].matrix.get_block(bi, bj)
            return tiles

        depth = max(0, self.pipeline_width - 1)
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1) if depth else None
        futures: Dict[int, Tuple[int, "concurrent.futures.Future"]] = {}

        def fetch(h: int, wmax: int):
            tiles = gather(h, {}, False, wmax)
            event("prefetch_done", h)  # fires in the prefetch thread
            return tiles

        try:
            for g, (consts, group, ids) in enumerate(sched):
                if pool is not None:
                    # prefetch upcoming groups while THIS one computes;
                    # everything scattered so far has writer <= g - 1
                    for h in range(g + 1, min(g + depth, len(sched) - 1) + 1):
                        if h not in futures:
                            event("prefetch_issue", h)
                            futures[h] = (g - 1, pool.submit(fetch, h, g - 1))
                pre = futures.pop(g, None)
                if pre is not None:
                    wmax, tiles = pre[0], pre[1].result()
                else:
                    wmax, tiles = -(len(sched) + 1), {}
                # late tiles: written after the prefetch was issued (all
                # writers of g's reads are < g, hence scattered by now)
                gather(g, tiles, True, wmax)
                ins, c_pos = [], 0
                for pos, kind in enumerate(group[0].input_kinds):
                    if kind == "const":
                        ins.append(consts[c_pos])
                        c_pos += 1
                        continue
                    b_pos = sum(1 for kk in group[0].input_kinds[:pos] if kk == "block")
                    blk = [tiles[(b_pos, k)] for k in range(len(group))]
                    host = torch.empty((len(blk),) + tuple(blk[0].shape), dtype=blk[0].dtype,
                                       pin_memory=pin)
                    torch.stack([b.to("cpu") for b in blk], out=host)
                    self.h2d_bytes += host.numel() * host.element_size()
                    ins.append(host.to(dev, non_blocking=True))
                event("compute", g)
                outs = kers[group[0].op](*ins)
                if not isinstance(outs, tuple):
                    outs = (outs,)
                event("scatter", g)
                for w_pos, out in enumerate(outs):
                    if out.dim() == 2:
                        out = out.expand((len(group),) + tuple(out.shape))
                    host = out.to("cpu")
                    self.d2h_bytes += host.numel() * host.element_size()
                    for i, n in enumerate(group):
                        name, bi, bj = n.writes[w_pos]
                        ba = program.matrices[name]
                        ba.matrix.put_block(host[i], bi, bj)
                        if n.write_versions:
                            ba.note_write((bi, bj), n.write_versions[w_pos])
                for nid in ids:
                    program.node_status[nid] = NS.FINISHED
                    program._finished_count += 1
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
        program.program_status = PS.SUCCESS
        return PS.SUCCESS


def _mark_success(program: TiledProgram):
    """Fused lowerings and the static executor complete atomically: the
    program's status becomes SUCCESS, and its per-node state, made at its
    first read, reads every node FINISHED, so wait()/get_node_status keep
    working. Reads neither the schedule nor its node count."""
    with program._lock:
        if program.program_status == PS.SUCCESS:
            return
        if program.program_status != PS.NOT_STARTED:
            raise RuntimeError("program already started")
        program._node_status = program._dep_count = None
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
      - "fused": the region-fused lowering (compiler.lower): cholesky, gemm,
        the tsqr family and bdfac; another program raises ValueError.
      - "jax": the generic static schedule on the device (TorchTaskExecutor,
        any program).
      - "local": the dynamic threaded numpy runtime (LocalExecutor).
      - "spill": the static schedule over host-tier tiles (SpillTaskExecutor).
      - "auto": fused when the program has a fused lowering, else "jax".

    resume=True (local and spill) restarts a half-run program from the
    block-existence frontier instead of node 0, the reference's implicit
    checkpoint/resume (scan block_idxs_exist, re-enqueue the frontier).

    The whole call is the `run` span (metrics.span) of the program's trace.
    """
    with span("run", trace=getattr(program, "trace_id", None)):
        if resume and executor in ("local", "spill"):
            if executor == "local":
                return LocalExecutor(program, num_workers=num_workers, **kw).run(resume=True)
            return SpillTaskExecutor(program, **kw).run(resume=True)
        if executor in ("auto", "fused"):
            from numpywren_tpu_torch.compiler.lower import lower_fused

            fn = lower_fused(program)
            if fn is not None:
                fn()  # commits and marks the program's success
                return PS.SUCCESS
            name = program.dag.template.name
            if executor == "fused":
                raise ValueError(f"no fused lowering for program {name!r}")
            executor = "jax"
        if executor == "jax":
            return TorchTaskExecutor(program, **kw).run()
        if executor == "spill":
            return SpillTaskExecutor(program, **kw).run()
        if executor == "local":
            return LocalExecutor(program, num_workers=num_workers, **kw).run()
        raise ValueError(f"unknown executor {executor!r}")
