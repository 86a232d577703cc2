"""Drive the C++ schedule core and rebuild a ScheduledDAG from its tables."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from numpywren_tpu_torch.exceptions import CompilationError
from numpywren_tpu_torch.native import load
from numpywren_tpu_torch.native.serialize import NativeUnsupported, OP_NAMES, serialize


def _arr(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.int64))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def compile_native(dag) -> Optional[bool]:
    """Fill `dag` (a ScheduledDAG with template/matrices/consts set) using
    the native core. Returns True on success, None when the native path is
    unavailable (caller falls back to Python), raises CompilationError for
    real program errors."""
    lib = load()
    if lib is None:
        return None
    try:
        enc, prog, versioned, init_vars, matrix_order = serialize(
            dag.template, dag.matrices, dag.consts
        )
    except NativeUnsupported:
        return None

    code = _arr([v for pair in enc.code for v in pair])
    off = _arr(enc.offsets)
    length = _arr(enc.lengths)
    prog_a = _arr(prog)
    vers_a = _arr(versioned)
    vars_a = _arr(init_vars)

    h = lib.npw_build(
        _ptr(code), len(enc.code), _ptr(off), _ptr(length), len(off),
        _ptr(prog_a), len(prog_a), _ptr(vers_a), len(vers_a),
        _ptr(vars_a), len(vars_a),
    )
    if h <= 0:
        buf = ctypes.create_string_buffer(4096)
        lib.npw_error(h, buf, 4096)
        lib.npw_free(h)
        msg = buf.value.decode()
        if msg.startswith("unsupported:"):
            return None  # e.g. address outside packable range: Python handles it
        raise CompilationError(f"native schedule core: {msg}")

    try:
        n = lib.npw_num_nodes(h)
        sizes = _arr(np.zeros(5))
        lib.npw_sizes(h, _ptr(sizes))
        n_vv, n_rd, n_wr, n_cn, n_ed = (int(x) for x in sizes)

        stmt = np.zeros(n, np.int64)
        op = np.zeros(n, np.int64)
        vv_off = np.zeros(n + 1, np.int64)
        vv = np.zeros(max(1, n_vv), np.int64)
        rd_off = np.zeros(n + 1, np.int64)
        rd = np.zeros(max(1, 4 * n_rd), np.int64)
        wr_off = np.zeros(n + 1, np.int64)
        wr = np.zeros(max(1, 4 * n_wr), np.int64)
        cn_off = np.zeros(n + 1, np.int64)
        cn = np.zeros(max(1, n_cn), np.int64)
        lib.npw_nodes(h, _ptr(stmt), _ptr(op), _ptr(vv_off), _ptr(vv),
                      _ptr(rd_off), _ptr(rd), _ptr(wr_off), _ptr(wr),
                      _ptr(cn_off), _ptr(cn))

        par_off = np.zeros(n + 1, np.int64)
        par = np.zeros(max(1, n_ed), np.int64)
        level_of = np.zeros(n, np.int64)
        lib.npw_edges(h, _ptr(par_off), _ptr(par), _ptr(level_of))

        n_init = lib.npw_num_initial_reads(h)
        init = np.zeros(max(1, 3 * n_init), np.int64)
        lib.npw_initial_reads(h, _ptr(init))
    finally:
        lib.npw_free(h)

    # Stash the raw tables; Node objects / edge lists materialize at first
    # access (ScheduledDAG's views).
    names = matrix_order
    dag._native = {
        "n": int(n),
        "stmt": stmt, "op": op,
        "vv": vv, "vv_off": vv_off,
        "rd": rd, "rd_off": rd_off,
        "wr": wr, "wr_off": wr_off,
        "cn": cn, "cn_off": cn_off,
        "par": par, "par_off": par_off,
        "level_of": level_of,
        "names": names,
    }
    init_l = init.tolist()
    dag._initial_reads = {
        (names[init_l[3 * i]], init_l[3 * i + 1], init_l[3 * i + 2])
        for i in range(n_init)
    }
    return True


def materialize_nodes(dag):
    """Build the Python Node list from the native tables (hot for big grids:
    work on plain lists — numpy scalar indexing per element is ~10x slower)."""
    from numpywren_tpu_torch.compiler.schedule import Node
    from numpywren_tpu_torch.frontend.ir import ConstRef

    nat = dag._native
    if nat is None:
        raise RuntimeError("no native tables and no Python enumeration ran")
    names = nat["names"]
    n = nat["n"]
    kinds_of = {
        s.stmt_id: tuple(
            "const" if isinstance(inp, ConstRef) else "block" for inp in s.inputs
        )
        for s in dag.template.statements
    }
    stmt_l = nat["stmt"].tolist()
    op_l = nat["op"].tolist()
    vv_l, vv_off_l = nat["vv"].tolist(), nat["vv_off"].tolist()
    rd_l, rd_off_l = nat["rd"].tolist(), nat["rd_off"].tolist()
    wr_l, wr_off_l = nat["wr"].tolist(), nat["wr_off"].tolist()
    cn_l, cn_off_l = nat["cn"].tolist(), nat["cn_off"].tolist()

    def addrs(flat, lo, hi):
        out_a, out_v = [], []
        for k in range(4 * lo, 4 * hi, 4):
            out_a.append((names[flat[k]], flat[k + 1], flat[k + 2]))
            v = flat[k + 3]
            out_v.append(v if v >= 0 else None)
        return tuple(out_a), tuple(out_v)

    nodes = []
    append = nodes.append
    for i in range(n):
        reads, rvers = addrs(rd_l, rd_off_l[i], rd_off_l[i + 1])
        writes, wvers = addrs(wr_l, wr_off_l[i], wr_off_l[i + 1])
        append(Node(
            node_id=i,
            stmt_id=stmt_l[i],
            op=OP_NAMES[op_l[i]],
            var_values=tuple(vv_l[vv_off_l[i]:vv_off_l[i + 1]]),
            reads=reads,
            writes=writes,
            consts=tuple(cn_l[cn_off_l[i]:cn_off_l[i + 1]]),
            input_kinds=kinds_of[stmt_l[i]],
            read_versions=rvers,
            write_versions=wvers,
        ))
    return nodes


def materialize_edges(dag):
    """The edge lists and levels from the native tables; `_parents` is set
    last, so a reader that sees it sees the rest."""
    nat = dag._native
    if nat is None:
        raise RuntimeError("no native tables and no Python enumeration ran")
    n = nat["n"]
    par_l, par_off_l = nat["par"].tolist(), nat["par_off"].tolist()
    parents = [par_l[par_off_l[i]:par_off_l[i + 1]] for i in range(n)]
    children = [[] for _ in range(n)]
    for nid, ps in enumerate(parents):
        for p in ps:
            children[p].append(nid)
    node_level = nat["level_of"].tolist()
    n_levels = (max(node_level) + 1) if n else 0
    levels = [[] for _ in range(n_levels)]
    for nid, lv in enumerate(node_level):
        levels[lv].append(nid)
    dag._children, dag._node_level, dag._levels = children, node_level, levels
    dag._parents = parents
