"""Reference tile kernels: numpy-in / numpy-out (analog of numpywren/kernels.py).

The reference's kernels wrap scipy/LAPACK (cholesky, trsm, syrk-via-gemm,
gemm, qr_factor, lq_factor, identity, add). These definitions serve three
roles in the rebuild:

1. semantic ground truth that the Pallas/MXU kernels in numpywren_tpu_torch.ops
   must match (per-kernel tile tests),
2. the compute path of the LocalExecutor (in-process, threaded — the
   parity analog of running job_runner in-process, see SURVEY §4.3),
3. the fp64 shadow path for residual checks.

Conventions (used consistently by the DSL algorithms in algs.py):
- `potrf(a)`              -> L, lower Cholesky factor of SPD tile a.
- `trsm(a, l)`            -> X with X @ L^T = A  (right-solve against the
                             transposed lower factor — the Cholesky panel op).
- `syrk(s, x, y)`         -> s - x @ y^T  (trailing-update accumulate-out).
- `gemm(a, b)`            -> a @ b.
- `gemm_nt(a, b)`         -> a @ b^T ;  `gemm_tn(a, b)` -> a^T @ b.
- `add/sub(a, b)`, `identity(a)`, `copy(a)`.
- `qr_leaf(a)`            -> (Q, R) thin QR of a tile (TSQR leaf).
- `qr_combine(r_top, r_bot)` -> (Q, R) QR of the stacked [R_top; R_bot]
                             (TSQR tree node; the reference expresses this
                             through the `reducer` construct).
- `lq_leaf(a)`            -> (L, Q) thin LQ (BDFAC's row sweep).
- `small_qr_apply(q, a)`  -> q^T @ a (applying a combine Q to stacked data).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


# --------------------------------------------------------------------------
# Cholesky family
# --------------------------------------------------------------------------

def potrf(a: np.ndarray) -> np.ndarray:
    """Lower Cholesky factor of an SPD tile (LAPACK potrf)."""
    return np.linalg.cholesky(np.asarray(a, dtype=np.float64)).astype(a.dtype)


def trsm(a: np.ndarray, l: np.ndarray) -> np.ndarray:
    """Solve X @ L^T = A for X (panel op of right-looking Cholesky)."""
    a64 = np.asarray(a, dtype=np.float64)
    l64 = np.asarray(l, dtype=np.float64)
    # X L^T = A  <=>  L X^T = A^T
    xt = scipy.linalg.solve_triangular(l64, a64.T, lower=True)
    return xt.T.astype(a.dtype)


def syrk(s: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Trailing update: s - x @ y^T (reference kernels.syrk, gemm-shaped)."""
    out = np.asarray(s, dtype=np.float64) - np.asarray(x, np.float64) @ np.asarray(y, np.float64).T
    return out.astype(s.dtype)


# --------------------------------------------------------------------------
# GEMM family
# --------------------------------------------------------------------------

def gemm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (np.asarray(a, np.float64) @ np.asarray(b, np.float64)).astype(a.dtype)


def gemm_nt(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (np.asarray(a, np.float64) @ np.asarray(b, np.float64).T).astype(a.dtype)


def gemm_tn(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (np.asarray(a, np.float64).T @ np.asarray(b, np.float64)).astype(a.dtype)


def gemm_acc(c: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """c + a @ b — the accumulating inner statement of blocked GEMM."""
    out = np.asarray(c, np.float64) + np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    return out.astype(c.dtype)


# --------------------------------------------------------------------------
# Elementwise / structural
# --------------------------------------------------------------------------

def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (np.asarray(a, np.float64) + np.asarray(b, np.float64)).astype(a.dtype)


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (np.asarray(a, np.float64) - np.asarray(b, np.float64)).astype(a.dtype)


def identity(a: np.ndarray) -> np.ndarray:
    """Identity tile with a's shape/dtype (reference kernels.identity)."""
    out = np.zeros_like(np.asarray(a))
    np.fill_diagonal(out, 1.0)
    return out


def copy(a: np.ndarray) -> np.ndarray:
    return np.array(a, copy=True)


def transpose(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).T)


# --------------------------------------------------------------------------
# QR family (TSQR / BDFAC)
# --------------------------------------------------------------------------

def qr_leaf(a: np.ndarray):
    """Thin QR of a (tall) tile: a = Q R, Q: (m,n), R: (n,n)."""
    q, r = np.linalg.qr(np.asarray(a, np.float64))
    return q.astype(a.dtype), r.astype(a.dtype)


def qr_combine(r_top: np.ndarray, r_bot: np.ndarray):
    """QR of the stacked pair [R_top; R_bot] (TSQR tree-node kernel).
    Returns (Q_top, Q_bot, R), the two n x n halves of the combine Q split so
    the DSL's Q-reconstruction sweep can address them as plain tiles."""
    n = r_top.shape[0]
    stacked = np.vstack([np.asarray(r_top, np.float64), np.asarray(r_bot, np.float64)])
    q, r = np.linalg.qr(stacked)
    return (
        q[:n].astype(r_top.dtype),
        q[n:].astype(r_top.dtype),
        r.astype(r_top.dtype),
    )


def qr_r(a: np.ndarray) -> np.ndarray:
    """R factor only (used where Q is not needed)."""
    return np.linalg.qr(np.asarray(a, np.float64), mode="r").astype(a.dtype)


def lq_leaf(a: np.ndarray):
    """Thin LQ of a (wide) tile: a = L Q. Returns (L, Q)."""
    q, r = np.linalg.qr(np.asarray(a, np.float64).T)
    return r.T.astype(a.dtype), q.T.astype(a.dtype)


def small_qr_apply(q: np.ndarray, a: np.ndarray) -> np.ndarray:
    """q^T @ a — apply a combine/leaf Q to stacked data."""
    return (np.asarray(q, np.float64).T @ np.asarray(a, np.float64)).astype(a.dtype)


# --------------------------------------------------------------------------
# k-ary combine family (the `reducer` construct's b_fac > 2 tree nodes —
# reference parity: numpywren's reducer takes a branching factor and its
# combine kernel stacks all children; SURVEY §2 L5. One registered kernel
# per arity so the DSL's fixed-arity statements stay static.)
# --------------------------------------------------------------------------

def _make_qr_combine_r(m: int):
    def f(*rs):
        stacked = np.vstack([np.asarray(r, np.float64) for r in rs])
        return np.linalg.qr(stacked, mode="r").astype(rs[0].dtype)

    f.__name__ = f"qr_combine_r{m}"
    f.__doc__ = (
        f"R factor of the QR of {m} stacked b x b R tiles "
        f"(k-ary TSQR tree node, R-only path)."
    )
    return f


MAX_REDUCER_ARITY = 8
_QR_COMBINE_R = {m: _make_qr_combine_r(m) for m in range(2, MAX_REDUCER_ARITY + 1)}


# --------------------------------------------------------------------------
# Full-Q pairwise kernels (BDFAC block bidiagonalization; the reference's
# bdfac sweeps alternate panel QR and LQ — numpywren/algs.py bdfac,
# kernels.qr_factor/lq_factor. We use the flat-tree form: absorb one tile
# into a running accumulator per step, keeping the FULL 2T x 2T orthogonal
# factor as four T x T blocks so trailing tiles update by plain gemms.)
# --------------------------------------------------------------------------

def qr_factor2(top: np.ndarray, bot: np.ndarray):
    """Complete QR of the stacked pair [top; bot] (2T x T).

    Returns (qtt, qtb, qbt, qbb, r): the four T x T blocks of the full
    orthogonal Q (2T x 2T) and the T x T upper-triangular R, so that
    [top; bot] = Q @ [r; 0]."""
    t = top.shape[0]
    stacked = np.vstack([np.asarray(top, np.float64), np.asarray(bot, np.float64)])
    q, r = np.linalg.qr(stacked, mode="complete")
    dt = top.dtype
    return (
        q[:t, :t].astype(dt), q[:t, t:].astype(dt),
        q[t:, :t].astype(dt), q[t:, t:].astype(dt),
        r[:t].astype(dt),
    )


def qr_apply2(qtt, qtb, qbt, qbb, yt, yb):
    """Apply Q^T (from qr_factor2) to the stacked pair [yt; yb]:
    returns (yt', yb') = Q^T [yt; yb] blockwise."""
    qtt, qtb, qbt, qbb = (np.asarray(x, np.float64) for x in (qtt, qtb, qbt, qbb))
    yt64, yb64 = np.asarray(yt, np.float64), np.asarray(yb, np.float64)
    new_t = qtt.T @ yt64 + qbt.T @ yb64
    new_b = qtb.T @ yt64 + qbb.T @ yb64
    return new_t.astype(yt.dtype), new_b.astype(yb.dtype)


def lq_factor2(left: np.ndarray, right: np.ndarray):
    """Complete LQ of the side-by-side pair [left right] (T x 2T).

    Returns (qtt, qtb, qbt, qbb, l): blocks of the full orthogonal Q
    (2T x 2T) and lower-triangular L with [left right] = [l 0] @ Q."""
    t = left.shape[0]
    a_t = np.hstack([np.asarray(left, np.float64), np.asarray(right, np.float64)]).T
    qc, rc = np.linalg.qr(a_t, mode="complete")  # A^T = Qc Rc => A = Rc^T Qc^T
    q = qc.T  # (2T x 2T), A = [L 0] @ q
    dt = left.dtype
    return (
        q[:t, :t].astype(dt), q[:t, t:].astype(dt),
        q[t:, :t].astype(dt), q[t:, t:].astype(dt),
        rc[:t].T.astype(dt),
    )


def lq_apply2(qtt, qtb, qbt, qbb, yl, yr):
    """Apply Q^T (from lq_factor2) on the right to [yl yr]:
    returns (yl', yr') = [yl yr] @ Q^T blockwise."""
    qtt, qtb, qbt, qbb = (np.asarray(x, np.float64) for x in (qtt, qtb, qbt, qbb))
    yl64, yr64 = np.asarray(yl, np.float64), np.asarray(yr, np.float64)
    new_l = yl64 @ qtt.T + yr64 @ qtb.T
    new_r = yl64 @ qbt.T + yr64 @ qbb.T
    return new_l.astype(yl.dtype), new_r.astype(yr.dtype)


# --------------------------------------------------------------------------
# Registry + flop model (feeds the metrics layer; the reference keeps
# per-instruction flop counters on RemoteInstruction — SURVEY §5 tracing)
# --------------------------------------------------------------------------

KERNELS = {
    "potrf": potrf,
    "trsm": trsm,
    "syrk": syrk,
    "gemm": gemm,
    "gemm_nt": gemm_nt,
    "gemm_tn": gemm_tn,
    "gemm_acc": gemm_acc,
    "add": add,
    "sub": sub,
    "identity": identity,
    "copy": copy,
    "transpose": transpose,
    "qr_leaf": qr_leaf,
    "qr_combine": qr_combine,
    "qr_r": qr_r,
    "lq_leaf": lq_leaf,
    "small_qr_apply": small_qr_apply,
    "qr_factor2": qr_factor2,
    "qr_apply2": qr_apply2,
    "lq_factor2": lq_factor2,
    "lq_apply2": lq_apply2,
}
KERNELS.update({f.__name__: f for f in _QR_COMBINE_R.values()})

# number of outputs per kernel (the DSL needs this for multi-assignment)
N_OUTPUTS = {name: 1 for name in KERNELS}
N_OUTPUTS.update({
    "qr_leaf": 2, "qr_combine": 3, "lq_leaf": 2,
    "qr_factor2": 5, "lq_factor2": 5, "qr_apply2": 2, "lq_apply2": 2,
})


def flop_count(op: str, shapes) -> int:
    """Approximate useful flops of one kernel call given input shapes."""
    if op in ("gemm", "gemm_nt", "gemm_tn"):
        (m, k), s2 = shapes[0], shapes[1]
        n = s2[1] if op == "gemm" else (s2[0] if op == "gemm_nt" else s2[1])
        return 2 * m * k * n
    if op == "gemm_acc":
        (m, k) = shapes[1]
        n = shapes[2][1]
        return 2 * m * k * n
    if op == "syrk":
        (m, k) = shapes[1]
        n = shapes[2][0]
        return 2 * m * k * n
    if op == "trsm":
        m, n = shapes[0]
        return m * n * n
    if op == "potrf":
        n = shapes[0][0]
        return n * n * n // 3
    if op in ("qr_leaf", "qr_r"):
        m, n = shapes[0]
        return 2 * m * n * n
    if op == "qr_combine":
        n = shapes[0][0]
        return 2 * (2 * n) * n * n
    if op.startswith("qr_combine_r"):
        m = int(op[len("qr_combine_r"):])
        n = shapes[0][0]
        return 2 * (m * n) * n * n
    if op == "lq_leaf":
        m, n = shapes[0]
        return 2 * n * m * m
    if op == "small_qr_apply":
        (m, k) = shapes[0]
        n = shapes[1][1]
        return 2 * m * k * n
    if op in ("qr_factor2", "lq_factor2"):
        n = shapes[0][0]
        return 4 * n * n * n
    if op in ("qr_apply2", "lq_apply2"):
        n = shapes[0][0]
        return 8 * n * n * n
    if op in ("add", "sub", "copy", "identity", "transpose"):
        m, n = shapes[0]
        return m * n
    return 0
