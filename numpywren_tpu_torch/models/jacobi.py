"""One-sided block-Jacobi SVD: full SVD with vectors, entirely on device.

Counterpart of numpywren_tpu/models/jacobi.py (the reference's design notes
and measurements are there). Maintain W <- A and an accumulator V <- I.
Sweep a round-robin tournament over column-block pairs; for each pair the
2b x 2b Gram G = [Wi Wj]ᵀ [Wi Wj] is eigendecomposed and the rotation applied
to [Wi Wj] and [Vi Vj]. At convergence W's columns are mutually orthogonal:
W = U diag(s), A = U diag(s) Vᵀ. Then the graded sigma-window mirrors, a
CholeskyQR2 polish, a Rayleigh re-extract of sigma and Ogita-Aishima
refinement steps take the factors to working precision.

On PyTorch:

- a sweep is a Python loop over its g - 1 rounds; each round gathers its
  g/2 disjoint pairs (`index_select`), forms their Grams and rotations with
  `torch.bmm`, runs one batched `torch.linalg.eigh`, and scatters the pairs
  back (`index_copy`, exact since a round is a permutation);
- every product is torch.matmul / torch.bmm in true FP32 whatever
  `precision` says (TF32 is off, ops/common.py), as the reference's
  ``jnp.matmul``/``einsum`` are computed outside any Pallas kernel;
- ``jnp.argsort`` is stable and so is every sort here (`stable=True`), so
  tied Gram diagonals (zero-padded columns) reorder as in the reference;
- a ``lax.cond`` or a per-sweep scalar is one host read: the off-norm once
  a sweep, the sigma vector before the polish and before each extra graded
  pass, the CholeskyQR pass's breakdown flag once a pass, the rank count of
  a completion. ``torch.linalg.eigh`` checks its status on the host, so
  each round's eigh waits for the device as well.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from numpywren_tpu_torch.ops.common import as_tensor, check_precision

__all__ = ["svd_jacobi", "svd_refine", "roundrobin_schedule"]


def roundrobin_schedule(g: int) -> np.ndarray:
    """(g-1, g) round-robin tournament: row r lists a block order such that
    (row[2k], row[2k+1]) are the disjoint pairs of round r; over the g-1
    rounds every unordered block pair meets exactly once (the classical
    circle method: fix block 0, rotate the rest). g must be even."""
    if g < 2 or g % 2:
        raise ValueError(f"round-robin needs an even g >= 2, got {g}")
    idx = list(range(g))
    rounds = []
    for _ in range(g - 1):
        row = []
        for k in range(g // 2):
            row += [idx[k], idx[g - 1 - k]]
        rounds.append(row)
        idx = [idx[0]] + [idx[-1]] + idx[1:-1]
    return np.asarray(rounds, dtype=np.int32)


def _pairs(blocks: torch.Tensor) -> torch.Tensor:
    """(g, r, b) column blocks in round order -> (g/2, r, 2b) pair panels."""
    g, r, b = blocks.shape
    return blocks.reshape(g // 2, 2, r, b).transpose(1, 2).reshape(g // 2, r, 2 * b)


def _unpairs(pairs: torch.Tensor) -> torch.Tensor:
    """Inverse of _pairs."""
    h, r, b2 = pairs.shape
    return pairs.reshape(h, r, 2, b2 // 2).transpose(1, 2).reshape(2 * h, r, b2 // 2)


def _sweep(w, v, perms, *, g: int, b: int, skip_rel: float = 0.0):
    """One full round-robin sweep (g-1 rounds) over column-block pairs.

    w: (g, m, b) column blocks of the working matrix; v: (g, n, b) column
    blocks of the right-transform accumulator; perms: (g-1, g) int64 round
    schedules on w's device. Each round: gather the paired blocks,
    eigendecompose the 2b x 2b pair Grams (batched over the g/2 disjoint
    pairs), rotate. Returns the new (w, v); the inputs are not written.

    The rotation is the one CLOSEST TO IDENTITY: Q's columns are reordered
    so that eigenvalue ranks follow the rank order of the Gram's diagonal
    (a stable double argsort, so tied diagonals keep their index order), with
    positive-diagonal signs. An eigenvalue-sorted Q degenerates into a bare
    permutation for near-diagonal pairs and the sweep map cycles.

    skip_rel > 0: a pair whose relative off-mass sqrt(off2/diag2) is below
    skip_rel gets the EXACT identity instead of eigh's near-identity Q, so
    a converged pair passes through bit for bit (products with an exact
    identity are exact) and stops re-absorbing GEMM roundoff."""
    eye2b = torch.eye(2 * b, dtype=w.dtype, device=w.device)
    for r in range(g - 1):
        perm = perms[r]
        pair_w = _pairs(w.index_select(0, perm))           # (g/2, m, 2b)
        pair_v = _pairs(v.index_select(0, perm))           # (g/2, n, 2b)
        gram = torch.bmm(pair_w.transpose(1, 2), pair_w)
        _, q = torch.linalg.eigh(gram)                     # ascending
        d = torch.diagonal(gram, dim1=1, dim2=2)
        rank = torch.argsort(torch.argsort(d, dim=1, stable=True), dim=1, stable=True)
        q = torch.take_along_dim(q, rank[:, None, :], dim=2)
        sgn = torch.sign(torch.diagonal(q, dim1=1, dim2=2))
        sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
        q = q * sgn[:, None, :]
        if skip_rel > 0.0:
            # diagonal zeroed BEFORE summing (the fp32 cancellation trap of
            # _off_rel); the comparison squared to avoid the sqrt
            off2 = torch.sum(torch.square(gram - torch.diag_embed(d)), dim=(1, 2))
            den2 = torch.sum(torch.square(d), dim=1)
            conv = off2 <= (skip_rel * skip_rel) * den2
            q = torch.where(conv[:, None, None], eye2b, q)
        w = w.index_copy(0, perm, _unpairs(torch.bmm(pair_w, q)))
        v = v.index_copy(0, perm, _unpairs(torch.bmm(pair_v, q)))
    return w, v


def _off_rel(w) -> torch.Tensor:
    """Relative off-diagonal mass of the column Gram C = WᵀW,
    ||C - diag||_F / ||diag||_F: the one scalar read per sweep (a 0-d
    tensor; the caller reads it). Monotone under the pair rotations and
    quadratically convergent. fp32 trap: sum(C²) - sum(diag²) cancels once
    the off-mass is below the sums' roundoff, so the diagonal is zeroed
    BEFORE summing."""
    g, m, b = w.shape
    wm = w.transpose(0, 1).reshape(m, g * b)
    c = wm.T @ wm
    d = torch.diagonal(c)
    off2 = torch.sum(torch.square(c - torch.diag(d)))
    den = torch.sum(torch.square(d))
    return torch.sqrt(off2 / torch.clamp_min(den, 1e-30))


def _cholqr_pass(u):
    """One CholeskyQR pass: (U L⁻ᵀ, L) with L = chol(UᵀU). Where the
    factor fails L is NaN, as the reference's cholesky returns it."""
    c = u.T @ u
    l, info = torch.linalg.cholesky_ex(c)
    l = torch.where(info == 0, l, torch.full_like(l, float("nan")))
    return torch.linalg.solve_triangular(l.T, u, upper=True, left=False), l


def _qr_fix(u):
    """Householder QR's Q with R's diagonal signs folded in."""
    q, r = torch.linalg.qr(u, mode="reduced")
    sgn = torch.sign(torch.diagonal(r))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    return q * sgn[None, :]


def _polish_u(u):
    """CholeskyQR2 re-orthonormalization of U (columns sigma-sorted
    descending, so the triangular solve orthogonalizes each trailing column
    against the leading ones). A pass whose Cholesky breaks (near-parallel
    garbage columns) falls back to sign-fixed Householder QR: one host read
    of the factor's finiteness a pass, and the QR runs only then."""
    for _ in range(2):
        u2, l = _cholqr_pass(u)
        u = u2 if bool(torch.isfinite(torch.diagonal(l)).all()) else _qr_fix(u)
    return u


def _sigma_boundaries(s_host: np.ndarray, step: float, quantum: int):
    """Column indices where sigma first drops below the previous
    boundary's sigma / step, rounded DOWN to `quantum` multiples (the
    reference bounds its compiled window shapes so)."""
    k = len(s_host)
    bounds = [0]
    t0 = float(s_host[0])
    for j in range(1, k):
        if s_host[j] < t0 / step:
            jq = (j // quantum) * quantum
            if jq > bounds[-1]:
                bounds.append(jq)
            t0 = float(s_host[j])
    bounds.append(k)
    return bounds


def _window_eigh_mirror(w, vt, *, lo: int, hi: int):
    """Orthogonal mirror on a sigma-window, in place: Q = eigh(W_wᵀ W_w)
    (descending), W_w <- W_w Q, Vt_w <- Qᵀ Vt_w. Q is orthogonal, so V stays
    exactly orthogonal and W @ Vt is invariant."""
    ww = w[:, lo:hi]
    _, q = torch.linalg.eigh(ww.T @ ww)
    q = q.flip(1)                                    # descending sigma
    w[:, lo:hi] = ww @ q
    vt[lo:hi] = q.T @ vt[lo:hi]
    return w, vt


def _resort_by_norm(w, vt):
    s = torch.sqrt(torch.sum(torch.square(w), dim=0))
    order = torch.argsort(-s, stable=True)
    return w[:, order], vt[order], s[order]


def _graded_polish(u, s, s_host, vt, *, step=8.0, span=3, passes=2, quantum=32,
                   s_keep=0.1):
    """Sliding sigma-window orthogonal mirrors over W = U diag(s) (the
    reference's module docstring): windows [b_i, b_{i+span}) over the
    step-ratio boundaries, trimmed at the top to sigma < s_keep * sigma_max.
    Each extra pass re-sorts by norm and reads the norms once. Returns
    (u, s, vt) with U re-normalized; the caller still runs the CholeskyQR2
    touch-up."""
    w = u * s[None, :]
    vt = vt.clone()  # the mirrors write in place; the caller's rows stay
    for p in range(passes):
        if p > 0:
            w, vt, s_dev = _resort_by_norm(w, vt)
            s_host = s_dev.cpu().numpy()
        if not float(s_host[0]) > 0:
            break
        cut = int(np.searchsorted(-s_host, -s_keep * float(s_host[0])))
        cut = (cut // quantum) * quantum
        bounds = _sigma_boundaries(s_host, step, quantum)
        nb = len(bounds) - 1
        done = set()
        for bi in range(nb):
            lo = max(bounds[bi], cut)
            hi = bounds[min(bi + span, nb)]
            if hi - lo < 2 or (lo, hi) in done:
                continue
            done.add((lo, hi))
            w, vt = _window_eigh_mirror(w, vt, lo=int(lo), hi=int(hi))
    w, vt, s_new = _resort_by_norm(w, vt)
    u = w / torch.clamp_min(s_new, 1e-30)[None, :]
    return u, s_new, vt


def _finish(w, v, *, n_keep: int):
    """sigma = column norms, U = W / sigma, global descending sort, crop the
    zero-padding columns (U to n_keep columns, Vt to n_keep rows AND
    columns). Columns with sigma ~ 0 come back as ZERO U columns (the
    caller's rank completion handles them)."""
    g, m, b = w.shape
    n_full = g * b
    wm = w.transpose(0, 1).reshape(m, n_full)
    vm = v.transpose(0, 1).reshape(v.shape[1], n_full)
    s = torch.sqrt(torch.sum(torch.square(wm), dim=0))
    order = torch.argsort(-s, stable=True)[:n_keep]
    s = s[order]
    u = wm[:, order] / torch.clamp_min(s, 1e-30)[None, :]
    vt = vm[:, order].T[:, :n_keep]
    # columns whose norm is at the underflow floor carry no direction:
    # zero them so the completion sees exact zeros, not noise
    good = (s > 1e-30).to(u.dtype)
    return u * good[None, :], s * good, vt * good[:, None]


def _complete_rank_deficient(u, s, rank_tol: float):
    """Replace the U columns of (near-)zero singular values with an
    orthonormal completion of the leading columns' span: QR of
    [U_good | Gaussian noise] (torch.Generator seeded 0 on U's device; the
    reference draws jax.random bits, so the completion's columns differ
    while both are orthonormal). R's diagonal signs are folded back so the
    leading r columns stay equal to U_good. One host read: the rank."""
    m, k = u.shape
    smax = s[0] if s.shape[0] else torch.zeros((), dtype=s.dtype, device=s.device)
    r = int(torch.count_nonzero(s > rank_tol * torch.clamp_min(smax, 1e-30)))
    if r == k:
        return u
    gen = torch.Generator(device=u.device).manual_seed(0)
    noise = torch.randn((m, k - r), generator=gen, dtype=u.dtype, device=u.device)
    return _qr_fix(torch.cat([u[:, :r], noise], dim=1))


def _refine_step(x, u, s, vt, *, tau: float, cut_c: float):
    """One Ogita-Aishima-style SVD iterative-refinement step (the
    reference's docstring has the derivation): with R = I - UᵀU,
    S = I - VᵀV, T = UᵀAV, a per-(i,j) 2x2 solve of determinant
    sigma_j² - sigma_i² gives U' = U(I+E), V' = V(I+F). Two masks fall back
    to the symmetrizers E = R/2, F = S/2: tau for clustered pairs, cut_c
    for tiny-sigma pairs below the noise floor sqrt(m)·eps·sigma_max.
    Returns (u, s, vt) re-sorted by the Rayleigh sigma."""
    k = u.shape[1]
    eye = torch.eye(k, dtype=u.dtype, device=u.device)
    r = eye - u.T @ u
    sm = eye - vt @ vt.T
    t = u.T @ (x @ vt.T)
    sj = s[None, :]
    si = s[:, None]
    denom = sj * sj - si * si
    num_e = sj * (t + sj * r) + si * (t.T + sj * sm)
    num_f = si * (t + sj * r) + sj * (t.T + sj * sm)
    cut = cut_c * float(torch.finfo(u.dtype).eps) * (u.shape[0] ** 0.5)
    pair2 = si * si + sj * sj
    safe = (torch.abs(denom) > tau * pair2) & (pair2 > (cut * s[0]) ** 2)
    den_safe = torch.where(safe, denom, torch.ones_like(denom))
    e = torch.where(safe, num_e / den_safe, r * 0.5)
    f = torch.where(safe, num_f / den_safe, sm * 0.5)
    u = u + u @ e
    vt = vt + f.T @ vt
    s2 = torch.clamp_min(torch.einsum("mi,mi->i", u, x @ vt.T), 0.0)
    order = torch.argsort(-s2, stable=True)
    return u[:, order], s2[order], vt[order]


def svd_refine(x, u, s, vt, steps: int = 1, precision=None,
               tau: float = 3e-4, cut_c: float = 10.0, device=None):
    """Refine ANY thin SVD factors of x toward the true factorization:
    (U, s, Vt) -> (U', s', Vt') with quadratically smaller factor error per
    step (see _refine_step). Five n³ products a step, on x's device (or
    `device`); u, s, vt move there. Returns tensors. The caller's tensors
    are not written. precision is checked; the products are true FP32."""
    if precision is not None:
        check_precision(precision)
    x = as_tensor(x, device)
    u = as_tensor(u, x.device).clone()
    vt = as_tensor(vt, x.device).clone()
    s = as_tensor(s, x.device)
    for _ in range(int(steps)):
        u, s, vt = _refine_step(x, u, s, vt, tau=float(tau), cut_c=float(cut_c))
    return u, s, vt


def _rayleigh_s(x, u, vt):
    """Re-extract sigma as diag(Uᵀ A V) after the polish: the
    reconstruction-optimal diagonal for orthonormal U, V and second-order
    accurate. Returns sigma clamped at 0 and the descending re-sort order."""
    s = torch.clamp_min(torch.einsum("mi,mi->i", u, x @ vt.T), 0.0)
    order = torch.argsort(-s, stable=True)
    return s[order], order


def _polish_prefix(u, r: int):
    """_polish_u on U's first r columns (the nonzero-sigma prefix)."""
    if r == u.shape[1]:
        return _polish_u(u)
    return torch.cat([_polish_u(u[:, :r]), u[:, r:]], dim=1)


def _sweep_setup(x, block: int, skip_rel: Optional[float] = None):
    """The sweep loop's operands for a tall (m, n) x: (w, v, perms, g, b,
    skip_rel). w (g, m, b) holds x's column blocks, zero-padded to an even
    number g of blocks of width b = min(block, ceil(n / 2)); v (g, g*b, b)
    the identity's; perms the round-robin schedule; skip_rel None becomes
    1.5 sqrt(2b) eps/2."""
    m, n = x.shape
    b = min(block, -(-n // 2))
    g = -(-n // b)
    if g % 2:
        g += 1
    n_pad = g * b
    wm = x if n_pad == n else torch.nn.functional.pad(x, (0, n_pad - n))
    w = wm.T.reshape(g, b, m).transpose(1, 2).contiguous()          # (g, m, b)
    eye = torch.eye(n_pad, dtype=x.dtype, device=x.device)
    v = eye.T.reshape(g, b, n_pad).transpose(1, 2).contiguous()     # (g, n_pad, b)
    perms = torch.as_tensor(roundrobin_schedule(g), dtype=torch.int64, device=x.device)
    if skip_rel is None:
        u_round = float(torch.finfo(x.dtype).eps) / 2.0
        skip_rel = 1.5 * (2.0 * b) ** 0.5 * u_round
    return w, v, perms, g, b, skip_rel


def svd_jacobi(
    x,
    block: int = 512,
    max_sweeps: int = 24,
    tol: float = 2e-6,
    precision=None,
    compute_uv: bool = True,
    polish: bool = True,
    rank_tol: float = 0.0,
    skip_rel: Optional[float] = None,
    refine: int = 2,
    _sweep_trace: Optional[list] = None,
    device=None,
) -> Tuple:
    """Full SVD with vectors, no host O(n³) stage: (U, s, Vt) tensors on
    x's device with x = U @ diag(s) @ Vt (thin factors, k = min(m, n)), or
    just s (descending) when compute_uv=False. x: a tensor (stays where it
    is) or an ndarray (to `device`, else the current CUDA device).

    block: column-block width b (pair eighs are 2b x 2b; the reference's
    512 was measured on a TPU v5e). Inputs are zero-padded to an even
    number of blocks; zero columns are invariant under the pair rotations
    and are cropped before returning.

    tol: converged when ||offdiag(WᵀW)||_F / ||diag||_F falls below tol;
    the loop also stops on stagnation (off-norm no longer shrinking). A
    final off-norm above sqrt(tol) warns (RuntimeWarning).

    precision: checked (ops.common.PRECISIONS); the Grams and rotations are
    torch.matmul / torch.bmm in true FP32 at every precision.

    polish: CholeskyQR2-reorthonormalize U (after the graded sigma-window
    mirrors when the spectrum spans more than 10x). rank_tol > 0 completes
    the U columns of singular values below rank_tol * s[0] to an
    orthonormal basis; at 0 they return as exact zeros. skip_rel: the
    per-pair threshold below which a rotation is the exact identity (None:
    1.5 sqrt(2b) eps/2; 0 disables). refine: iterative-refinement steps
    after the polish (needs polish=True).

    Wide inputs run on x.T (factors swapped back). _sweep_trace, when a
    list, receives each sweep's off-norm."""
    if precision is not None:
        check_precision(precision)
    x = as_tensor(x, device)
    if x.dim() != 2:
        raise ValueError(f"svd_jacobi expects a matrix, got {tuple(x.shape)}")
    m, n = x.shape
    if m < n:
        # run on x.T and swap the factors back; rank_tol is applied HERE, to
        # the swapped-back U (the recursion's V side)
        res = svd_jacobi(x.T, block=block, max_sweeps=max_sweeps, tol=tol,
                         precision=precision, compute_uv=compute_uv,
                         polish=polish, rank_tol=0.0, skip_rel=skip_rel,
                         refine=refine, _sweep_trace=_sweep_trace)
        if not compute_uv:
            return res
        u, s, vt = res
        u_wide, vt_wide = vt.T, u.T
        if rank_tol > 0:
            u_wide = _complete_rank_deficient(u_wide, s, rank_tol)
        return u_wide, s, vt_wide
    if n <= 8:
        # tiny problems: one host LAPACK call (the reference's semantics),
        # the factors returned on x's device
        un, sn, vtn = np.linalg.svd(x.detach().cpu().numpy(), full_matrices=False)
        if not compute_uv:
            return torch.as_tensor(sn, device=x.device)
        return tuple(torch.as_tensor(a, device=x.device) for a in (un, sn, vtn))

    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()

    w, v, perms, g, b, skip_rel = _sweep_setup(x, block, skip_rel)
    n_pad = g * b
    prev = float("inf")
    off = 0.0
    for _ in range(max_sweeps):
        w, v = _sweep(w, v, perms, g=g, b=b, skip_rel=float(skip_rel))
        off = float(_off_rel(w))
        if _sweep_trace is not None:
            _sweep_trace.append(off)
        if off <= tol or off >= 0.9 * prev:
            # converged, or the off-norm stopped contracting (the roundoff
            # floor: more sweeps only burn time)
            break
        prev = off
    if off > tol ** 0.5:
        warnings.warn(
            f"svd_jacobi did not converge: off-norm {off:.2e} > "
            f"sqrt(tol) = {tol ** 0.5:.2e} after the sweep loop "
            f"(max_sweeps={max_sweeps}); factors may reconstruct poorly",
            RuntimeWarning, stacklevel=2)

    u, s, vt = _finish(w, v, n_keep=n)
    if not compute_uv:
        return s
    if polish:
        s_host = s.cpu().numpy()
        r = int(np.count_nonzero(s_host))
        # graded mirrors first whenever the spectrum spans more than 10x
        if r >= 2 and float(s_host[0]) > 0 and \
                float(s_host[0]) / float(s_host[r - 1]) > 10.0:
            if r == s.shape[0]:
                u, s, vt = _graded_polish(u, s, s_host, vt)
            else:
                u2, s2g, vt2 = _graded_polish(u[:, :r], s[:r], s_host[:r], vt[:r])
                u = torch.cat([u2, u[:, r:]], dim=1)
                s = torch.cat([s2g, s[r:]])
                vt = torch.cat([vt2, vt[r:]], dim=0)
            polish_vt = True   # the mirrors' GEMM roundoff on Vt rows
        else:
            # cropping the padded V coordinates loses the mass that
            # near-degenerate small-sigma pairs leaked into them
            polish_vt = n_pad != n
        if r:
            u = _polish_prefix(u, r)
            if polish_vt:
                vt = _polish_prefix(vt.T, r).T
            s, order = _rayleigh_s(x, u, vt)
            u, vt = u[:, order], vt[order]
        if refine and r >= 2:
            # quadratic-contraction finisher (_refine_step), then a CholeskyQR2
            # touch-up of both factors and the Rayleigh re-extract
            for _ in range(int(refine)):
                u, s, vt = _refine_step(x, u, s, vt, tau=3e-4, cut_c=10.0)
            u = _polish_prefix(u, r)
            vt = _polish_prefix(vt.T, r).T
            s, order = _rayleigh_s(x, u, vt)
            u, vt = u[:, order], vt[order]
    if rank_tol > 0:
        u = _complete_rank_deficient(u, s, rank_tol)
    return u, s, vt
