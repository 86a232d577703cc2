"""SVD model family, built on the port's factorizations.

Counterpart of numpywren_tpu/models/svd.py, the part that needs only the
fused TSQR (ROADMAP Queue 1 #5a):

- `svd_tall`: thin SVD of a tall-skinny matrix via the adaptive shifted
  CholeskyQR chain (`compiler.lower.fused_tsqr`) + a small host SVD of R;
  everything big is a product.
- `randomized_svd`: Halko-Martinsson-Tropp range sketch + power iteration
  with Householder re-orthogonalization; rank-k factors at product speed.
- `svd(method="jacobi")`: the all-device one-sided block-Jacobi SVD
  (models.jacobi.svd_jacobi).

Not ported yet: the two-stage BDFAC pipeline, which `svd(method="bdfac")`
(and `method=None`, which routes there off a TPU) and `singular_values`
need (ROADMAP Queue 1 #5b), and the QDWH route (#5c); those raise
NotImplementedError.

Inputs: a tensor stays where it is, an ndarray goes to `device` (else the
current CUDA device). Results are ndarrays, as in the reference. The
models' own products are torch.matmul in true FP32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from numpywren_tpu_torch.ops.common import as_tensor, np_dtype, to_numpy

__all__ = ["singular_values", "svd", "svd_tall", "randomized_svd"]

_BDFAC = "the fused BDFAC lowering is not ported yet (ROADMAP Queue 1 #5b)"


def singular_values(x, tile: int = None, finish: str = "band",
                    panel_method: str = None, mesh=None, device=None) -> np.ndarray:
    """All singular values by the two-stage BDFAC pipeline: not ported yet."""
    raise NotImplementedError(f"singular_values: {_BDFAC}")


def _route_default_method(shape, platform: str = None) -> str:
    """svd(method=None) routing, the reference's rule as it is: large
    with-vectors inputs on a TPU go to the block-Jacobi path, everything
    else (every platform of this port: a torch device type, "cuda" or
    "cpu"; None is this process's) to "bdfac". The H100's own crossover is
    a measured decision for ROADMAP Queue 1 #5c."""
    if platform != "tpu":
        return "bdfac"
    n_min = min(shape)
    if n_min < 4096:
        return "bdfac"
    from numpywren_tpu_torch.utils import host_gflops

    host_s = 520.0 * (n_min / 8192.0) ** 3 * (15.0 / host_gflops())
    jacobi_s = max(3.0, 39.4 * (n_min / 8192.0) ** 3)
    return "jacobi" if host_s > jacobi_s else "bdfac"


def svd(x, tile: int = 512, panel_method: str = None, precision=None,
        accum_precision="highest", method: str = None,
        uv_finish: str = "host", refine: Optional[int] = None, device=None
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full SVD: (U, s, Vt) ndarrays with x = U @ diag(s) @ Vt (thin factors
    for rectangular x).

    method: "jacobi" runs models.svd_jacobi (block = min(tile, 512)) on
    x's device; "bdfac" and None (which routes to "bdfac" off a TPU,
    `_route_default_method`) need the fused BDFAC (ROADMAP Queue 1 #5b);
    "qdwh" waits for #5c. Tiled inputs are materialized
    (`utils.get_local_matrix`) and run on the matrix's device. refine
    (None: 0 off a TPU, as the reference decides) applies to the BDFAC
    route's factors; the Jacobi route refines inside svd_jacobi.
    panel_method, accum_precision and uv_finish are the BDFAC route's."""
    if hasattr(x, "get_block"):
        from numpywren_tpu_torch.utils import get_local_matrix

        return svd(get_local_matrix(x), tile=tile, panel_method=panel_method,
                   precision=precision, accum_precision=accum_precision,
                   method=method, uv_finish=uv_finish, refine=refine,
                   device=device if device is not None else x.device)
    x = as_tensor(x, device)
    if x.dim() != 2:
        raise ValueError(f"svd expects a matrix, got {tuple(x.shape)}")
    if method not in (None, "bdfac", "qdwh", "jacobi"):
        raise ValueError(f"unknown svd method {method!r}")
    if method is None:
        method = _route_default_method(tuple(x.shape), x.device.type)
    if method == "jacobi":
        from numpywren_tpu_torch.models.jacobi import svd_jacobi

        dt = np_dtype(x.dtype)
        u, s, vt = svd_jacobi(x.float(), block=min(tile, 512), precision=precision)
        return tuple(to_numpy(a).astype(dt) for a in (u, s, vt))
    if method == "qdwh":
        raise NotImplementedError(
            "svd(method='qdwh'): the QDWH route is not ported yet (ROADMAP Queue 1 #5c)")
    raise NotImplementedError(f"svd(method={method!r}): {_BDFAC}")


def svd_tall(x, method: str = "cholqr3s", device=None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Thin SVD of a tall-skinny (m, b) matrix: (U, s, Vt) with U (m, b),
    s (b,), Vt (b, b).

    QR by the adaptive shifted CholeskyQR3 by default (`fused_tsqr`, one
    leaf), then an O(b³) host SVD of R and one product for U = Q @ U_r.
    method: "cholqr3s" | "cholqr2" | "tree"."""
    from numpywren_tpu_torch.compiler.lower import fused_tsqr

    xd = as_tensor(x, device)
    m, b = xd.shape
    if m < b:
        raise ValueError(f"svd_tall expects m >= b, got {tuple(xd.shape)}")
    dt = np_dtype(xd.dtype)
    q, r = fused_tsqr(xd, tile_rows=m, compute_q=True, method=method)
    u_r, s, vt = np.linalg.svd(to_numpy(r).astype(np.float64))
    u = q @ torch.as_tensor(u_r.astype(dt), device=q.device)
    return to_numpy(u), s.astype(dt), vt.astype(dt)


def randomized_svd(x, rank: int, oversample: int = 8, power_iters: int = 2,
                   seed: int = 0, device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rank-`rank` truncated SVD by randomized range finding
    (Halko-Martinsson-Tropp): U (m, rank), s (rank,), Vt (rank, n).

    Gaussian sketch Y = X @ Omega with `oversample` extra columns (a
    torch.Generator on x's device seeded `seed`: the same seed gives the
    same factors on one device; the reference draws jax.random bits), then
    `power_iters` rounds of Y <- X (Xᵀ Q) with Householder
    re-orthogonalization between rounds, and B = QᵀX solved by one more
    tall QR of Bᵀ plus an O(l³) host SVD. Householder (torch.linalg.qr),
    not CholeskyQR: an oversampled sketch of an exactly rank-deficient input
    has a singular Gram."""
    xd = as_tensor(x, device)
    m, n = xd.shape
    l = min(rank + oversample, min(m, n))
    if not 1 <= rank <= min(m, n):
        raise ValueError(f"rank {rank} out of range for shape {tuple(xd.shape)}")
    dt = np_dtype(xd.dtype)
    gen = torch.Generator(device=xd.device).manual_seed(seed)
    omega = torch.randn((n, l), generator=gen, dtype=xd.dtype, device=xd.device)
    y = xd @ omega
    for _ in range(power_iters):
        q1, _ = torch.linalg.qr(y, mode="reduced")
        y = xd @ (xd.T @ q1)
    q, _ = torch.linalg.qr(y, mode="reduced")
    qv, rv = torch.linalg.qr(xd.T @ q, mode="reduced")  # Bᵀ = XᵀQ, (n, l) tall
    # B = rvᵀ qvᵀ; svd(rvᵀ) = U1 S Wᵀ  =>  X ~ (Q U1) S (Qv W)ᵀ
    u1, s, wt = np.linalg.svd(to_numpy(rv).T.astype(np.float64))
    u = q @ torch.as_tensor(u1[:, :rank].astype(dt), device=q.device)
    v = qv @ torch.as_tensor(wt[:rank].T.astype(dt), device=q.device)
    return to_numpy(u), s[:rank].astype(dt), to_numpy(v).T
