"""SVD model family, built on the port's factorizations.

Counterpart of numpywren_tpu/models/svd.py:

- `singular_values`: two-stage sigma(A). Stage 1 is the fused BDFAC on the
  device (`compiler.lower.fused_bdfac`), which reduces A to block upper
  bidiagonal B with sigma(B) = sigma(A); stage 2 takes sigma(B) on the
  host: the band corner-tightened to one tile, narrowed on the device by
  `band_reduce` when wider than 256, then LAPACK dgbbrd + dbdsdc through
  ctypes (`band.py`), or a dense host gesdd where no LAPACK library is
  found or LAPACK reports an error.
- `svd(method="bdfac")` (and None, which routes there off a TPU): the same
  stage 1 accumulating P and Q (A = P B Qᵀ), a host fp64 SVD of B, and
  U = P Ub, Vt = Vbᵀ Qᵀ.
- `svd_tall`: thin SVD of a tall-skinny matrix via the adaptive shifted
  CholeskyQR chain (`compiler.lower.fused_tsqr`) + a small host SVD of R;
  everything big is a product.
- `randomized_svd`: Halko-Martinsson-Tropp range sketch + power iteration
  with Householder re-orthogonalization; rank-k factors at product speed.
- `svd(method="jacobi")`: the all-device one-sided block-Jacobi SVD
  (models.jacobi.svd_jacobi).
- the QDWH route (`_qdwh_svd`, models.qdwh: a QDWH polar decomposition
  and `torch.linalg.eigh` of its h, no host stage): `svd(method="qdwh")`,
  `singular_values(finish="qdwh")` and `svd(uv_finish="device")`, the
  device SVD of the BDFAC's B.
- `singular_values(mesh=)` on a mesh of more than one device: stage 1 is
  the distributed BDFAC (`parallel.fabric.bdfac_2d` on a 2-D mesh,
  `bdfac_1d` on a flat one), which returns only the band blocks.

Inputs: a tensor stays where it is, an ndarray goes to `device` (else the
current CUDA device). Results are ndarrays, as in the reference. The
models' own products are torch.matmul in true FP32; the BDFAC's large
products run the port's GEMM kernels (see compiler.lower).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from numpywren_tpu_torch.ops.common import as_tensor, np_dtype, to_numpy

__all__ = ["singular_values", "svd", "svd_tall", "randomized_svd"]


def _mesh_size(mesh) -> int:
    """The device count of `mesh`: a DeviceMesh's size(), else its `size`
    attribute (the reference reads jax's Mesh.size); 1 for None."""
    if mesh is None:
        return 1
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        return mesh.size()
    return getattr(mesh, "size", 1)


def _gk_band_sigma(bd: np.ndarray, max_band: int) -> np.ndarray:
    """Singular values of a banded matrix via the shuffled Golub-Kahan form.

    C = P [[0, B], [Bᵀ, 0]] Pᵀ with the perfect-shuffle P (row 2i <- u_i,
    row 2j+1 <- v_j) places B[i, j] at C[2i, 2j+1]: C is symmetric banded
    with bandwidth max(2d+1) over B's occupied diagonals d, and
    eig(C) = {+/-sigma(B)}. Unlike eig(BᵀB) this does not square the
    condition number, so sigma near eps*||B|| stay accurate."""
    from scipy.linalg import eig_banded

    n = bd.shape[0]
    b64 = np.asarray(bd, dtype=np.float64)
    scale = np.abs(b64).max() or 1.0
    occupied = [
        d for d in range(-min(max_band, n - 1), min(max_band, n - 1) + 1)
        if np.abs(np.diagonal(b64, d)).max(initial=0.0) > 1e-9 * scale
    ]
    if not occupied:
        return np.zeros(n)
    u = max(2 * abs(d) + 1 for d in occupied)
    band = np.zeros((u + 1, 2 * n), dtype=np.float64)
    band_rows = 2 * n
    for d in occupied:
        vals = np.diagonal(b64, d)
        i = np.arange(vals.shape[0]) + max(0, -d)
        j = i + d
        p, q = 2 * i, 2 * j + 1
        lo, hi = np.minimum(p, q), np.maximum(p, q)
        keep = hi < band_rows
        band[u - (hi[keep] - lo[keep]), hi[keep]] = vals[keep]
    w = eig_banded(band, lower=False, eigvals_only=True)
    return np.maximum(np.sort(w)[::-1][:n], 0.0)


def _band_sigma(bd: np.ndarray, max_band: int, device=None) -> np.ndarray:
    """sigma of a banded host matrix, the host finish, routed by bandwidth
    as the reference routes it: a band wider than 256 is first narrowed on
    the device (models.band_reduce, on `device`: blocked bulge chasing to
    ku = 2w - 1, w = NPW_BAND_REDUCE_W, default 64, read at each call)
    and finished by LAPACK dgbbrd + dbdsdc, with a dense host gesdd where
    no LAPACK is found or LAPACK reports an error (`info`); a narrower band
    goes to dgbbrd directly, or to the shuffled-GK eigensolve without
    LAPACK. An error of the device reduction itself (a CUDA error, an
    out-of-memory, the leak check's FloatingPointError) propagates: it is
    a fault, not a route. The constants (256, w = 64) were measured by the
    JAX package on a TPU host and are kept until measured beside the card."""
    from numpywren_tpu_torch.models import band, band_reduce

    bd = np.asarray(bd)
    n = bd.shape[0]
    if max_band > 256:
        if band.lapack_available():
            w = int(os.environ.get("NPW_BAND_REDUCE_W", "64"))
            ab, ku2, m = band_reduce.band_reduce_packed(bd, max_band, w=w, device=device)
            if ku2 < max_band:
                try:
                    return band.band_sigma_packed(ab, m, m, 0, ku2)[:n]
                except RuntimeError as e:
                    logging.getLogger("numpywren_tpu_torch").warning(
                        "LAPACK band finish failed (%s); dense gesdd fallback", e)
        return np.linalg.svd(bd.astype(np.float64), compute_uv=False)
    try:
        return band.band_sigma_lapack(bd, ku=max_band)
    except RuntimeError:
        return _gk_band_sigma(bd, max_band=max_band)


def _qdwh_svd(a: torch.Tensor, compute_uv: bool = True):
    """The SVD by QDWH on a's device (models.qdwh.svd, thin): (u, s, vh)
    tensors, or s alone. Every product is a device product and the
    eigensolve is cuSOLVER's on the card: no O(n³) host stage, the
    with-vectors route past the sizes where the host finish is slow."""
    from numpywren_tpu_torch.models import qdwh

    return qdwh.svd(a, full_matrices=False, compute_uv=compute_uv)


def _tighten_corner_blocks(s_full: np.ndarray, d_last: np.ndarray):
    """Halve the band: the BDFAC sweep stops LQ-ing when fewer than two
    superdiagonal blocks remain, so the LAST superdiagonal block is a full
    t x t tile, which alone pushes the bandwidth from t to 2t - 1. An LQ of
    that block (S = L Q, rotating only the last block column) and a QR of
    the densified last diagonal block R Qᵀ make both triangular again.
    Returns (S', R'); sigma is exactly preserved (two orthogonal
    transforms)."""
    qc, rc = np.linalg.qr(np.asarray(s_full, np.float64).T, mode="reduced")
    s2 = rc.T                                    # lower triangular
    _, d2 = np.linalg.qr(np.asarray(d_last, np.float64) @ qc, mode="reduced")
    return s2, d2


def _pack_band_put(ab, ku, n, blk, r0, c0):
    """Scatter one upper-triangular-region block into LAPACK band storage
    AB[ku + i - j, j] (shared by the tiled and block-list packers)."""
    bm = min(blk.shape[0], n - r0)
    bn = min(blk.shape[1], n - c0)
    for jj in range(bn):
        j = c0 + jj
        i0 = max(r0, j - ku)
        i1 = min(r0 + bm, j + 1)  # upper triangular: i <= j
        if i1 > i0:
            ab[ku + i0 - j: ku + i1 - j, j] += blk[i0 - r0: i1 - r0, jj]


def _packed_band_from_lists(diags, sups, n, t):
    """LAPACK band storage from (diag, superdiag) block LISTS. Uniform
    grids are corner-tightened first (ku = t, not 2t - 1)."""
    gm = len(diags)
    diags = [to_numpy(d).astype(np.float64) for d in diags]
    sups = [None if s is None else to_numpy(s).astype(np.float64) for s in sups]
    if gm >= 2 and n == gm * t and sups[gm - 2] is not None \
            and sups[gm - 2].shape == (t, t):
        s2, d2 = _tighten_corner_blocks(sups[gm - 2], diags[gm - 1])
        sups[gm - 2], diags[gm - 1] = s2, d2
        ku = min(t, n - 1)
    else:
        ku = min(2 * t - 1, n - 1)
    ab = np.zeros((ku + 1, n), dtype=np.float64, order="F")
    for k in range(gm):
        _pack_band_put(ab, ku, n, diags[k], k * t, k * t)
        if sups[k] is not None:
            _pack_band_put(ab, ku, n, sups[k], k * t, (k + 1) * t)
    return ab, n, ku


def _block64(b_mat, i: int, j: int) -> np.ndarray:
    return to_numpy(b_mat.get_block(i, j)).astype(np.float64)


def _packed_band_from_blocks(b_mat):
    """LAPACK band storage (AB[ku + i - j, j] = B[i, j], Fortran order)
    assembled from ONLY the diagonal and superdiagonal blocks of a
    block-bidiagonal TiledMatrix: O(n * tile) host memory, no dense
    square. A uniform grid is corner-tightened first, so ku = t."""
    n = b_mat.shape[0]
    t = b_mat.tile[0]
    gm, gn = b_mat.grid
    diags = [_block64(b_mat, k, k) for k in range(gm)]
    sups = [_block64(b_mat, k, k + 1) if k + 1 < gn else None for k in range(gm)]
    return _packed_band_from_lists(diags, sups, n, t)


def _gk_band_from_blocks(b_mat) -> np.ndarray:
    """Singular values of a block-bidiagonal TiledMatrix without densifying:
    only the diagonal and superdiagonal blocks are read (O(n * tile)
    memory), written straight into the shuffled Golub-Kahan band form and
    eigensolved on the host."""
    from scipy.linalg import eig_banded

    n = b_mat.shape[0]
    t = b_mat.tile[0]
    gm, gn = b_mat.grid
    # B's occupied diagonals reach 2t - 1 (the last superdiagonal block is
    # a full tile), so the GK offset 2d + 1 reaches 4t - 1
    u = 4 * t - 1
    band = np.zeros((u + 1, 2 * n), dtype=np.float64)

    def put(vals, i0, j0):
        """Scatter one local diagonal (B[i0+s, j0+s] = vals[s]) into the
        shuffled GK band (entry (2i, 2j+1) of [[0, B], [Bᵀ, 0]])."""
        if vals.size == 0 or not np.any(vals):
            return
        i = np.arange(vals.shape[0]) + i0
        j = np.arange(vals.shape[0]) + j0
        p, q = 2 * i, 2 * j + 1
        lo, hi = np.minimum(p, q), np.maximum(p, q)
        band[u - (hi - lo), hi] += vals

    for k in range(gm):
        diag = _block64(b_mat, k, k)
        for dl in range(t):
            put(np.diagonal(diag, dl), k * t, k * t + dl)
        if k + 1 < gn:
            sup = _block64(b_mat, k, k + 1)
            for dl in range(-(t - 1), t):
                put(np.diagonal(sup, dl), k * t + max(0, -dl), (k + 1) * t + max(0, dl))
    w = eig_banded(band, lower=False, eigvals_only=True)
    return np.maximum(np.sort(w)[::-1][:n], 0.0)


def _frobenius_kept(a: torch.Tensor, b: torch.Tensor) -> bool:
    """||B||_F within 1e-3 of ||A||_F and finite: the orthogonal sweeps'
    invariant, one host read. A CholeskyQR sweep that failed on a
    rank-deficient input violates it (or is not finite)."""
    na, nb = (float(v) for v in torch.stack([torch.linalg.norm(a.double()),
                                             torch.linalg.norm(b.double())]).cpu())
    return bool(np.isfinite(nb)) and abs(nb - na) <= 1e-3 * max(na, 1e-30)


def _padded(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """A fresh float32 (n_pad, n_pad) copy of x, zero-padded: the BDFAC
    works in it (donate=True), the caller's tensor stays as it is."""
    xp = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=x.device)
    xp[:x.shape[0], :x.shape[1]] = x
    return xp


def singular_values(x, tile: int = None, finish: str = "band",
                    panel_method: str = None, mesh=None, device=None) -> np.ndarray:
    """All singular values, descending, as an fp64 ndarray (rectangular
    inputs are first QR-reduced to the square sigma-preserving R).

    Stage 1 reduces x to block upper bidiagonal B on x's device
    (`compiler.lower.fused_bdfac`); stage 2 extracts sigma(B) on the host:
    finish="band" (default) corner-tightens the band to width = tile and
    runs `_band_sigma` (the device band reduction first when the band is
    wider than 256, then LAPACK dgbbrd + dbdsdc); finish="dense" runs a
    host LAPACK SVD of B (O(n³)).

    tile (None: 512, or 128 when the finish is "band", n > 2048 and no
    LAPACK library is found; the reference's rule). x is zero-padded to a
    multiple of tile (which only appends zero singular values); padded
    trailing panels are rank-deficient, so the padded path defaults to
    panel_method="house". An unpadded input whose CholeskyQR sweep breaks
    the ||B||_F = ||A||_F invariant (a rank-deficient input) is rerun with
    Householder panels.

    A tiled input runs `bdfac` + `run_program` (the fused lowering, or the
    streaming spill executor past the device budget) and reads only the
    band blocks. finish="qdwh" takes an array or tensor through
    `_qdwh_svd` (compute_uv=False: no BDFAC, no host stage; a tiled input
    keeps the BDFAC route).

    mesh: a DeviceMesh of more than one device (a mesh of one runs the
    single-device path) routes stage 1 through the distributed reduction,
    `parallel.fabric.bdfac_2d` where both mesh dimensions exceed 1, else
    `bdfac_1d`, which hands back the band blocks alone (O(n * tile) host
    bytes; x stays where it is and each rank copies its own blocks). Every
    rank of the mesh calls it with the same x and gets the same sigma. It
    takes a square array with n a multiple of tile and no panel_method,
    else ValueError; a band whose ||B||_F strays from ||X||_F by more than
    1e-3 raises RuntimeError (no rank-safe rerun exists there). The finish
    is the reference's: the packed band to LAPACK, or the shuffled
    Golub-Kahan eigensolve without it (finish="dense": a host SVD of B)."""
    from numpywren_tpu_torch.compiler.lower import fused_bdfac, fused_tsqr
    from numpywren_tpu_torch.models import band

    if finish not in ("band", "dense", "qdwh"):
        raise ValueError(f"unknown finish {finish!r}")
    use_mesh = _mesh_size(mesh) > 1
    tiled = hasattr(x, "get_block")
    if finish == "qdwh" and not tiled:
        x = as_tensor(x, device)
        if x.dim() != 2:
            raise ValueError(f"singular_values expects a matrix, got {tuple(x.shape)}")
        s = to_numpy(_qdwh_svd(x.float(), compute_uv=False))
        return np.sort(s)[::-1][:min(x.shape)].astype(np.float64)
    if tiled:
        if use_mesh:
            raise ValueError(
                "mesh-distributed singular_values takes a square array, not a tiled matrix; "
                "materialize (utils.get_local_matrix) or run the tiled input through the "
                "executor stack")
        import numpywren_tpu_torch as npw

        prog, b_mat, _ = npw.bdfac(x)
        status = npw.run_program(prog)
        if status.name != "SUCCESS":
            raise RuntimeError(f"bdfac program ended in state {status.name}")
        try:
            ab, nn, ku = _packed_band_from_blocks(b_mat)
            return band.band_sigma_packed(ab, nn, nn, 0, ku)[: x.shape[0]]
        except RuntimeError:
            return _gk_band_from_blocks(b_mat)[: x.shape[0]]
    # on a mesh x stays where it is: each rank copies only its own blocks
    x = (x if isinstance(x, torch.Tensor) else np.asarray(x)) if use_mesh \
        else as_tensor(x, device)
    if x.ndim != 2:
        raise ValueError(f"singular_values expects a matrix, got {tuple(x.shape)}")
    if tile is None:
        n_min = min(x.shape)
        tile = (512 if (finish == "dense" or n_min <= 2048 or band.lapack_available())
                else 128)
    if x.shape[0] != x.shape[1]:
        if use_mesh:
            # the rectangular pre-reduction is single-device
            raise ValueError(
                f"mesh-distributed singular_values supports square inputs only, got "
                f"{tuple(x.shape)}; QR-reduce to the square R factor first (e.g. "
                "parallel.cholqr2_sharded)")
        # one CholeskyQR chain reduces to the square R (sigma(A) = sigma(R))
        a = x if x.shape[0] > x.shape[1] else x.T
        r = fused_tsqr(a.float(), tile_rows=a.shape[0], method="cholqr3s")
        return singular_values(r, tile=tile, finish=finish, panel_method=panel_method)
    n = x.shape[0]
    tile = min(tile, n)
    n_pad = -(-n // tile) * tile
    auto_panel = panel_method is None
    if n_pad != n and panel_method is None:
        panel_method = "house"
    if use_mesh:
        return _mesh_singular_values(x, n, n_pad, tile, finish, panel_method, mesh)
    bd = fused_bdfac(_padded(x, n_pad), tile=tile, panel_method=panel_method, donate=True)
    if auto_panel and panel_method != "house" and not _frobenius_kept(x, bd):
        bd = fused_bdfac(_padded(x, n_pad), tile=tile, panel_method="house", donate=True)
    bd64 = to_numpy(bd).astype(np.float64)
    del bd
    if finish == "dense":
        s = np.linalg.svd(bd64, compute_uv=False)
    else:
        g = bd64.shape[0] // tile
        if g >= 2:
            r0, r1 = (g - 2) * tile, (g - 1) * tile
            s2, d2 = _tighten_corner_blocks(bd64[r0:r1, r1:], bd64[r1:, r1:])
            bd64[r0:r1, r1:] = s2
            bd64[r1:, r1:] = d2
            s = _band_sigma(bd64, max_band=tile, device=x.device)
        else:
            s = _band_sigma(bd64, max_band=2 * tile, device=x.device)
    return s[:n]


def _dense_band(diags, sups, n: int, t: int) -> np.ndarray:
    bd = np.zeros((n, n), np.float64)
    for k, d in enumerate(diags):
        bd[k * t:(k + 1) * t, k * t:(k + 1) * t] = d
        if sups[k] is not None:
            bd[k * t:(k + 1) * t, (k + 1) * t:(k + 2) * t] = sups[k]
    return bd


def _mesh_singular_values(x, n: int, n_pad: int, tile: int, finish: str, panel_method,
                          mesh) -> np.ndarray:
    """singular_values' mesh route (see there): the distributed BDFAC's band
    blocks, the Frobenius invariant, then the reference's finish."""
    from numpywren_tpu_torch.models.band import band_sigma_packed
    from numpywren_tpu_torch.parallel.fabric import bdfac_1d, bdfac_2d

    if n_pad != n:
        raise ValueError(
            f"mesh-distributed singular_values needs n ({n}) to be a multiple of tile "
            f"({tile}): zero-padding would make the trailing panels rank-deficient, which the "
            "distributed CholeskyQR panels cannot factor")
    if panel_method is not None:
        raise ValueError(
            f"panel_method={panel_method!r} is not supported on the mesh-distributed path "
            "(the distributed BDFAC factors panels by shifted CholeskyQR only); use the "
            "single-device path for inputs that need Householder panels")
    reduce_fn = bdfac_2d if min(mesh.shape) > 1 else bdfac_1d
    diags, sups = reduce_fn(x, mesh=mesh, tile=tile, return_band=True)
    na = float(torch.linalg.norm(torch.as_tensor(x).double()))
    nb_ = float(np.sqrt(sum(float(np.sum(np.square(b, dtype=np.float64)))
                            for b in diags + [s for s in sups if s is not None])))
    if not np.isfinite(nb_) or abs(nb_ - na) > 1e-3 * max(na, 1e-30):
        raise RuntimeError(
            f"distributed BDFAC lost the Frobenius-norm invariant (||A||={na:.6g} vs "
            f"||B||={nb_:.6g}): the input is too ill-conditioned or rank-deficient for "
            "CholeskyQR panels; run without mesh= for the rank-safe single-device path")
    if finish == "dense":
        return np.linalg.svd(_dense_band(diags, sups, n, tile), compute_uv=False)[:n]
    ab, nn, ku = _packed_band_from_lists(diags, sups, n, tile)
    try:
        return band_sigma_packed(ab, nn, nn, 0, ku)[:n]
    except RuntimeError:
        return _gk_band_sigma(_dense_band(diags, sups, n, tile), max_band=2 * tile)[:n]


def _route_default_method(shape, platform: str = None) -> str:
    """svd(method=None) routing, the reference's rule as it is: large
    with-vectors inputs on a TPU go to the block-Jacobi path, everything
    else (every platform of this port: a torch device type, "cuda" or
    "cpu"; None is this process's) to "bdfac". The H100's own choice among
    "bdfac", "jacobi" and "qdwh" is measured (PERF.md) but not decided."""
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
    for rectangular x: U (m, k), Vt (k, n), k = min(m, n)).

    method: "bdfac" (and None, which routes there off a TPU,
    `_route_default_method`) runs the fused BDFAC with accumulate=True on
    x's device (A = P B Qᵀ, each panel reflector also applied to P and Q at
    accum_precision, default "highest": the matmul kernel; None runs them
    at `precision`, the sweeps'), then an fp64 host SVD of B
    (uv_finish="host") and U = P Ub, Vt = Vbᵀ Qᵀ. A rectangular x is first
    reduced by one CholeskyQR chain (U = Q Ur). An unpadded square whose
    CholeskyQR sweep breaks ||B||_F = ||A||_F reruns with Householder
    panels; a padded one (n not a multiple of tile) takes them at once.
    refine (None: 0 off a TPU, as the reference decides) runs that many
    `svd_refine` steps on the factors. "jacobi" runs models.svd_jacobi
    (block = min(tile, 512)) on x's device and refines inside it. "qdwh"
    runs `_qdwh_svd` on x (a wide x by its transpose), sorted on the host
    as the reference sorts. uv_finish="device" takes the SVD of B by
    `_qdwh_svd` on the device instead of the host's fp64 SVD. Tiled inputs
    are materialized (`utils.get_local_matrix`) and run on the matrix's
    device.

    Caveat (padded and rank-deficient, as in the reference): singular
    vectors of ZERO singular values may have support in the padding, so
    the cropped U, Vt columns for them are not guaranteed orthonormal."""
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
    refine = 0 if refine is None else int(refine)
    if method is None:
        method = _route_default_method(tuple(x.shape), x.device.type)
    dt = np_dtype(x.dtype)
    if method == "jacobi":
        from numpywren_tpu_torch.models.jacobi import svd_jacobi

        u, s, vt = svd_jacobi(x.float(), block=min(tile, 512), precision=precision)
        return tuple(to_numpy(a).astype(dt) for a in (u, s, vt))
    if method == "qdwh":
        if x.shape[0] < x.shape[1]:
            u, s, vt = svd(x.T, method="qdwh")
            return vt.T, s, u.T
        u, s, vt = map(to_numpy, _qdwh_svd(x.float(), compute_uv=True))
        order = np.argsort(s)[::-1]
        return u[:, order].astype(dt), s[order].astype(dt), vt[order].astype(dt)
    if uv_finish not in ("host", "device"):
        raise ValueError(f"unknown uv_finish {uv_finish!r}")
    from numpywren_tpu_torch.compiler.lower import fused_bdfac, fused_tsqr

    kw = dict(tile=tile, panel_method=panel_method, precision=precision,
              accum_precision=accum_precision, method=method, uv_finish=uv_finish,
              refine=refine)
    m, n = x.shape
    if m < n:
        u, s, vt = svd(x.T, **kw)
        return vt.T, s, u.T
    if m > n:
        q, r = fused_tsqr(x.float(), tile_rows=m, compute_q=True, method="cholqr3s",
                          precision=precision)
        ur, s, vt = svd(r, **kw)
        u = q @ torch.as_tensor(ur, dtype=q.dtype, device=q.device)
        return to_numpy(u).astype(dt), s, vt

    tile = min(tile, n)
    n_pad = -(-n // tile) * tile
    auto_panel = panel_method is None
    if n_pad != n and panel_method is None:
        panel_method = "house"

    def run(pm):
        return fused_bdfac(_padded(x, n_pad), tile=tile, panel_method=pm, donate=True,
                           accumulate=True, precision=precision,
                           accum_precision=accum_precision)

    bd, p, q = run(panel_method)
    if auto_panel and panel_method != "house" and not _frobenius_kept(x, bd):
        bd, p, q = run("house")
    if uv_finish == "device":
        ub, s_dev, vbt = _qdwh_svd(bd)
        s = to_numpy(s_dev)
        order = np.argsort(s)[::-1]
        s = s[order].astype(np.float64)
        idx = torch.as_tensor(order.copy(), device=bd.device)
        ub, vbt = ub[:, idx], vbt[idx]
    else:
        ub, s, vbt = np.linalg.svd(to_numpy(bd).astype(np.float64))
        ub = torch.as_tensor(ub.astype(np.float32), device=p.device)
        vbt = torch.as_tensor(vbt.astype(np.float32), device=q.device)
    u = p @ ub
    vt = vbt @ q.T
    u, s_out, vt = u[:n, :n], s[:n], vt[:n, :n]
    if refine:
        from numpywren_tpu_torch.models.jacobi import svd_refine

        u, s_out, vt = svd_refine(x.float(), u, torch.as_tensor(s_out, dtype=torch.float32),
                                  vt, steps=refine)
    return to_numpy(u).astype(dt), np.asarray(to_numpy(s_out), dtype=dt), to_numpy(vt).astype(dt)


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
