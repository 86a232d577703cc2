"""The multi-device dry run: every path of the multi-device layer once, at
small sizes, on the caller's mesh, each held to its bar.

Counterpart of the JAX package's ``dryrun_multichip`` body
(__graft_entry__.py), its ten stages at its sizes (tile 64,
n = 64 * max(r, c) * 2) and with its bars:

 1. sharded_cholesky      residual <= 1e-4
 2. sharded_gemm          against numpy, rtol 1e-3, atol 1e-2
 3. sharded_tsqr          RᵀR against XᵀX, rtol 1e-3, atol 1e-2
 4. summa_gemm on the largest square sub-mesh, tsqr_butterfly and
    cholqr2_sharded on the first 2^k ranks (a 1 x 2^k mesh), as 2-3
 5. cholesky_1d with lookahead    residual <= 1e-4
 6. cholesky_2d with lookahead    residual <= 1e-4
 7. tsqr_butterfly over every rank, b_fac 4
 8. bdfac_1d and bdfac_2d  sigma(B) against numpy's, rtol 2e-3,
    atol 2e-3 sigma_max
 9. out_of_core_cholesky(mesh=)   residual <= 1e-4
10. out_of_core_bdfac(mesh=)      sigma as 8

The mesh comes from an initialized process group; there is no
re-executed subprocess. Every rank of the default group calls
`dryrun_multichip` with the same mesh, which spans them all (the
sub-meshes of stage 4 are made collectively).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from numpywren_tpu_torch.parallel.mesh import make_mesh


def _np(x) -> np.ndarray:
    """A result as an ndarray on this rank: a DTensor's global value (a
    collective), a tensor's, a host tier's."""
    from numpywren_tpu_torch.parallel.distributed import full_tensor

    if isinstance(x, DTensor):
        x = full_tensor(x)
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return x.numpy() if hasattr(x, "get_block") else np.asarray(x)


def _residual(a: np.ndarray, l: np.ndarray) -> float:
    l = np.tril(l).astype(np.float64)
    return float(np.linalg.norm(a - l @ l.T) / np.linalg.norm(a))


def _require_residual(stage: str, a, l, out: dict) -> None:
    out[stage] = _residual(a, l)
    if not out[stage] < 1e-4:
        raise AssertionError(f"{stage}: residual {out[stage]}")


def _require_gram(stage: str, r, x, out: dict) -> None:
    r = np.asarray(r, np.float32)
    np.testing.assert_allclose(r.T @ r, x.T @ x, rtol=1e-3, atol=1e-2, err_msg=stage)
    out[stage] = float(np.abs(r.T @ r - x.T @ x).max())


def _require_sigma(stage: str, b, s_ref, out: dict) -> None:
    s = np.linalg.svd(np.asarray(b, np.float64), compute_uv=False)
    np.testing.assert_allclose(s, s_ref, rtol=2e-3, atol=2e-3 * s_ref[0], err_msg=stage)
    out[stage] = float(np.abs(s - s_ref).max() / s_ref[0])


def dryrun_multichip(mesh: Optional[DeviceMesh] = None) -> dict:
    """The ten stages on `mesh` (default: make_mesh() over every rank).
    Returns {stage: its number} (a residual, a largest error or sigma's
    error over sigma_max) on every rank, the sub-mesh stages on their ranks
    alone; a stage past its bar raises AssertionError. Collective over the
    default group."""
    from numpywren_tpu_torch.matrix_init import random_spd, shard_matrix
    from numpywren_tpu_torch.parallel.fabric import (bdfac_1d, bdfac_2d, cholesky_1d,
                                                     cholesky_2d, cholqr2_sharded, summa_gemm,
                                                     tsqr_butterfly)
    from numpywren_tpu_torch.parallel.mesh import mesh_device
    from numpywren_tpu_torch.parallel.sharded import sharded_cholesky, sharded_gemm, sharded_tsqr
    from numpywren_tpu_torch.runtime.spill import out_of_core_bdfac, out_of_core_cholesky

    mesh = mesh or make_mesh()
    ranks = mesh.mesh.reshape(-1).tolist()
    me = mesh.get_rank()
    n_devices = len(ranks)
    dev = mesh_device(mesh)
    kind = "cpu" if dev.type == "cpu" else None
    r, c = mesh.shape
    tile = 64
    n = tile * max(r, c) * 2  # at least 2 tiles per mesh axis
    out = {}

    # 1) sharded Cholesky
    a = random_spd(n, seed=0)
    _require_residual("1_sharded_cholesky", a, _np(sharded_cholesky(a, tile=tile, mesh=mesh)), out)

    # 2) sharded GEMM
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, n)).astype(np.float32)
    y = rng.standard_normal((n, n)).astype(np.float32)
    z = _np(sharded_gemm(x, y, mesh=mesh))
    np.testing.assert_allclose(z, x @ y, rtol=1e-3, atol=1e-2, err_msg="2_sharded_gemm")
    out["2_sharded_gemm"] = float(np.abs(z - x @ y).max())

    # 3) sharded TSQR over the tall axis
    t = rng.standard_normal((n_devices * 2 * tile, 32)).astype(np.float32)
    _require_gram("3_sharded_tsqr", _np(sharded_tsqr(t, tile_rows=tile, mesh=mesh)), t, out)

    # 4) SUMMA on the largest square sub-mesh; the butterfly TSQR and
    #    CholeskyQR2 on the first 2^k ranks (each sub-mesh made on every rank)
    s = math.isqrt(n_devices)
    sq_mesh = make_mesh(devices=ranks[:s * s], shape=(s, s), device=kind)
    p2 = 1 << (n_devices.bit_length() - 1)
    bf_mesh = make_mesh(devices=ranks[:p2], shape=(1, p2), device=kind)
    if me in ranks[:s * s]:
        xs, ys = x[:s * 64, :s * 64], y[:s * 64, :s * 64]
        z2 = _np(summa_gemm(xs, ys, mesh=sq_mesh))
        np.testing.assert_allclose(z2, xs @ ys, rtol=1e-3, atol=1e-2, err_msg="4_summa_gemm")
        out["4_summa_gemm"] = float(np.abs(z2 - xs @ ys).max())
    if me in ranks[:p2]:
        tb = t[:p2 * tile]
        _require_gram("4_tsqr_butterfly", _np(tsqr_butterfly(tb, mesh=bf_mesh)), tb, out)
        _require_gram("4_cholqr2_sharded", _np(cholqr2_sharded(tb, mesh=bf_mesh)), tb, out)

    # 5-6) block-cyclic explicit-collective Cholesky with lookahead, 1-D and 2-D
    _require_residual("5_cholesky_1d", a,
                      _np(cholesky_1d(a, mesh=mesh, panel=tile, lookahead=True)), out)
    _require_residual("6_cholesky_2d", a,
                      _np(cholesky_2d(a, mesh=mesh, panel=tile, lookahead=True)), out)

    # 7) k-ary butterfly TSQR across every rank
    tt = t[:n_devices * tile]
    _require_gram("7_tsqr_butterfly_kary",
                  _np(tsqr_butterfly(tt, mesh=mesh, b_fac=4)), tt, out)

    # 8) the distributed BDFAC, 1-D and 2-D
    g = np.asarray(rng.standard_normal((n, n)), np.float32)
    s_ref = np.linalg.svd(g.astype(np.float64), compute_uv=False)
    _require_sigma("8_bdfac_1d", _np(bdfac_1d(g, mesh=mesh, tile=tile)), s_ref, out)
    _require_sigma("8_bdfac_2d", _np(bdfac_2d(g, mesh=mesh, tile=tile)), s_ref, out)

    # 9) the host-spill tier on the mesh: out-of-core Cholesky
    at = shard_matrix(a, tile=(tile, tile), storage="host", device=dev)
    _require_residual("9_out_of_core_cholesky", a,
                      _np(out_of_core_cholesky(at, panel_tiles=2, mesh=mesh)), out)

    # 10) the out-of-core SVD stage 1 on the mesh
    gt = shard_matrix(g, tile=(tile, tile), storage="host", device=dev)
    _require_sigma("10_out_of_core_bdfac", _np(out_of_core_bdfac(gt, panel_tiles=2, mesh=mesh)),
                   s_ref, out)
    return out

