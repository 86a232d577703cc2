"""Model families of the port = the blocked linear-algebra algorithms.

Counterpart of numpywren_tpu/models (the reference's "model zoo" is its
algorithm library). The factorizations, each returning (program,
output_matrix/es, meta) to run with `run_program`:

- cholesky: SPD factorization A = L Lᵀ
- gemm:     C = A @ B
- tsqr:     tall-skinny QR (tree, CholeskyQR2, shifted CholeskyQR3)
- bdfac:    block bidiagonalization (SVD stage 1)

On top of them, the finished end-user models:

- svd.singular_values:    all singular values, two-stage (the fused BDFAC
                          on the device, then the band narrowed by
                          band_reduce and finished by host LAPACK, band.py)
- svd.svd:                full SVD; method "bdfac" (None routes there off a
                          TPU) accumulates the BDFAC's transforms and
                          finishes on the host (or by QDWH on the device,
                          uv_finish="device"), "jacobi" runs svd_jacobi,
                          "qdwh" runs qdwh.svd (also
                          singular_values(finish="qdwh"))
- qdwh.qdwh, qdwh.svd:    QDWH polar decomposition and the thin SVD on it
                          (polar + eigh of h, all on the device)

- jacobi.svd_jacobi:      full SVD entirely on device (one-sided block
                          Jacobi: batched pair Grams + batched small eighs +
                          product rotations); also svd(method="jacobi")
- jacobi.svd_refine:      Ogita-Aishima-style refinement of any thin SVD
- svd.svd_tall:           thin SVD of tall-skinny matrices (CholeskyQR)
- svd.randomized_svd:     rank-k truncated SVD (HMT sketch + power iteration)
- lstsq.least_squares:    tall least squares (CholeskyQR or normal equations)
- lstsq.ridge_regression: Tikhonov-regularized solve
- pca.pca:                principal components

Each takes ``device=None``: a tensor stays where it is, an ndarray goes to
the current CUDA device (a host without one raises; pass device="cpu" to
run the plain PyTorch versions). svd_jacobi and svd_refine return tensors
on the input's device, the others ndarrays, as in the reference.

`singular_values(mesh=)` on a mesh of more than one device runs stage 1
as the distributed BDFAC (parallel.fabric.bdfac_1d / bdfac_2d).
"""

from numpywren_tpu_torch.alg_wrappers import bdfac, cholesky, gemm, tsqr, tsqr_r_factor
from numpywren_tpu_torch.models.jacobi import svd_jacobi, svd_refine
from numpywren_tpu_torch.models.lstsq import least_squares, ridge_regression
from numpywren_tpu_torch.models.pca import pca
from numpywren_tpu_torch.models.svd import (
    randomized_svd,
    singular_values,
    svd,
    svd_tall,
)

__all__ = [
    "cholesky", "gemm", "tsqr", "bdfac", "tsqr_r_factor",
    "singular_values", "svd", "svd_jacobi", "svd_refine", "svd_tall",
    "randomized_svd", "least_squares", "ridge_regression", "pca",
]
