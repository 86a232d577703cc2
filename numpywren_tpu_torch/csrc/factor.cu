// potrf_inv and trtri of an (n, n) fp32 tile, 128 | n <= 1024.
//
// Replaces the Pallas kernels of numpywren_tpu/ops/pallas_factor.py:
// _potrf_inv_kernel (potrf_inv_pallas) and _trtri_kernel (trtri_pallas,
// and trsm_pallas through it). potrf_inv runs _potrf_inv_into: per 128-wide
// diagonal block the column loop of _factor_block_with_inverse (pivot,
// scaled column, the inverse's row (e_j - L[j, :j] W) / piv, rank-1
// update), then the below-panel solve X = A21 W11^T and the trailing update
// A22 -= X X^T; then the off-diagonal inverse blocks
// W[i, j] = -W[i, i] sum_k L[i, k] W[k, j]. trtri inverts each diagonal
// block by forward substitution and runs the same recurrence. The strict
// upper triangles of L and W are exactly 0. (potrf alone is potrf.cu.)
//
// Bound: the sequential depth of the column loop (n steps, two barriers
// each) and one SM's FP32 rate for the products (~1 GFLOP at n = 1024, of
// which the trailing updates and the inverse recurrence are nearly all).
// Design: ONE CTA of 256 threads owns the tile, as one TPU core owns it in
// VMEM. The diagonal block and its inverse sit in shared memory (2 x 64 KB)
// for the column loop; the tile, its inverse and a scratch square stay in
// device memory, where at <= 4 MB each they are L2-resident; the products
// are 128 x 128 FFMA tiles staged through shared memory (factor.cuh). One
// launch per call and no host synchronisation. potrf.cu's multi-CTA
// sequence and 32-wide diagonal step are the redesign these two take next.
#include "factor.cuh"

namespace {

__global__ void __launch_bounds__(npwf::NT, 1)
    factor_kernel(int mode, int n, const float* a, float* l, float* w, float* x) {
  extern __shared__ __align__(16) unsigned char raw[];
  npwf::Smem& sm = *reinterpret_cast<npwf::Smem*>(raw);
  if (mode == 1) {
    npwf::trtri_into(a, w, n, x, sm);
    return;
  }
  for (int e = threadIdx.x; e < n * n; e += npwf::NT) l[e] = a[e];
  __syncthreads();
  npwf::potrf_inv_into(l, w, n, x, sm);
}

}  // namespace

extern "C" {

// mode 0 potrf_inv (l, w), 1 trtri (a is the lower factor; w; l unused).
// l, w, scratch are (n, n) fp32, row-major, not overlapping a. Returns
// cudaGetLastError().
int npw_factor(int mode, int n, const void* a, void* l, void* w, void* scratch, void* stream) {
  if (n <= 0) return 0;
  const int smem = static_cast<int>(sizeof(npwf::Smem));
  cudaError_t err =
      cudaFuncSetAttribute(factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factor_kernel<<<1, npwf::NT, smem, static_cast<cudaStream_t>(stream)>>>(
      mode, n, static_cast<const float*>(a), static_cast<float*>(l), static_cast<float*>(w),
      static_cast<float*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
