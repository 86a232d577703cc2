// Device building blocks of the one-CTA products of the qr kernel (qr.cu):
// cta_gemm, true-FP32 FFMA tiles of 128 x 128 (8 x 8 outputs a thread, as
// in gemm.cu) run by ONE CTA of NT threads over fp32 buffers in device or
// shared memory, and the shared row stride of qr.cu's 128-wide blocks.
// Products that Pallas runs at HIGHEST stay FP32: no TF32, no bf16 splits.
// (potrf, potrf_inv, trtri and the CholeskyQR2 chain's step 0 are the
// multi-CTA launch sequences of potrf.cu, trtri.cu and cholqr_chain.cu.)
//
// Coherence: buffers written earlier by this CTA are read back after a
// __syncthreads(), which makes global writes visible within the block. No
// pointer here is __restrict__ or read through the non-coherent path.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace npwf {

constexpr int NT = 256;       // threads of the one CTA
constexpr int B = 128;        // qr.cu's panel width (the TPU's _B)
constexpr int SP = B + 1;     // shared row stride: column walks hit 32 banks
constexpr int GT = 128;       // product output tile
constexpr int BK = 16;        // product k slice
constexpr int GP = 4;         // keeps float4 rows aligned

// out = alpha * op(A) @ op(B) + beta * C over an (m, n) result, k deep;
// m, n, k >= 0, any size (ragged edges masked). Row-major operands with
// leading dimensions, in device or shared memory. `c` may be `out` (each
// element is read and written by one thread); `out` must not overlap A or
// B. `sm` is any shared workspace with `as` and `bs` staging arrays of
// [BK][GT + GP] floats. Ends with a barrier.
template <bool TA, bool TB, class SM>
__device__ void cta_gemm(int m, int n, int k, float alpha, const float* a, int64_t lda,
                         const float* b, int64_t ldb, float beta, const float* c, int64_t ldc,
                         float* out, int64_t ldo, SM& sm) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int m0 = 0; m0 < m; m0 += GT) {
    for (int n0 = 0; n0 < n; n0 += GT) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
        for (int i = 0; i < GT * BK / NT; ++i) {
          const int e = tid + i * NT;
          int mm, kk;
          if (TA) { mm = e % GT; kk = e / GT; } else { kk = e % BK; mm = e / BK; }
          const int row = m0 + mm, col = k0 + kk;
          sm.as[kk][mm] = (row < m && col < k)
                              ? (TA ? a[(int64_t)col * lda + row] : a[(int64_t)row * lda + col])
                              : 0.f;
          int nn;
          if (TB) { kk = e % BK; nn = e / BK; } else { nn = e % GT; kk = e / GT; }
          const int brow = k0 + kk, bcol = n0 + nn;
          sm.bs[kk][nn] = (brow < k && bcol < n)
                              ? (TB ? b[(int64_t)bcol * ldb + brow] : b[(int64_t)brow * ldb + bcol])
                              : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&sm.as[kk][ty * 4]);
          const float4 a1 = *reinterpret_cast<const float4*>(&sm.as[kk][64 + ty * 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&sm.bs[kk][tx * 4]);
          const float4 b1 = *reinterpret_cast<const float4*>(&sm.bs[kk][64 + tx * 4]);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
          if (col >= n) continue;
          float v = alpha * acc[i][j];
          if (c != nullptr) v += beta * c[(int64_t)row * ldc + col];
          out[(int64_t)row * ldo + col] = v;
        }
      }
    }
  }
  __syncthreads();
}

}  // namespace npwf
