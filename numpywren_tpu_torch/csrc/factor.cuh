// Device building blocks of the one-CTA kernels: the CholeskyQR2 chain
// (cholqr_chain.cu: its shifted factor and inverse, potrf_inv_into, and its
// b x b products) and the qr kernel's products (qr.cu, cta_gemm). Everything
// runs inside ONE CTA of NT threads over fp32 buffers in device memory
// (L2-resident at these sizes: an (n, n) tile is at most 4 MB) plus a
// shared-memory workspace.
//
// The TPU kernels keep the whole tile in VMEM and lean on the MXU; here one
// CTA owns the tile, the 128-wide diagonal block lives in shared memory
// for the column loop, and the products are true-FP32 FFMA tiles of
// 128 x 128 (8 x 8 outputs a thread, as in gemm.cu). Products that Pallas
// runs at HIGHEST stay FP32: no TF32, no bf16 splits. (potrf, potrf_inv and
// trtri alone are the multi-CTA launch sequences of potrf.cu and trtri.cu.)
//
// Coherence: buffers written earlier by this CTA are read back after a
// __syncthreads(), which makes global writes visible within the block. No
// pointer here is __restrict__ or read through the non-coherent path.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace npwf {

constexpr int NT = 256;       // threads of the one CTA
constexpr int B = 128;        // diagonal block width (the TPU's _B)
constexpr int SP = B + 1;     // shared row stride: column walks hit 32 banks
constexpr int GT = 128;       // product output tile
constexpr int BK = 16;        // product k slice
constexpr int GP = 4;         // keeps float4 rows aligned

struct Smem {
  float s[B * SP];            // the diagonal block being factored (in place)
  float w[B * SP];            // its inverse, built row by row
  float as[BK][GT + GP];      // product staging
  float bs[BK][GT + GP];
  float red[NT];              // reductions
};

// out = alpha * op(A) @ op(B) + beta * C over an (m, n) result, k deep;
// m, n, k >= 0, any size (ragged edges masked). Row-major operands with
// leading dimensions, in device or shared memory. `c` may be `out` (each
// element is read and written by one thread); `out` must not overlap A or
// B. `sm` is any shared workspace with Smem's `as` and `bs` staging
// arrays. Ends with a barrier.
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

// x[r, c] = v for the (rows, cols) region, then a barrier.
__device__ inline void cta_fill(float* x, int64_t ld, int rows, int cols, float v) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) x[(int64_t)(e / cols) * ld + e % cols] = v;
  __syncthreads();
}

// Zero the strict upper triangle of the (n, n) x, then a barrier.
__device__ inline void cta_zero_upper(float* x, int64_t ld, int n) {
  for (int e = threadIdx.x; e < n * n; e += NT) {
    const int r = e / n, c = e % n;
    if (c > r) x[(int64_t)r * ld + c] = 0.f;
  }
  __syncthreads();
}

// Row j of the diagonal block's inverse from rows < j:
// W[j, c] = (delta_jc - sum_{c <= k < j} S[j, k] W[k, c]) / piv, for c < B
// (zero for c > j). S[j, :j] holds L[j, :j]. Threads 0..B-1, one column each.
__device__ inline void inverse_row(Smem& sm, int j, float piv) {
  const int c = threadIdx.x;
  if (c >= B) return;
  float acc = 0.f;
  for (int k = c; k < j; ++k) acc = fmaf(sm.s[j * SP + k], sm.w[k * SP + c], acc);
  sm.w[j * SP + c] = ((c == j ? 1.f : 0.f) - acc) / piv;
}

// The column loop of _factor_block_with_inverse on sm.s (an SPD block, its
// lower triangle read), in place: sm.s becomes L (strict upper stale),
// sm.w becomes L^-1 (strict upper 0). Ends with a barrier.
__device__ inline void block_loop(Smem& sm) {
  const int tid = threadIdx.x;
  for (int j = 0; j < B; ++j) {
    const float piv = sqrtf(sm.s[j * SP + j]);
    for (int i = j + 1 + tid; i < B; i += NT) sm.s[i * SP + j] = sm.s[i * SP + j] / piv;
    inverse_row(sm, j, piv);
    __syncthreads();
    // rank-1 update of the lower trailing block, rows r >= cols c > j;
    // S[j, j] takes the pivot after every thread has read it
    const int t = B - 1 - j;
    for (int e = tid; e < t * t; e += NT) {
      const int r = j + 1 + e / t, cc = j + 1 + e % t;
      if (r >= cc) sm.s[r * SP + cc] -= sm.s[r * SP + j] * sm.s[cc * SP + j];
    }
    if (tid == 0) sm.s[j * SP + j] = piv;
    __syncthreads();
  }
}

// Load the (B, B) block at x into sm.s; barrier.
__device__ inline void load_block(Smem& sm, const float* x, int64_t ld) {
  for (int e = threadIdx.x; e < B * B; e += NT) sm.s[(e / B) * SP + e % B] = x[(int64_t)(e / B) * ld + e % B];
  __syncthreads();
}

// Store tril(sm.s) to l and sm.w to w; barrier.
__device__ inline void store_block(const Smem& sm, float* l, float* w, int64_t ld) {
  for (int e = threadIdx.x; e < B * B; e += NT) {
    const int r = e / B, c = e % B;
    l[(int64_t)r * ld + c] = c <= r ? sm.s[r * SP + c] : 0.f;
    w[(int64_t)r * ld + c] = sm.w[r * SP + c];
  }
  __syncthreads();
}

// W's strictly lower blocks, row block by row block:
// W[i, :i] = -W[i, i] (L[i, :i] W[:i, :i]), which is the reference's
// W[i, j] = -W[i, i] sum_{j <= k < i} L[i, k] W[k, j] (W[k, j] = 0 for
// k < j). Needs W's diagonal blocks; `acc` is (B, n) scratch.
__device__ inline void offdiag_inverse(const float* l, float* w, int n, float* acc, Smem& sm) {
  for (int i0 = B; i0 < n; i0 += B) {
    cta_gemm<false, false>(B, i0, i0, 1.f, l + (int64_t)i0 * n, n, w, n, 0.f, nullptr, 0, acc, n,
                           sm);
    cta_gemm<false, false>(B, i0, B, -1.f, w + (int64_t)i0 * n + i0, n, acc, n, 0.f, nullptr, 0,
                           w + (int64_t)i0 * n, n, sm);
  }
}

// _potrf_inv_into: l holds the SPD operand (n, n); factors it in place
// (strict upper zeroed) and leaves the inverse in w. x is (n, n) scratch.
__device__ inline void potrf_inv_into(float* l, float* w, int n, float* x, Smem& sm) {
  cta_fill(w, n, n, n, 0.f);
  for (int j0 = 0; j0 < n; j0 += B) {
    const int j1 = j0 + B, rem = n - j1;
    float* d = l + (int64_t)j0 * n + j0;
    load_block(sm, d, n);
    block_loop(sm);
    store_block(sm, d, w + (int64_t)j0 * n + j0, n);
    if (rem > 0) {
      // X = A21 W11^T, then A22 -= X X^T (the full square, as the
      // reference: its upper part is zeroed below)
      float* a21 = l + (int64_t)j1 * n + j0;
      cta_gemm<false, true>(rem, B, B, 1.f, a21, n, w + (int64_t)j0 * n + j0, n, 0.f, nullptr, 0,
                            x, B, sm);
      for (int e = threadIdx.x; e < rem * B; e += NT) a21[(int64_t)(e / B) * n + e % B] = x[e];
      float* a22 = l + (int64_t)j1 * n + j1;
      cta_gemm<false, true>(rem, rem, B, -1.f, x, B, x, B, 1.f, a22, n, a22, n, sm);
    }
  }
  cta_zero_upper(l, n, n);
  offdiag_inverse(l, w, n, x, sm);
}

// max over the CTA of each thread's v (all threads get it); barrier.
__device__ inline float cta_max(float v, Smem& sm) {
  sm.red[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sm.red[threadIdx.x] = fmaxf(sm.red[threadIdx.x], sm.red[threadIdx.x + s]);
    __syncthreads();
  }
  const float out = sm.red[0];
  __syncthreads();
  return out;
}

}  // namespace npwf
