// out = alpha * op(A) @ op(B) + beta * C in true FP32, on the CUDA cores.
//
// The FP32 product engine that potrf.cu's launch sequence and the CholeskyQR2
// chain's b x b products (cholqr_chain.cu) call from C; their plain versions
// are fp32 and their error bars were set on this kernel. It is no longer the kernel of
// ops/gemm.py::matmul: the Pallas kernel there (numpywren_tpu/ops/gemm.py,
// _mm_kernel) computes HIGHEST as a bf16x6 split on the MXU, which
// gemm_split.cu does on the tensor cores, under this kernel's FFMA bound.
//
// Bound: FP32 FFMA issue (67 TFLOP/s on an H100 SXM). At the Cholesky's
// shapes (K = 128..1024) a 128 x 128 output tile reads 2 * 128 * K inputs for
// 2 * 128 * 128 * K flops, 64 flops per loaded float, far above the card's
// ~5 flops per byte of device memory, so the inner loop must stay on
// registers: each of the 256 threads owns an 8 x 8 accumulator and reads four
// float4s from shared memory for 64 FFMAs per k.
//
// Design:
// - 128 registers a thread (launch bounds), so two 256-thread blocks share
//   an SM; at 167 registers and one block it ran ~20% slower.
// - 2-D grid of 128 x 128 output tiles; a loop over K in 16-deep slices
//   replaces Pallas's sequential "arbitrary" K axis, and registers replace
//   its VMEM accumulator. Shared memory is double-buffered and the next
//   slice is fetched into registers while the current one is multiplied.
// - op(A) and op(B) are index arithmetic on leading dimensions (unit column
//   stride), so strided column slices need no copy. Ragged M, N and K are
//   masked: zeros load, out-of-range outputs are not stored.
// - bf16 inputs widen to fp32 on load and accumulate in fp32.
// - The epilogue alpha * acc + beta * C is fused. `out` may alias `c`: each
//   output element is read from C and written by the same thread, once.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int NT = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int PAD = 4;   // keeps float4 rows aligned and staggers the banks
constexpr int A_PER_T = BM * BK / NT;
constexpr int B_PER_T = BN * BK / NT;

// (mm, kk) of the i-th element this thread moves for op(A), an M x K tile.
template <bool TA>
__device__ __forceinline__ void a_coord(int tid, int i, int& mm, int& kk) {
  const int e = tid + i * NT;
  if (TA) {  // A is K x M in memory: walk M fastest
    mm = e % BM;
    kk = e / BM;
  } else {  // A is M x K: walk K fastest
    kk = e % BK;
    mm = e / BK;
  }
}

// (kk, nn) of the i-th element this thread moves for op(B), a K x N tile.
template <bool TB>
__device__ __forceinline__ void b_coord(int tid, int i, int& kk, int& nn) {
  const int e = tid + i * NT;
  if (TB) {  // B is N x K in memory
    kk = e % BK;
    nn = e / BK;
  } else {  // B is K x N
    nn = e % BN;
    kk = e / BN;
  }
}

template <typename TIn, bool TA, bool TB>
__device__ __forceinline__ void load_tiles(const TIn* __restrict__ a, int64_t lda,
                                           const TIn* __restrict__ b, int64_t ldb, int m,
                                           int n, int k, int m0, int n0, int k0, int tid,
                                           float (&ra)[A_PER_T], float (&rb)[B_PER_T]) {
#pragma unroll
  for (int i = 0; i < A_PER_T; ++i) {
    int mm, kk;
    a_coord<TA>(tid, i, mm, kk);
    const int row = m0 + mm, col = k0 + kk;
    ra[i] = (row < m && col < k)
                ? npw::to_f32(TA ? a[(int64_t)col * lda + row] : a[(int64_t)row * lda + col])
                : 0.f;
  }
#pragma unroll
  for (int i = 0; i < B_PER_T; ++i) {
    int kk, nn;
    b_coord<TB>(tid, i, kk, nn);
    const int row = k0 + kk, col = n0 + nn;
    rb[i] = (row < k && col < n)
                ? npw::to_f32(TB ? b[(int64_t)col * ldb + row] : b[(int64_t)row * ldb + col])
                : 0.f;
  }
}

template <bool TA, bool TB>
__device__ __forceinline__ void store_tiles(float (*as)[BM + PAD], float (*bs)[BN + PAD],
                                            int tid, const float (&ra)[A_PER_T],
                                            const float (&rb)[B_PER_T]) {
#pragma unroll
  for (int i = 0; i < A_PER_T; ++i) {
    int mm, kk;
    a_coord<TA>(tid, i, mm, kk);
    as[kk][mm] = ra[i];
  }
#pragma unroll
  for (int i = 0; i < B_PER_T; ++i) {
    int kk, nn;
    b_coord<TB>(tid, i, kk, nn);
    bs[kk][nn] = rb[i];
  }
}

template <typename TIn, typename TOut, bool TA, bool TB>
__global__ void __launch_bounds__(NT, 2)
    gemm_kernel(const TIn* __restrict__ a, int64_t lda, const TIn* __restrict__ b, int64_t ldb,
                const TOut* c, int64_t ldc, TOut* out, int64_t ldo, int m, int n, int k,
                float alpha, float beta) {
  __shared__ __align__(16) float as[2][BK][BM + PAD];
  __shared__ __align__(16) float bs[2][BK][BN + PAD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (k + BK - 1) / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[A_PER_T], rb[B_PER_T];
  if (ktiles > 0) {
    load_tiles<TIn, TA, TB>(a, lda, b, ldb, m, n, k, m0, n0, 0, tid, ra, rb);
    store_tiles<TA, TB>(as[0], bs[0], tid, ra, rb);
    __syncthreads();
  }
  for (int t = 0; t < ktiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < ktiles;
    if (more) load_tiles<TIn, TA, TB>(a, lda, b, ldb, m, n, k, m0, n0, (t + 1) * BK, tid, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (more) store_tiles<TA, TB>(as[cur ^ 1], bs[cur ^ 1], tid, ra, rb);
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
      if (c != nullptr) v += beta * npw::to_f32(c[(int64_t)row * ldc + col]);
      out[(int64_t)row * ldo + col] = npw::from_f32<TOut>(v);
    }
  }
}

template <typename TIn, typename TOut>
void launch(int ta, int tb, const void* a, int64_t lda, const void* b, int64_t ldb, const void* c,
            int64_t ldc, void* out, int64_t ldo, int m, int n, int k, float alpha, float beta,
            cudaStream_t stream) {
  const dim3 grid(npw::cdiv(n, BN), npw::cdiv(m, BM));
#define NPW_GEMM_LAUNCH(TA_, TB_)                                                          \
  gemm_kernel<TIn, TOut, TA_, TB_><<<grid, NT, 0, stream>>>(                               \
      static_cast<const TIn*>(a), lda, static_cast<const TIn*>(b), ldb,                    \
      static_cast<const TOut*>(c), ldc, static_cast<TOut*>(out), ldo, m, n, k, alpha, beta)
  if (ta) {
    if (tb) NPW_GEMM_LAUNCH(true, true);
    else NPW_GEMM_LAUNCH(true, false);
  } else {
    if (tb) NPW_GEMM_LAUNCH(false, true);
    else NPW_GEMM_LAUNCH(false, false);
  }
#undef NPW_GEMM_LAUNCH
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// in_bf16 / out_bf16 select bf16 instead of fp32 for A, B and for C, out.
int npw_gemm(int in_bf16, int out_bf16, int ta, int tb, const void* a, long long lda,
             const void* b, long long ldb, const void* c, long long ldc, void* out,
             long long ldo, int m, int n, int k, float alpha, float beta, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (out_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(ta, tb, a, lda, b, ldb, c, ldc, out, ldo, m, n, k,
                                           alpha, beta, s);
    else
      launch<__nv_bfloat16, float>(ta, tb, a, lda, b, ldb, c, ldc, out, ldo, m, n, k, alpha,
                                   beta, s);
  } else {
    if (out_bf16)
      launch<float, __nv_bfloat16>(ta, tb, a, lda, b, ldb, c, ldc, out, ldo, m, n, k, alpha,
                                   beta, s);
    else
      launch<float, float>(ta, tb, a, lda, b, ldb, c, ldc, out, ldo, m, n, k, alpha, beta, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* npw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
