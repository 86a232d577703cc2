// CholeskyQR2 passes 1-2 of compiler.lower._cholqr_adaptive: one launch for
// the (b, b) algebra, then the apply of the folded inverse to the tall
// operand. fp32, 128 | b <= 256.
//
// Replaces the Pallas kernel numpywren_tpu/ops/pallas_factor.py::
// _cholqr2_chain_kernel (cholqr2_chain_pallas). Its grid step 0 becomes
// the step-0 kernel below, one CTA, with the three (b, b) VMEM scratch
// buffers (and the temporaries the TPU kept as values) in device scratch:
// at b = 256 each is 256 KB, too large for shared memory together and
// L2-resident as a whole. In order:
//   rs_g = max row sum |g|, floor = shift_c rs_g, (L1, W1) of g + floor I
//   (_potrf_inv_into, unsymmetrized as the reference passes it);
//   E2 = -floor W1 W1^T and dev2 = max |E2| (the analytic pass-2 Gram);
//   the fold, chosen ON THE DEVICE: dev2 < 0.1 takes the Neumann cleanup
//   (M = tril(E2, -1) + diag(E2)/2, li2 = (I + M^2)(I - M),
//   l2 = (I + M^4)(I + M)), else the identity (the caller's extras passes
//   converge the panel);
//   linv = li2 W1, total = L1 l2 (rows) or l2^T L1^T (columns),
//   stat = (dev2, dev2 < conv_gate).
// The grid steps >= 1 that streamed the operand through VMEM become one
// launch of the FFMA matmul kernel (gemm.cu) on the same stream, in true
// FP32 as the Pallas kernel coerces HIGH to HIGHEST: q = p linv^T
// (columns) or q = linv p (rows). No host synchronisation: conv and dev2
// stay on the device for the caller to read once.
//
// Bound: the apply is (2 m b^2 flops, 2 m b x 4 bytes); at m = 2^20,
// b = 256 it is FP32-FFMA-bound (2.1 ms at 67 TFLOP/s). Step 0 is one SM's
// work (~0.24 GFLOP of b x b products at b = 256) on the critical path
// before the apply can start.
#include "factor.cuh"

extern "C" int npw_gemm(int in_bf16, int out_bf16, int ta, int tb, const void* a, long long lda,
                        const void* b, long long ldb, const void* c, long long ldc, void* out,
                        long long ldo, int m, int n, int k, float alpha, float beta,
                        void* stream);

namespace {

using npwf::NT;

// scratch: twelve (b, b) buffers, in this order
enum { L1, W1, E2, MM, M2, IP2, LI2, M4, IPM, L2, LINV, X, NBUF };

// x = y + v I over (b, b); barrier.
__device__ void plus_identity(float* x, const float* y, int b, float v) {
  for (int e = threadIdx.x; e < b * b; e += NT) x[e] = y[e] + (e / b == e % b ? v : 0.f);
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1)
    chain_step0(const float* g, int b, int rows, float shift_c, float conv_gate, float* total,
                float* stat, float* scr) {
  extern __shared__ __align__(16) unsigned char raw[];
  npwf::Smem& sm = *reinterpret_cast<npwf::Smem*>(raw);
  const int64_t bb = static_cast<int64_t>(b) * b;
  float* buf[NBUF];
  for (int i = 0; i < NBUF; ++i) buf[i] = scr + i * bb;

  float rs = 0.f;
  for (int r = threadIdx.x; r < b; r += NT) {
    float s = 0.f;
    for (int c = 0; c < b; ++c) s += fabsf(g[(int64_t)r * b + c]);
    rs = fmaxf(rs, s);
  }
  const float shift = shift_c * npwf::cta_max(rs, sm);  // the reference's `floor`
  plus_identity(buf[L1], g, b, shift);
  npwf::potrf_inv_into(buf[L1], buf[W1], b, buf[X], sm);

  npwf::cta_gemm<false, true>(b, b, b, -shift, buf[W1], b, buf[W1], b, 0.f, nullptr, 0, buf[E2], b,
                              sm);
  float dev = 0.f;
  for (int e = threadIdx.x; e < bb; e += NT) dev = fmaxf(dev, fabsf(buf[E2][e]));
  const float dev2 = npwf::cta_max(dev, sm);

  if (dev2 < 0.1f) {  // uniform across the CTA: every thread holds dev2
    for (int e = threadIdx.x; e < bb; e += NT) {
      const int r = e / b, c = e % b;
      buf[MM][e] = r > c ? buf[E2][e] : (r == c ? 0.5f * buf[E2][e] : 0.f);
    }
    __syncthreads();
    npwf::cta_gemm<false, false>(b, b, b, 1.f, buf[MM], b, buf[MM], b, 0.f, nullptr, 0, buf[M2], b,
                                 sm);
    plus_identity(buf[IP2], buf[M2], b, 1.f);
    npwf::cta_gemm<false, false>(b, b, b, -1.f, buf[IP2], b, buf[MM], b, 1.f, buf[IP2], b,
                                 buf[LI2], b, sm);
    npwf::cta_gemm<false, false>(b, b, b, 1.f, buf[M2], b, buf[M2], b, 0.f, nullptr, 0, buf[M4], b,
                                 sm);
    plus_identity(buf[M4], buf[M4], b, 1.f);
    plus_identity(buf[IPM], buf[MM], b, 1.f);
    npwf::cta_gemm<false, false>(b, b, b, 1.f, buf[M4], b, buf[IPM], b, 0.f, nullptr, 0, buf[L2],
                                 b, sm);
  } else {
    for (int e = threadIdx.x; e < bb; e += NT) {
      const float v = e / b == e % b ? 1.f : 0.f;
      buf[L2][e] = v;
      buf[LI2][e] = v;
    }
    __syncthreads();
  }

  npwf::cta_gemm<false, false>(b, b, b, 1.f, buf[LI2], b, buf[W1], b, 0.f, nullptr, 0, buf[LINV],
                               b, sm);
  if (rows)
    npwf::cta_gemm<false, false>(b, b, b, 1.f, buf[L1], b, buf[L2], b, 0.f, nullptr, 0, total, b,
                                 sm);
  else
    npwf::cta_gemm<true, true>(b, b, b, 1.f, buf[L2], b, buf[L1], b, 0.f, nullptr, 0, total, b,
                               sm);
  if (threadIdx.x == 0) {
    stat[0] = dev2;
    stat[1] = dev2 < conv_gate ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" {

// p is (m, b) (rows == 0) or (b, m) (rows == 1), q the same shape; g, total
// (b, b); stat 2 floats; scratch 12 b^2 floats. All fp32, row-major,
// contiguous. Two launches on `stream`; returns the first CUDA error.
int npw_cholqr2_chain(int rows, int m, int b, const void* g, const void* p, void* q, void* total,
                      void* stat, void* scratch, float shift_c, float conv_gate, void* stream) {
  if (b <= 0 || m <= 0) return 0;
  const int smem = static_cast<int>(sizeof(npwf::Smem));
  cudaError_t err =
      cudaFuncSetAttribute(chain_step0, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* scr = static_cast<float*>(scratch);
  chain_step0<<<1, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), b, rows, shift_c, conv_gate, static_cast<float*>(total),
      static_cast<float*>(stat), scr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* linv = scr + static_cast<int64_t>(LINV) * b * b;
  if (rows)
    return npw_gemm(0, 0, 0, 0, linv, b, p, m, nullptr, 0, q, m, b, m, b, 1.f, 0.f, stream);
  return npw_gemm(0, 0, 0, 1, p, b, linv, b, nullptr, 0, q, b, m, b, b, 1.f, 0.f, stream);
}

}  // extern "C"
