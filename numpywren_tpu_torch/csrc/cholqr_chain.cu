// CholeskyQR2 passes 1-2 of compiler.lower._cholqr_adaptive: the shifted
// factor and its inverse, the analytic pass-2 Gram, the Neumann or identity
// fold chosen on the device, R, then the apply of the folded inverse to the
// tall operand. fp32, 128 | b <= 256.
//
// Replaces the Pallas kernel numpywren_tpu/ops/pallas_factor.py::
// _cholqr2_chain_kernel (cholqr2_chain_pallas). There grid step 0 runs the
// (b, b) algebra on one core out of VMEM, and every step then streams a
// block of the operand through the MXU at HIGHEST (the kernel coerces HIGH
// up to it). Here step 0 is a launch sequence over many CTAs and the apply
// is gemm_split.cu's pack and mainloop, all enqueued from C on the caller's
// stream with no host synchronisation: conv and dev2 stay on the device for
// the caller to read once. In order:
//   1. chain_rowsum: the row sums of |g|, a warp a row;
//   2. chain_shift: rs_g = max row sum (every CTA reduces the b sums itself:
//      the max is order-free, so they agree to the bit, with no atomics and
//      no zeroed word), floor = shift_c rs_g, gs = g + floor I
//      (unsymmetrized, as the reference passes it);
//   3. npw_potrf_inv (potrf.cu, trtri.cu's levels): (L1, W1) of gs;
//   4. P = W1 W1^T;
//   5. chain_fold: E2 = -floor P, each CTA's max |E2| (dev2's parts; a NaN
//      carries through every max, as the reference's max does),
//      M = tril(E2, -1) + diag(E2)/2, I + M and I;
//   6. the Neumann products: M2 = M M; chain_plus_eye: IP2 = M2 + I;
//      LI2 = IP2 - IP2 M; IP4 = M2 M2 + I (I as the product's c);
//      L2 = IP4 (I + M);
//   7. chain_select: dev2 = the max of the parts, stat = (dev2,
//      dev2 < conv_gate); unless dev2 < 0.1, L2 and LI2 become I (so a
//      failed factor, dev2 NaN, takes the identity fold, conv false). It
//      branches, never multiplies by a mask: with a large dev2 the unused
//      products may be inf or NaN, and none of that may reach linv or R;
//   8. linv = LI2 W1, total = L1 L2 (rows) or L2^T L1^T (columns);
//   9. the apply as the TPU computes HIGHEST, a bf16 split on the tensor
//      cores (gemm_split.cu at three planes, bf16x6): pack linv,
//      pack p (transposed in the rows form, where op(B) is p's m columns),
//      one mainloop: q = p linv^T (columns) or q = linv p (rows).
// The b x b products (steps 4, 6 and 8) are gemm.cu's FFMA npw_gemm over
// (b / 128)^2 CTAs each, in true FP32: at least as accurate as the
// reference's HIGHEST, and 2 b^3 flops, microseconds, a product.
//
// Bound: the apply is 2 m b^2 flops a bf16 product, six of them, over
// 2 m b x 4 bytes of p and q: at m = 2^20, b = 256 0.834 ms at
// 989 TFLOP/s (bf16), against 0.641 ms of bytes at
// 3.35 TB/s, so bound by operations (the FFMA apply's bound was 2.05 ms at
// 67 TFLOP/s). The pack's read of p and write of its planes (1.6 GB at
// three planes) are outside that bound, as the planes are the kernel's
// own layout. Step 0 is (2/3 + 7 x 2) b^3 flops in 12 launches plus
// potrf_inv's (19 at b = 256), on the critical path before the apply.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {
int npw_gemm(int in_bf16, int out_bf16, int ta, int tb, const void* a, long long lda,
             const void* b, long long ldb, const void* c, long long ldc, void* out,
             long long ldo, int m, int n, int k, float alpha, float beta, void* stream);
int npw_potrf_inv(int n, const void* a, void* l, void* w, void* scratch, void* stream,
                  int* launches);
int npw_gemm_pack(int in_bf16, int planes, int trans, const void* x, long long ldx, int rows,
                  int cols, int kp, void* planes_out, void* stream, int* launches);
int npw_gemm_split(int planes, int out_bf16, const void* a_planes, long long a_stride,
                   const void* b_planes, long long b_stride, int kp, const void* c,
                   long long ldc, void* out, long long ldo, int m, int n, float alpha,
                   float beta, void* stream, int* launches);
}

namespace {

constexpr int NT = 256;    // threads of every kernel below: one b x b entry each
constexpr int B = 128;     // b is a multiple of it, at most 2 B
constexpr int PLANES = 3;  // the apply's bf16 planes an operand (bf16x6)

// The b x b scratch buffers, in this order, then potrf_inv's scratch
// (b x 128 floats), then the small area: the row sums (NT), dev2's parts
// (NT) and floor.
enum { GS, L1, W1, PP, MM, IPM, EYE, M2, IP2, LI2, IP4, L2, LINV, NBUF };
constexpr int SMALL = 2 * NT + 4;

// The max over the CTA of each thread's |v|, in every thread. It takes the
// max of the bit patterns, which orders non-negative floats as their values
// and puts a NaN above every number: a NaN anywhere gives NaN, as
// torch.max and jnp.max do (fmaxf would drop it).
__device__ float block_max(float v) {
  __shared__ unsigned red[NT / 32];
  unsigned u = __float_as_uint(v) & 0x7fffffffu;
  for (int o = 16; o > 0; o >>= 1) u = max(u, __shfl_xor_sync(0xffffffffu, u, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = u;
  __syncthreads();
  u = red[0];
  for (int w = 1; w < NT / 32; ++w) u = max(u, red[w]);
  return __uint_as_float(u);
}

// rsum[r] = sum_c |g[r, c]|, one warp a row (NT / 32 rows a CTA).
__global__ void __launch_bounds__(NT) chain_rowsum(const float* __restrict__ g, int b,
                                                   float* __restrict__ rsum) {
  const int r = blockIdx.x * (NT / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= b) return;
  float s = 0.f;
  for (int c = lane; c < b; c += 32) s += fabsf(g[(int64_t)r * b + c]);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) rsum[r] = s;
}

// floor = shift_c max_r rsum[r]; gs = g + floor I; *floor_out = floor.
__global__ void __launch_bounds__(NT) chain_shift(const float* __restrict__ g, int b,
                                                  const float* __restrict__ rsum, float shift_c,
                                                  float* __restrict__ gs,
                                                  float* __restrict__ floor_out) {
  const float shift = shift_c * block_max(threadIdx.x < b ? rsum[threadIdx.x] : 0.f);
  const int e = blockIdx.x * NT + threadIdx.x, r = e / b, c = e % b;
  gs[e] = r == c ? g[e] + shift : g[e];
  if (e == 0) *floor_out = shift;
}

// E2 = -floor P; parts[CTA] = max |E2| over the CTA's entries;
// M = tril(E2, -1) + diag(E2)/2, ipm = I + M, eye = I.
__global__ void __launch_bounds__(NT) chain_fold(const float* __restrict__ p, int b,
                                                 const float* __restrict__ floor_in,
                                                 float* __restrict__ mm, float* __restrict__ ipm,
                                                 float* __restrict__ eye,
                                                 float* __restrict__ parts) {
  const int e = blockIdx.x * NT + threadIdx.x, r = e / b, c = e % b;
  const float e2 = -*floor_in * p[e];
  const float m = r > c ? e2 : (r == c ? 0.5f * e2 : 0.f);
  mm[e] = m;
  ipm[e] = r == c ? 1.f + m : m;
  eye[e] = r == c ? 1.f : 0.f;
  const float part = block_max(fabsf(e2));
  if (threadIdx.x == 0) parts[blockIdx.x] = part;
}

// out = x + I.
__global__ void __launch_bounds__(NT) chain_plus_eye(const float* __restrict__ x, int b,
                                                     float* __restrict__ out) {
  const int e = blockIdx.x * NT + threadIdx.x;
  out[e] = e / b == e % b ? x[e] + 1.f : x[e];
}

// dev2 = max of the `nparts` parts; stat = (dev2, dev2 < conv_gate); unless
// dev2 < 0.1 (the Neumann cleanup's range), l2 = li2 = I.
__global__ void __launch_bounds__(NT) chain_select(const float* __restrict__ parts, int nparts,
                                                   int b, float conv_gate, float* __restrict__ l2,
                                                   float* __restrict__ li2,
                                                   float* __restrict__ stat) {
  const float dev2 = block_max(threadIdx.x < nparts ? parts[threadIdx.x] : 0.f);
  const int e = blockIdx.x * NT + threadIdx.x;
  if (!(dev2 < 0.1f)) {  // uniform across the grid: every CTA holds dev2
    const float v = e / b == e % b ? 1.f : 0.f;
    l2[e] = v;
    li2[e] = v;
  }
  if (e == 0) {
    stat[0] = dev2;
    stat[1] = dev2 < conv_gate ? 1.f : 0.f;
  }
}

// out = op(a) op(b) (+ c) over b x b fp32 buffers, one npw_gemm launch.
int product(int b, int ta, int tb, const float* x, const float* y, const float* c, float alpha,
            float* out, cudaStream_t s, int& done) {
  const int err = npw_gemm(0, 0, ta, tb, x, b, y, b, c, b, out, b, b, b, b, alpha,
                           c ? 1.f : 0.f, s);
  if (err == 0) ++done;
  return err;
}

int launched(int& done) {
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) ++done;
  return err;
}

int chain(int rows, int m, int b, const float* g, const float* p, float* q,
          float* total, float* stat, float* scr, void* planes_buf, float shift_c,
          float conv_gate, void* stream, int& done) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bb = static_cast<int64_t>(b) * b;
  float* buf[NBUF];
  for (int i = 0; i < NBUF; ++i) buf[i] = scr + i * bb;
  float* potrf_scr = scr + NBUF * bb;
  float* small = potrf_scr + static_cast<int64_t>(b) * B;
  float *rsum = small, *parts = small + NT, *shift = small + 2 * NT;  // shift: floor
  const int grid = static_cast<int>(bb / NT);

  chain_rowsum<<<b / (NT / 32), NT, 0, s>>>(g, b, rsum);
  int err = launched(done);
  if (err) return err;
  chain_shift<<<grid, NT, 0, s>>>(g, b, rsum, shift_c, buf[GS], shift);
  if ((err = launched(done))) return err;
  if ((err = npw_potrf_inv(b, buf[GS], buf[L1], buf[W1], potrf_scr, stream, &done))) return err;
  if ((err = product(b, 0, 1, buf[W1], buf[W1], nullptr, 1.f, buf[PP], s, done))) return err;
  chain_fold<<<grid, NT, 0, s>>>(buf[PP], b, shift, buf[MM], buf[IPM], buf[EYE], parts);
  if ((err = launched(done))) return err;
  if ((err = product(b, 0, 0, buf[MM], buf[MM], nullptr, 1.f, buf[M2], s, done))) return err;
  chain_plus_eye<<<grid, NT, 0, s>>>(buf[M2], b, buf[IP2]);
  if ((err = launched(done))) return err;
  if ((err = product(b, 0, 0, buf[IP2], buf[MM], buf[IP2], -1.f, buf[LI2], s, done))) return err;
  if ((err = product(b, 0, 0, buf[M2], buf[M2], buf[EYE], 1.f, buf[IP4], s, done))) return err;
  if ((err = product(b, 0, 0, buf[IP4], buf[IPM], nullptr, 1.f, buf[L2], s, done))) return err;
  chain_select<<<grid, NT, 0, s>>>(parts, grid, b, conv_gate, buf[L2], buf[LI2], stat);
  if ((err = launched(done))) return err;
  if ((err = product(b, 0, 0, buf[LI2], buf[W1], nullptr, 1.f, buf[LINV], s, done))) return err;
  if (rows)
    err = product(b, 0, 0, buf[L1], buf[L2], nullptr, 1.f, total, s, done);
  else
    err = product(b, 1, 1, buf[L2], buf[L1], nullptr, 1.f, total, s, done);
  if (err) return err;

  // the apply: linv's planes (PLANES, b, b), then p's (PLANES, m, b), K-major
  __nv_bfloat16* pl_linv = static_cast<__nv_bfloat16*>(planes_buf);
  __nv_bfloat16* pl_p = pl_linv + PLANES * bb;
  const int64_t p_stride = static_cast<int64_t>(m) * b;
  if ((err = npw_gemm_pack(0, PLANES, 0, buf[LINV], b, b, b, b, pl_linv, stream, &done)))
    return err;
  if ((err = npw_gemm_pack(0, PLANES, rows, p, rows ? m : b, m, b, b, pl_p, stream, &done)))
    return err;
  if (rows)  // q (b, m) = linv p: op(A) = linv, op(B) = p (m rows of b)
    return npw_gemm_split(PLANES, 0, pl_linv, bb, pl_p, p_stride, b, nullptr, 0, q, m, b, m,
                          1.f, 0.f, stream, &done);
  // q (m, b) = p linv^T: op(A) = p, op(B) = linv^T (linv's b rows)
  return npw_gemm_split(PLANES, 0, pl_p, p_stride, pl_linv, bb, b, nullptr, 0, q, b, m, b, 1.f,
                        0.f, stream, &done);
}

}  // namespace

extern "C" {

// The scratch of npw_cholqr2_chain at (m, b): fp32 floats and bf16
// elements (the apply's planes: 3 x (b + m) x b, 1.6 GB at m = 2^20,
// b = 256).
void npw_cholqr2_chain_plan(int m, int b, long long* floats, long long* halves) {
  const long long bb = static_cast<long long>(b) * b;
  *floats = NBUF * bb + static_cast<long long>(b) * B + SMALL;
  *halves = static_cast<long long>(PLANES) * (b + m) * b;
}

// p is (m, b) (rows == 0) or (b, m) (rows == 1), q the same shape; g, total
// (b, b); stat 2 floats; scratch and planes_buf as npw_cholqr2_chain_plan
// gives them. All fp32 (planes_buf bf16), row-major, contiguous, 16-byte
// aligned. Enqueues the sequence on `stream` (15 launches plus
// npw_potrf_inv's at b) and adds each launch enqueued to *launches (when
// not null); returns the first CUDA error (0 on success).
int npw_cholqr2_chain(int rows, int m, int b, const void* g, const void* p, void* q,
                      void* total, void* stat, void* scratch, void* planes_buf, float shift_c,
                      float conv_gate, void* stream, int* launches) {
  if (b % B || b <= 0 || b > 2 * B || m < b)
    return static_cast<int>(cudaErrorInvalidValue);
  int done = 0;
  const int err = chain(rows, m, b, static_cast<const float*>(g),
                        static_cast<const float*>(p), static_cast<float*>(q),
                        static_cast<float*>(total), static_cast<float*>(stat),
                        static_cast<float*>(scratch), planes_buf, shift_c, conv_gate, stream,
                        done);
  if (launches) *launches += done;
  return err;
}

}  // extern "C"
