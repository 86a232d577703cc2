// Thin blocked-Householder QR of an (m, n) fp32 tile: Q (m, n) with
// orthonormal columns and R (n, n) upper triangular, A = Q R. The envelope
// is the TPU kernel's: 128 | m, 128 | n, m >= n, n <= 512, m n <= 2^18.
//
// Replaces the Pallas kernel numpywren_tpu/ops/pallas_factor.py::_qr_kernel
// (qr_pallas) with its LAPACK geqrf conventions, step for step:
//   per 128-column panel, the column loop of _householder_panel:
//     beta = -sign(alpha) ||x||, v[diag] = 1, tau = (beta - alpha) / beta,
//     a zero column gives tau = 1 and v = 0 (H = I),
//     the panel's later columns -= v (tau v^T panel), R[jg, jg] = beta exactly;
//   T from T^-1 = strict_upper(V^T V) + diag(1/tau), inverted bottom-up
//   (_invert_upper);
//   the trailing update S -= V (T^T (V^T S));
//   R = triu(S[:n]), then Q = H_1 ... H_p E rebuilt right to left with
//   Q -= V (T (V^T Q)).
// V is zero above its diagonal, so every product runs over rows >= the
// panel's first row, and the rebuild over columns >= it (the columns of Q
// left of the panel are unit vectors that V^T annihilates): the same sums
// as the reference's full-height products less their exact zero terms.
//
// Bound: the n-step column loop, each step a reduction, a dot product of
// the vector with every later panel column and a rank-1 update, three
// barriers apart; then one SM's FP32 rate for the products. The function's
// own bound at 2048 x 128 is 2 us of FP32 operations.
// Design: ONE CTA of 256 threads owns the tile, as one TPU core owned it in
// VMEM (up to 1 MB here: too large for shared memory). The working copy S,
// the vectors V, the panels' T, Q and the products' temporaries live in
// device memory, where they stay L2-resident; shared memory holds the
// current vector (at most 2048 floats), the panel's T^-1 and T (128 x 128,
// rows padded to 129 floats so column walks hit all banks) and the
// products' staging (factor.cuh's cta_gemm). In the column loop thread t
// owns panel column t % 128 and every other row from t / 128, so a warp
// reads 32 neighbouring floats of a row. One launch, no host
// synchronisation. Several CTAs for the products is later work.
#include "factor.cuh"

namespace {

using npwf::B;
using npwf::NT;
using npwf::SP;

constexpr int MAXM = 2048;  // m <= 2^18 / 128
constexpr int U = 8;        // rows a thread has in flight in the column loop
static_assert(NT == 2 * B, "the column loop maps two threads to each panel column");

struct QrSmem {
  npwf::Smem f;          // f.s: the panel's T^-1, f.w: its T; the products' staging
  float vcol[MAXM];      // the current Householder vector, by global row
  float part[2][B];      // the two row halves' partial dot products
  float tau[B];          // the panel's taus
  float scal[4];         // beta, tau, denom, good
  float wred[NT / 32];   // per-warp partial sums
};

// _householder_panel on the columns j0 .. j0 + B - 1 of s (m, n), in place;
// column j0 + jj of v (rows >= j0) receives its vector, sm.tau its tau.
__device__ void householder_panel(float* s, float* v, int m, int n, int j0, QrSmem& sm) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid % B, h = tid / B;
  const int col = j0 + c;
  for (int jj = 0; jj < B; ++jj) {
    const int jg = j0 + jj;
    float acc = 0.f;
    for (int r = jg + tid; r < m; r += NT) {
      const float x = s[(int64_t)r * n + jg];
      acc = fmaf(x, x, acc);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) sm.wred[warp] = acc;
    __syncthreads();
    if (tid == 0) {
      float sigma = 0.f;
      for (int w = 0; w < NT / 32; ++w) sigma += sm.wred[w];
      const float alpha = s[(int64_t)jg * n + jg];
      const float nrm = sqrtf(sigma);
      const float beta = alpha >= 0.f ? -nrm : nrm;
      const bool good = sigma > 0.f;
      const float tau = good ? (beta - alpha) / beta : 1.f;
      sm.scal[0] = beta;
      sm.scal[1] = tau;
      sm.scal[2] = good ? alpha - beta : 1.f;
      sm.scal[3] = good ? 1.f : 0.f;
      sm.tau[jj] = tau;
      s[(int64_t)jg * n + jg] = beta;  // R[jg, jg] = beta exactly; no later read of row jg here
    }
    __syncthreads();
    const float tau = sm.scal[1], denom = sm.scal[2];
    const bool good = sm.scal[3] != 0.f;
    for (int r = j0 + tid; r < m; r += NT) {
      float val = 0.f;
      if (good && r >= jg) val = r == jg ? 1.f : s[(int64_t)r * n + jg] / denom;
      sm.vcol[r] = val;
      v[(int64_t)r * n + jg] = val;
    }
    __syncthreads();
    // the dot products and the update walk rows U at a time, their loads
    // issued together: a thread's rows are a chain of L2 round trips
    if (c > jj) {
      float p[U] = {};
      int r = jg + h;
      for (; r + 2 * (U - 1) < m; r += 2 * U) {
        float x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) x[u] = s[(int64_t)(r + 2 * u) * n + col];
#pragma unroll
        for (int u = 0; u < U; ++u) p[u] = fmaf(sm.vcol[r + 2 * u], x[u], p[u]);
      }
      for (; r < m; r += 2) p[0] = fmaf(sm.vcol[r], s[(int64_t)r * n + col], p[0]);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) sum += p[u];
      sm.part[h][c] = sum;
    }
    __syncthreads();
    if (c > jj) {
      const float w = (sm.part[0][c] + sm.part[1][c]) * tau;
      int r = jg + h;
      for (; r + 2 * (U - 1) < m; r += 2 * U) {
        float x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) x[u] = s[(int64_t)(r + 2 * u) * n + col];
#pragma unroll
        for (int u = 0; u < U; ++u) s[(int64_t)(r + 2 * u) * n + col] = x[u] - sm.vcol[r + 2 * u] * w;
      }
      for (; r < m; r += 2) {
        float* x = s + (int64_t)r * n + col;
        *x = *x - sm.vcol[r] * w;
      }
    }
    __syncthreads();
  }
}

// T of the panel at j0 (_invert_upper) into tg (B x B, ld B); tmp is
// (B x B) scratch for V^T V.
__device__ void panel_t(const float* v, float* tmp, float* tg, int m, int n, int j0, QrSmem& sm) {
  const int tid = threadIdx.x;
  const float* vp = v + (int64_t)j0 * n + j0;
  npwf::cta_gemm<true, false>(B, B, m - j0, 1.f, vp, n, vp, n, 0.f, nullptr, 0, tmp, B, sm.f);
  for (int e = tid; e < B * B; e += NT) {
    const int r = e / B, cc = e % B;
    sm.f.s[r * SP + cc] = r < cc ? tmp[e] : (r == cc ? 1.f / sm.tau[r] : 0.f);
    sm.f.w[r * SP + cc] = 0.f;
  }
  __syncthreads();
  // rows bottom-up: T[j, c] = (delta_jc - sum_{j < k <= c} T^-1[j, k] T[k, c]) / T^-1[j, j]
  for (int j = B - 1; j >= 0; --j) {
    if (tid < B) {
      float acc = 0.f;
      for (int k = j + 1; k <= tid; ++k) acc = fmaf(sm.f.s[j * SP + k], sm.f.w[k * SP + tid], acc);
      sm.f.w[j * SP + tid] = ((tid == j ? 1.f : 0.f) - acc) / sm.f.s[j * SP + j];
    }
    __syncthreads();
  }
  for (int e = tid; e < B * B; e += NT) tg[e] = sm.f.w[(e / B) * SP + e % B];
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1)
    qr_kernel(int m, int n, const float* a, float* q, float* r, float* scratch) {
  extern __shared__ __align__(16) unsigned char raw[];
  QrSmem& sm = *reinterpret_cast<QrSmem*>(raw);
  const int tid = threadIdx.x;
  const int64_t mn = (int64_t)m * n;
  float* s = scratch;
  float* v = s + mn;
  float* tg = v + mn;      // the panels' T, (n / B) blocks of B x B
  float* w1 = tg + (int64_t)n * B;
  float* w2 = w1 + (int64_t)B * n;
  float* tmp = w2 + (int64_t)B * n;

  for (int64_t e = tid; e < mn; e += NT) s[e] = a[e];
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += B) {
    householder_panel(s, v, m, n, j0, sm);
    float* t = tg + (int64_t)j0 * B;
    panel_t(v, tmp, t, m, n, j0, sm);
    const int rem = n - j0 - B, rows = m - j0;
    if (rem > 0) {
      const float* vp = v + (int64_t)j0 * n + j0;
      float* st = s + (int64_t)j0 * n + j0 + B;
      // S[j0:, j0+B:] -= V (T^T (V^T S[j0:, j0+B:]))
      npwf::cta_gemm<true, false>(B, rem, rows, 1.f, vp, n, st, n, 0.f, nullptr, 0, w1, n, sm.f);
      npwf::cta_gemm<true, false>(B, rem, B, 1.f, t, B, w1, n, 0.f, nullptr, 0, w2, n, sm.f);
      npwf::cta_gemm<false, false>(rows, rem, B, -1.f, vp, n, w2, n, 1.f, st, n, st, n, sm.f);
    }
  }
  for (int e = tid; e < n * n; e += NT) {
    const int i = e / n, c = e % n;
    r[e] = c >= i ? s[(int64_t)i * n + c] : 0.f;
  }
  for (int64_t e = tid; e < mn; e += NT) q[e] = (e / n == e % n) ? 1.f : 0.f;
  __syncthreads();
  for (int j0 = n - B; j0 >= 0; j0 -= B) {
    // Q[j0:, j0:] -= V (T (V^T Q[j0:, j0:]))
    const int rows = m - j0, cols = n - j0;
    const float* vp = v + (int64_t)j0 * n + j0;
    const float* t = tg + (int64_t)j0 * B;
    float* qs = q + (int64_t)j0 * n + j0;
    npwf::cta_gemm<true, false>(B, cols, rows, 1.f, vp, n, qs, n, 0.f, nullptr, 0, w1, n, sm.f);
    npwf::cta_gemm<false, false>(B, cols, B, 1.f, t, B, w1, n, 0.f, nullptr, 0, w2, n, sm.f);
    npwf::cta_gemm<false, false>(rows, cols, B, -1.f, vp, n, w2, n, 1.f, qs, n, qs, n, sm.f);
  }
}

}  // namespace

extern "C" {

// a (m, n), q (m, n), r (n, n), row-major fp32, inside the envelope above;
// scratch holds 2 m n + 3 * 128 n + 128^2 floats (S, V, the panels' T, two
// (128, n) temporaries and V^T V). Returns cudaGetLastError().
int npw_qr(int m, int n, const void* a, void* q, void* r, void* scratch, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int smem = static_cast<int>(sizeof(QrSmem));
  cudaError_t err =
      cudaFuncSetAttribute(qr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  qr_kernel<<<1, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      m, n, static_cast<const float*>(a), static_cast<float*>(q), static_cast<float*>(r),
      static_cast<float*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
