// Thin blocked-Householder QR of an (m, n) fp32 tile: Q (m, n) with
// orthonormal columns and R (n, n) upper triangular, A = Q R. The envelope
// is the TPU kernel's: 128 | m, 128 | n, m >= n, n <= 512, m n <= 2^18.
//
// Replaces the Pallas kernel numpywren_tpu/ops/pallas_factor.py::_qr_kernel
// (qr_pallas) with its LAPACK geqrf conventions:
//   per 128-column panel, the column loop of _householder_panel:
//     beta = -sign(alpha) ||x||, v[diag] = 1, tau = (beta - alpha) / beta,
//     a zero column gives tau = 1 and v = 0 (H = I),
//     the panel's later columns -= v (tau v^T panel), R[jg, jg] = beta exactly;
//   T from T^-1 = strict_upper(V^T V) + diag(1/tau), inverted bottom-up
//   (_invert_upper, here by 32 x 32 blocks);
//   the trailing update S -= V (T^T (V^T S)), here (V T^T) (V^T S);
//   R = triu(S[:n]), then Q = H_1 ... H_p E rebuilt right to left with
//   Q -= (V T) (V^T Q) over the columns from the panel's first on.
//
// Bound: the n-step column loop, a dependent chain of reductions over all
// m rows; the function's own bound at 2048 x 128 is 2 us of FP32
// operations. A tile of up to 1 MB does not fit one block's shared memory.
// What bounds this kernel: each column's grid barrier and the L2 round
// trip after it (at 32 rows a CTA its time does not change from 4 to 16
// CTAs), then the column step's shared-memory work, which grows with the
// rows a CTA owns; at n > 128 also the products on 32-row CTAs, which
// cta_gemm runs in 128-row tiles.
//
// Design: ONE cooperative launch of P = min(16, m / 32) CTAs of 256
// threads. CTA p owns the h = m / P contiguous rows [p h, (p + 1) h),
// 32 <= h <= 128, so h n <= 2^14: its rows of S (the working copy of A) and
// of V live in its own shared memory (rows padded to n + 1 floats, so
// column walks hit all banks), and after R is written S holds its rows of
// Q. Every step but one is row-local; the one cross-CTA primitive is a
// column sum through device scratch (L2-resident) after a grid barrier,
// whose partials every reader adds in the fixed order p = 0 .. P - 1, so
// all CTAs compute bit-identical sums.
//
// The column step for column jg takes ONE grid barrier: each CTA publishes
// its partial sum of x^2 over its rows >= jg and its partial dot products
// sum_{r > jg} x_r S[r, c] with the panel's later columns; the owner of
// row jg publishes that row (alpha = S[jg, jg] and S[jg, c]). After the
// barrier every thread forms sigma, beta, tau and
//   v^T S[:, c] = ((alpha - beta) S[jg, c] + sum_{r > jg} x_r S[r, c]) / (alpha - beta),
// the same sum as the reference's with v = x / (alpha - beta) below the
// diagonal ((alpha - beta) is a difference of opposite signs: nothing
// cancels); each CTA writes its rows of v and takes the rank-1 update on
// its rows. The step's latency is the barrier and one round of L2 loads.
// The partials are double-buffered by column parity: a CTA cannot reach
// column jg + 2's writes before every CTA has passed column jg + 1's
// barrier, which follows its reads of column jg's.
//
// Per panel: one column sum of [V^T V | V^T S_trailing] (two barriers);
// every CTA inverts T in its own shared memory (in place, on identical
// inputs, by 32 x 32 blocks: a warp a diagonal block in registers, then
// block rows as products, in place of the unblocked recurrence's 128
// barrier-separated, latency-bound rows); the trailing update is
// Y_p = V_p T^T (h x 128, device scratch) then S_p -= Y_p W, both
// factor.cuh cta_gemm calls on the CTA's own rows.
// The rebuild of Q takes one column sum per panel the same way. Every CTA
// runs every barrier (none returns early or skips a step), and no CTA
// reads another's data but through the scratch after a grid barrier.
#include <cooperative_groups.h>

#include "factor.cuh"

namespace cg = cooperative_groups;

namespace {

using npwf::B;
using npwf::NT;
using npwf::SP;

constexpr int MAXP = 16;  // CTAs of the launch, at most
constexpr int MINH = 32;  // rows a CTA owns, at least
static_assert(NT >= B && NT % 32 == 0 && MAXP <= 32, "the column step's thread maps");

// factor.cuh's product staging, without its 128 x 128 blocks
struct Stage {
  float as[npwf::BK][npwf::GT + npwf::GP];
  float bs[npwf::BK][npwf::GT + npwf::GP];
};

constexpr int MAXG = 8;  // row groups of a column in the column step's partials

struct Small {
  float part[MAXG][B];       // the column step's per-group partials
  float w[B];                // the column step's tau v^T S[:, c]
  float sig[NT / 32][MAXP];  // each warp's copy of sigma's P partials
  float tau[B];              // the panel's taus
};

__host__ __device__ inline int qr_parts(int m) { return m / MINH < MAXP ? m / MINH : MAXP; }

// Dynamic shared memory: the staging, the small arrays, T (B x SP) and the
// CTA's rows of S and V (h x (n + 1) each).
__host__ __device__ inline size_t qr_smem_bytes(int m, int n) {
  const size_t h = m / qr_parts(m);
  return sizeof(Stage) + sizeof(Small) + sizeof(float) * ((size_t)B * SP + 2 * h * (n + 1));
}

// Device scratch in floats: the column sums' partials (P, B, n) and result
// (B, n), the column step's partials (2, P, B) and row (2, B), the panels'
// T (n / B blocks of B x B) and each CTA's Y_p (m, B).
__host__ __device__ inline int64_t qr_scratch_floats(int m, int n) {
  const int64_t p = qr_parts(m);
  return (p + 2) * B * n + 2 * (p + 1) * B + (int64_t)m * B;
}

// res[e] = sum_q slots[q kc + e] for e < kc, the sum in slot order; CTA p
// adds the p-th share of the entries, each entry's P loads issued together.
// The callers have written their partials to their slots; every CTA may
// read res when this returns.
__device__ void colsum(cg::grid_group& grid, const float* slots, float* res, int kc) {
  grid.sync();
  const int parts = gridDim.x, chunk = (kc + parts - 1) / parts;
  const int e1 = min(kc, (int)(blockIdx.x + 1) * chunk);
  for (int e = blockIdx.x * chunk + threadIdx.x; e < e1; e += NT) {
    float x[MAXP];
#pragma unroll
    for (int q = 0; q < MAXP; ++q) x[q] = q < parts ? __ldcg(slots + (int64_t)q * kc + e) : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < MAXP; ++q) acc += x[q];
    res[e] = acc;
  }
  grid.sync();
}

// The column step for global column jg = j0 + jj on this CTA's rows
// [r0, r0 + h) of s and v (row stride ld): see the design note. The
// threads spread over the columns still active (G row groups of each, rows
// g, g + G, ...), and the groups' partials are added in group order before
// the CTA's partial goes to its slot. After the barrier one load per warp
// fetches sigma's P partials and one thread per column its D_c: every
// thread forms the scalars, that thread publishes w_c.
__device__ void column_step(cg::grid_group& grid, float* s, float* v, int ld, int h, int r0,
                            int j0, int jj, float* lpart, float* lrow, Small& sm) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int jg = j0 + jj, parts = gridDim.x;
  const int lj = jg - r0;                       // row jg's local index
  const bool owner = lj >= 0 && lj < h;
  const int first = max(0, lj);                 // first local row >= jg
  float* part = lpart + (jj & 1) * parts * B;
  float* row = lrow + (jj & 1) * B;
  // partials of the columns jj .. B - 1: c == jj sums x^2 over rows >= jg,
  // c > jj sums x_r s[r, c] over rows > jg
  const int na = B - jj, ng = min(MAXG, NT / na);
  if (tid < ng * na) {
    const int c = jj + tid % na, g = tid / na, col = j0 + c;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int i = (c == jj ? first : max(0, lj + 1)) + g;
    for (; i + 3 * ng < h; i += 4 * ng) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] = fmaf(s[(i + u * ng) * ld + jg], s[(i + u * ng) * ld + col], acc[u]);
    }
    for (; i < h; i += ng) acc[0] = fmaf(s[i * ld + jg], s[i * ld + col], acc[0]);
    sm.part[g][c] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  __syncthreads();
  if (tid >= jj && tid < B) {
    float sum = 0.f;
    for (int g = 0; g < ng; ++g) sum += sm.part[g][tid];
    part[blockIdx.x * B + tid] = sum;
    if (owner) row[tid] = s[lj * ld + j0 + tid];
  }
  grid.sync();
  // every sum over the P slots runs in slot order
  if (lane < MAXP) sm.sig[warp][lane] = lane < parts ? __ldcg(part + lane * B + jj) : 0.f;
  const float alpha = __ldcg(row + jj);
  const bool later = tid > jj && tid < B;
  float xd[MAXP];
#pragma unroll
  for (int k = 0; k < MAXP; ++k) xd[k] = later && k < parts ? __ldcg(part + k * B + tid) : 0.f;
  const float rv = later ? __ldcg(row + tid) : 0.f;
  __syncwarp();
  float sigma = 0.f, d = 0.f;
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    sigma += sm.sig[warp][k];
    d += xd[k];
  }
  const float nrm = sqrtf(sigma);
  const float beta = alpha >= 0.f ? -nrm : nrm;
  const bool good = sigma > 0.f;
  const float tau = good ? (beta - alpha) / beta : 1.f;
  const float denom = good ? alpha - beta : 1.f;
  if (later) sm.w[tid] = good ? tau * ((denom * rv + d) / denom) : 0.f;
  if (tid == 0) sm.tau[jj] = tau;
  if (tid >= B && tid - B < h) {
    const int i = tid - B, gr = r0 + i;
    float val = 0.f;
    if (good && gr >= jg) val = gr == jg ? 1.f : s[i * ld + jg] / denom;
    v[i * ld + jg] = val;
  }
  __syncthreads();
  // rank-1 update of the columns jj + 1 .. B - 1 on this CTA's rows >= jg
  const int nu = B - 1 - jj;
  if (nu > 0) {
    const int gu = NT / nu;
    if (tid < gu * nu) {
      const int c = jj + 1 + tid % nu, col = j0 + c;
      const float w = sm.w[c];
      int i = first + tid / nu;
      for (; i + 3 * gu < h; i += 4 * gu) {  // four rows' loads before their stores
        float x[4], y[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u] = s[(i + u * gu) * ld + col];
          y[u] = v[(i + u * gu) * ld + jg];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) s[(i + u * gu) * ld + col] = x[u] - y[u] * w;
      }
      for (; i < h; i += gu) s[i * ld + col] -= v[i * ld + jg] * w;
    }
  }
  if (owner && tid == 0) s[lj * ld + jg] = beta;  // R[jg, jg] = beta exactly
  __syncthreads();
}

// t (B x B, row stride SP) holds T^-1 = U (upper); T = U^-1 replaces it in
// place, by 32 x 32 blocks: warp b < 4 inverts the diagonal block U_bb in
// registers, bottom-up as _invert_upper runs (lane c keeps column c,
// T[j, c] = (delta_jc - sum_{j < k} U[j, k] T[k, c]) / U[j, j]); then block
// rows i = 2, 1, 0 take T_i,(i+1..) = -T_ii (U_i,(i+1..) T_(i+1..),(i+1..)),
// two cta_gemm products with the (32 x 96) temporary `tmp` in device
// scratch. U's lower blocks are 0, so are T's.
__device__ void invert_upper(float* t, float* tmp, Stage& st) {
  constexpr int W = 32;
  const int warp = threadIdx.x / 32, c = threadIdx.x % 32;
  if (warp < B / W) {
    float* u = t + warp * W * SP + warp * W;
    float tc[W];
#pragma unroll
    for (int j = W - 1; j >= 0; --j) {
      float acc = 0.f;
#pragma unroll
      for (int k = j + 1; k < W; ++k) acc = fmaf(u[j * SP + k], tc[k], acc);
      tc[j] = ((c == j ? 1.f : 0.f) - acc) / u[j * SP + j];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < W; ++k) u[k * SP + c] = tc[k];
  }
  __syncthreads();
  for (int i = B / W - 2; i >= 0; --i) {
    const int w = B - (i + 1) * W;  // the columns right of block i
    float* right = t + i * W * SP + (i + 1) * W;
    npwf::cta_gemm<false, false>(W, w, w, 1.f, right, SP, t + (i + 1) * W * (SP + 1), SP, 0.f,
                                 nullptr, 0, tmp, w, st);
    npwf::cta_gemm<false, false>(W, w, W, -1.f, t + i * W * (SP + 1), SP, tmp, w, 0.f, nullptr, 0,
                                 right, SP, st);
  }
}

__global__ void __launch_bounds__(NT, 1)
    qr_kernel(int m, int n, const float* a, float* q, float* r, float* scratch) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char raw[];
  Stage& st = *reinterpret_cast<Stage*>(raw);
  Small& sm = *reinterpret_cast<Small*>(raw + sizeof(Stage));
  float* t = reinterpret_cast<float*>(raw + sizeof(Stage) + sizeof(Small));
  const int tid = threadIdx.x, parts = gridDim.x, p = blockIdx.x;
  const int h = m / parts, r0 = p * h, ld = n + 1;
  float* s = t + B * SP;
  float* v = s + h * ld;

  float* slots = scratch;
  float* res = slots + (int64_t)parts * B * n;
  float* lpart = res + (int64_t)B * n;
  float* lrow = lpart + 2 * parts * B;
  float* tg = lrow + 2 * B;
  float* y = tg + (int64_t)n * B + (int64_t)r0 * B;  // this CTA's Y_p (h x B)

  for (int e = tid; e < h * n; e += NT) {
    const int i = e / n, c = e % n;
    s[i * ld + c] = a[(int64_t)(r0 + i) * n + c];
    v[i * ld + c] = 0.f;
  }
  __syncthreads();

  for (int j0 = 0; j0 < n; j0 += B) {
    for (int jj = 0; jj < B; ++jj) column_step(grid, s, v, ld, h, r0, j0, jj, lpart, lrow, sm);
    // [G | W] = V^T [V | S[:, j0 + B:]] over all rows
    const int rem = n - j0 - B, wc = B + rem;
    float* mine = slots + (int64_t)p * B * wc;
    npwf::cta_gemm<true, false>(B, B, h, 1.f, v + j0, ld, v + j0, ld, 0.f, nullptr, 0, mine, wc,
                                st);
    if (rem > 0)
      npwf::cta_gemm<true, false>(B, rem, h, 1.f, v + j0, ld, s + j0 + B, ld, 0.f, nullptr, 0,
                                  mine + B, wc, st);
    colsum(grid, slots, res, B * wc);
#pragma unroll 8
    for (int e = tid; e < B * B; e += NT) {
      const int i = e / B, c = e % B;
      t[i * SP + c] = i < c ? __ldcg(res + i * wc + c) : (i == c ? 1.f / sm.tau[i] : 0.f);
    }
    __syncthreads();
    invert_upper(t, y, st);  // Y_p's scratch is free until the trailing update
    if (p == 0)
      for (int e = tid; e < B * B; e += NT) tg[(int64_t)j0 * B + e] = t[(e / B) * SP + e % B];
    if (rem > 0) {
      // S_p[:, j0 + B:] -= (V_p T^T) W
      npwf::cta_gemm<false, true>(h, B, B, 1.f, v + j0, ld, t, SP, 0.f, nullptr, 0, y, B, st);
      npwf::cta_gemm<false, false>(h, rem, B, -1.f, y, B, res + B, wc, 1.f, s + j0 + B, ld,
                                   s + j0 + B, ld, st);
    }
  }

  for (int e = tid; e < h * n; e += NT) {
    const int i = e / n, c = e % n, gr = r0 + i;
    if (gr < n) r[(int64_t)gr * n + c] = c >= gr ? s[i * ld + c] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < h * n; e += NT) {
    const int i = e / n, c = e % n;
    s[i * ld + c] = r0 + i == c ? 1.f : 0.f;  // this CTA's rows of E
  }
  __syncthreads();
  for (int j0 = n - B; j0 >= 0; j0 -= B) {
    // Q_p[:, j0:] -= (V_p T) (V^T Q[:, j0:])
    const int cols = n - j0;
    float* mine = slots + (int64_t)p * B * cols;
    npwf::cta_gemm<true, false>(B, cols, h, 1.f, v + j0, ld, s + j0, ld, 0.f, nullptr, 0, mine,
                                cols, st);
    colsum(grid, slots, res, B * cols);
    npwf::cta_gemm<false, false>(h, B, B, 1.f, v + j0, ld, tg + (int64_t)j0 * B, B, 0.f, nullptr,
                                 0, y, B, st);
    npwf::cta_gemm<false, false>(h, cols, B, -1.f, y, B, res, cols, 1.f, s + j0, ld, s + j0, ld,
                                 st);
  }
  for (int e = tid; e < h * n; e += NT) {
    const int i = e / n, c = e % n;
    q[(int64_t)(r0 + i) * n + c] = s[i * ld + c];
  }
}

}  // namespace

extern "C" {

// The launch's plan for an (m, n) tile inside the envelope: its CTAs, their
// dynamic shared memory in bytes and npw_qr's scratch in floats.
void npw_qr_plan(int m, int n, int* parts, int* smem_bytes, long long* scratch_floats) {
  *parts = qr_parts(m);
  *smem_bytes = static_cast<int>(qr_smem_bytes(m, n));
  *scratch_floats = qr_scratch_floats(m, n);
}

// a (m, n), q (m, n), r (n, n), row-major fp32, inside the envelope above;
// scratch holds npw_qr_plan's scratch_floats. One cooperative launch on
// `stream`, no host synchronisation. Returns a CUDA error code: the
// launch's, or cudaErrorCooperativeLaunchTooLarge when the card cannot
// hold the P CTAs at once.
int npw_qr(int m, int n, const void* a, void* q, void* r, void* scratch, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int parts = qr_parts(m);
  if (parts < 1 || m % parts != 0 || n % B != 0 || m < n || (m / parts) * n > (1 << 14))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(qr_smem_bytes(m, n));
  cudaError_t err =
      cudaFuncSetAttribute(qr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qr_kernel, NT, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm * sms < parts) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const float* af = static_cast<const float*>(a);
  float* qf = static_cast<float*>(q);
  float* rf = static_cast<float*>(r);
  float* sf = static_cast<float*>(scratch);
  void* args[] = {&m, &n, &af, &qf, &rf, &sf};
  err = cudaLaunchCooperativeKernel((void*)qr_kernel, dim3(parts), dim3(NT), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
