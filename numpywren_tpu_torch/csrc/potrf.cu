// potrf of an (n, n) SPD fp32 tile, 128 | n <= 1024: the lower Cholesky
// factor, its strict upper triangle exactly 0.
//
// Replaces numpywren_tpu/ops/pallas_factor.py:66 _potrf_kernel
// (potrf_pallas): per 128-wide diagonal block the column loop of
// _factor_block_with_inverse (the block's factor L11 and its inverse W11),
// the below-panel solve X = A21 W11^T and the trailing update
// A22 -= X X^T, then the strict upper triangle zeroed.
//
// Bound: at n = 1024 the function is n^3/3 = 0.36 GFLOP (5.3 us at the
// FP32 FFMA peak) over 8 MB in and out, so the card is bound by the
// sequential depth of the factorization, not by its flops or bytes. The
// TPU kernel's shape (one core owns the tile in VMEM, a 128-step column
// loop per block) ran here on one SM, two CTA barriers per column and the
// products on the same SM.
//
// Design: a right-looking blocked factor with 128-wide panels, enqueued
// from C on the caller's stream with no host synchronisation. Per panel j0:
//   1. the diagonal step, one CTA of 256 threads (potrf_diag): the block
//      and its inverse in shared memory (2 x 128 x 129 floats), factored by
//      a 32-wide recursion instead of a 128-step column loop. One warp
//      factors each 32 x 32 diagonal sub-block in registers (lane r owns
//      row r; column j goes to the other lanes through a 32-float shared
//      buffer behind a __syncwarp, four entries a load: no CTA barrier
//      inside the 32 steps) and inverts it by forward substitution (lane c
//      owns column c); all warps then solve the rows below it by a product
//      with that inverse and take the rank-32 update of the lower trailing
//      part. W11 is assembled from the four 32 x 32 inverses by the block
//      recurrence W[i, j] = -W[i, i] sum_k L[i, k] W[k, j], its sum formed
//      by the other seven warps while the first one factors. Twelve
//      barriers per block, against 256 in the column loop;
//   2. the panel solve X = A21 W11^T, many CTAs: npw_gemm (gemm.cu) into
//      scratch;
//   3. the trailing update A22 -= X X^T, many CTAs: npw_gemm with out
//      aliasing c (the whole square, as the reference; only its lower
//      triangle is read again);
//   4. potrf_store, many CTAs: X into L's column block and zeros into the
//      block row right of the diagonal block (final: nothing writes there
//      again).
// The first panel reads the operand directly (the update writes A22 - X X^T
// into l), so the tile is never copied. At n = 1024: 8 diagonal launches
// and 7 x 3 multi-CTA launches, 29 in all.
//
// potrf_inv (npw_potrf_inv; replaces :84 _potrf_inv_kernel, potrf_inv_pallas)
// is the same sequence with each diagonal step's W11 written into the
// inverse's diagonal block (the panel solve reads it there), then
// trtri.cu's recursive-doubling levels on (L, W): 2 ceil(log2(n / 128))
// launches more, 35 in all at n = 1024.
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int npw_gemm(int in_bf16, int out_bf16, int ta, int tb, const void* a, long long lda,
                        const void* b, long long ldb, const void* c, long long ldc, void* out,
                        long long ldo, int m, int n, int k, float alpha, float beta,
                        void* stream);
extern "C" int npw_trtri_levels(int n, const void* l, void* w, void* scratch, void* stream,
                                int* launches);

namespace {

constexpr int B = 128;         // panel width (the TPU's _B)
constexpr int R = 32;          // sub-block width: one warp's rows
constexpr int SP = B + 1;      // shared row stride: column walks hit 32 banks
constexpr int XP = B - R + 4;  // row stride of the transposed below-block (float4-aligned)
constexpr int LP = R + 4;      // row stride of the warp's column buffer (float4-aligned)
constexpr int NT = 256;        // threads of the diagonal step

struct DiagSmem {
  float s[B * SP];  // the block, factored in place into L11 (strict upper 0)
  float w[B * SP];  // W11 = L11^-1 (strict upper 0)
  float x[R * XP];  // the solved rows below a sub-block, transposed
  float p[R * XP];  // L[i, :i] W[:i, :i] for the sub-block row i
  float lt[R * LP];  // the factoring warp's columns of L
};

// One warp factors the (R, R) SPD sub-block at s (row stride SP, lower
// triangle read) in place and writes its inverse to w (same stride); lt is
// the warp's (R, LP) column buffer. Lane r holds row r of L and column r of
// the inverse in registers. Step j scales column j, puts it in lt[j] and
// reads it back four entries a load: lane r takes L[c, j] for every c > j
// and updates its row, L[r, c] -= L[r, j] L[c, j]. Every lane also keeps
// the trailing diagonal in dd, updated from the same L[c, j] (the fma lane
// c runs on its own entry, so the same bits), so each lane has every pivot
// without a broadcast. The same L[c, j] drive the forward substitution of
// column r of the inverse: W[j, r] = (delta_jr - acc[j]) / L[j, j], then
// acc[c] += L[c, j] W[j, r] for c > j. W[j, r] = 0 for j < r exactly, so
// both strict upper triangles come out 0.
__device__ __forceinline__ void warp_factor_invert(float* s, float* w, float* lt) {
  const int r = threadIdx.x & 31;
  float row[R], dd[R], acc[R];
#pragma unroll
  for (int c = 0; c < R; ++c) {
    row[c] = c <= r ? s[r * SP + c] : 0.f;
    dd[c] = s[c * SP + c];
    acc[c] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float inv = rsqrtf(dd[j]);  // NaN for a non-positive pivot
    row[j] = r == j ? dd[j] * inv : (r > j ? row[j] * inv : 0.f);
    lt[j * LP + r] = row[j];
    const float wj = ((r == j ? 1.f : 0.f) - acc[j]) * inv;
    w[j * SP + r] = wj;
    __syncwarp();
#pragma unroll
    for (int q = (j + 1) / 4; q < R / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(&lt[j * LP + 4 * q]);
      const float lc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * q + u;
        if (c > j) {
          dd[c] = fmaf(-lc[u], lc[u], dd[c]);
          if (r >= c) row[c] = fmaf(-row[j], lc[u], row[c]);
          acc[c] = fmaf(lc[u], wj, acc[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < R; ++c) s[r * SP + c] = row[c];
}

// The diagonal step: (l11, w11) of the (B, B) SPD block at d (row stride
// ldd, 16-byte aligned rows; only its lower triangle is used). l11 gets L11 with
// its strict upper 0 (row stride ldl), w11 gets W11 = L11^-1 with its strict
// upper 0 (row stride ldw).
//
// Per 32-wide sub-block c0 (rows and columns c0 .. c1 - 1):
//   A. warp 0 factors and inverts the diagonal sub-block; meanwhile warps
//      1-7 form P = L[c0:c1, :c0] W[:c0, :c0] (the W recurrence's sum, which
//      needs only earlier sub-blocks);
//   B. all warps: W[c0:c1, :c0] = -W[c0:c1, c0:c1] P, and the rows below,
//      X = S[c1:, c0:c1] W[c0:c1, c0:c1]^T (kept transposed in sm.x);
//   C. all warps: the rank-32 update S[c1:, c1:] -= X X^T (lower half) and
//      X into S's column block.
// Every product is 4 x 4 outputs a thread. Eleven barriers in all.
__global__ void __launch_bounds__(NT, 1)
    potrf_diag(const float* d, int64_t ldd, float* l11, int64_t ldl, float* w11, int64_t ldw) {
  extern __shared__ __align__(16) unsigned char raw[];
  DiagSmem& sm = *reinterpret_cast<DiagSmem*>(raw);
  const int tid = threadIdx.x;
  {  // every load in flight at once: 16 float4 a thread
    constexpr int PER = B * B / 4 / NT;
    float4 v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * NT, r = e / (B / 4), c = 4 * (e % (B / 4));
      v[i] = *reinterpret_cast<const float4*>(d + r * ldd + c);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * NT, r = e / (B / 4), c = 4 * (e % (B / 4));
      sm.s[r * SP + c] = v[i].x;
      sm.s[r * SP + c + 1] = v[i].y;
      sm.s[r * SP + c + 2] = v[i].z;
      sm.s[r * SP + c + 3] = v[i].w;
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < B; c0 += R) {
    const int c1 = c0 + R, rows = B - c1;
    // A
    if (tid < 32) {
      warp_factor_invert(sm.s + c0 * SP + c0, sm.w + c0 * SP + c0, sm.lt);
    } else {
      // P[r, c] = sum_{c <= k < c0} L[c0 + r, k] W[k, c] (W[k, c] = 0 for k < c)
      for (int e = tid - 32; e < (R / 4) * (c0 / 4); e += NT - 32) {
        const int r0 = 4 * (e % (R / 4)), q0 = 4 * (e / (R / 4));
        float acc[4][4] = {};
        for (int k = q0; k < c0; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            a[u] = sm.s[(c0 + r0 + u) * SP + k];
            b[u] = sm.w[k * SP + q0 + u];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<float4*>(&sm.p[(r0 + u) * XP + q0]) =
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      }
    }
    __syncthreads();
    // B: nw items of W[c0:c1, :c0], then nx items of X
    const int nw = (R / 4) * (c0 / 4), nx = (rows / 4) * (R / 4);
    for (int e = tid; e < nw + nx; e += NT) {
      float acc[4][4] = {};
      if (e < nw) {
        // W[c0 + r, c] = -sum_{t <= r} W[c0 + r, c0 + t] P[t, c]
        const int r0 = 4 * (e % (R / 4)), q0 = 4 * (e / (R / 4));
        for (int t = 0; t < r0 + 4; ++t) {
          const float4 b = *reinterpret_cast<const float4*>(&sm.p[t * XP + q0]);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float a = sm.w[(c0 + r0 + u) * SP + c0 + t];
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a, bv[v], acc[u][v]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) sm.w[(c0 + r0 + u) * SP + q0 + v] = -acc[u][v];
      } else {
        // X[i, t] = sum_s S[c1 + i, c0 + s] W[c0 + t, c0 + s], s <= t
        const int f = e - nw, i0 = 4 * (f % (rows / 4)), t0 = 4 * (f / (rows / 4));
        for (int s = 0; s < t0 + 4; ++s) {
          float a[4], b[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            a[u] = sm.s[(c1 + i0 + u) * SP + c0 + s];
            b[u] = sm.w[(c0 + t0 + u) * SP + c0 + s];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
          *reinterpret_cast<float4*>(&sm.x[(t0 + v) * XP + i0]) =
              make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
      }
    }
    __syncthreads();
    if (rows == 0) break;
    // C: S[i, k] -= sum_t X[i, t] X[k, t] for c1 <= k <= i < B, and X into
    // the sub-block's column block (columns the update does not read)
    const int nt = rows / 4;
    for (int e = tid; e < nt * nt; e += NT) {
      const int ti = e / nt, tk = e % nt;
      if (tk > ti) continue;
      float acc[4][4] = {};
#pragma unroll 8
      for (int t = 0; t < R; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.x[t * XP + 4 * ti]);
        const float4 b = *reinterpret_cast<const float4*>(&sm.x[t * XP + 4 * tk]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = c1 + 4 * ti + u, k = c1 + 4 * tk + v;
          if (k <= i) sm.s[i * SP + k] -= acc[u][v];
        }
    }
    for (int e = tid; e < rows * R; e += NT) {
      const int i = e % rows, t = e / rows;
      sm.s[(c1 + i) * SP + c0 + t] = sm.x[t * XP + i];
    }
    __syncthreads();
  }

  // the strict upper triangles were never written (or read): 0 on the way out
#pragma unroll 8
  for (int e = tid; e < B * B; e += NT) {
    const int r = e / B, c = e % B;
    l11[r * ldl + c] = c <= r ? sm.s[r * SP + c] : 0.f;
    w11[r * ldw + c] = c <= r ? sm.w[r * SP + c] : 0.f;
  }
}

// X into L's column block below the diagonal block, and zeros into the
// block row right of it (strict upper: nothing writes there again). One
// float4 of each a thread; x is (rows, B), rows a multiple of B.
__global__ void __launch_bounds__(NT)
    potrf_store(const float* x, float* l, int64_t ld, int j0, int rows) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= rows * (B / 4)) return;
  const int j1 = j0 + B;
  const int i = e / (B / 4), c = 4 * (e % (B / 4));
  *reinterpret_cast<float4*>(l + (j1 + i) * ld + j0 + c) =
      *reinterpret_cast<const float4*>(x + i * B + c);
  const int zr = e / (rows / 4), zc = 4 * (e % (rows / 4));
  *reinterpret_cast<float4*>(l + (j0 + zr) * ld + j1 + zc) = make_float4(0.f, 0.f, 0.f, 0.f);
}

cudaError_t diag_launch(const float* d, int64_t ldd, float* l11, int64_t ldl, float* w11,
                        int64_t ldw, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(DiagSmem));
  cudaError_t err =
      cudaFuncSetAttribute(potrf_diag, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  potrf_diag<<<1, NT, smem, stream>>>(d, ldd, l11, ldl, w11, ldw);
  return cudaGetLastError();
}

// The launch sequence of npw_potrf (w null: W11 into scratch) and of
// npw_potrf_inv (W11 into w's diagonal block, then trtri.cu's global
// levels); `done` counts the launches enqueued.
int potrf_sequence(int n, const void* a, void* l, float* w, void* scratch, void* stream,
                   int& done) {
  if (n <= 0) return 0;
  if (n % B) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lo = static_cast<float*>(l);
  float* x = static_cast<float*>(scratch) + B * B;
  const int64_t ldw = w ? n : B;
  const float* src = static_cast<const float*>(a);  // the first panel reads a
  for (int j0 = 0; j0 < n; j0 += B) {
    const int j1 = j0 + B, rows = n - j1;
    float* w11 = w ? w + (int64_t)j0 * n + j0 : static_cast<float*>(scratch);
    int err = static_cast<int>(
        diag_launch(src + (int64_t)j0 * n + j0, n, lo + (int64_t)j0 * n + j0, n, w11, ldw, s));
    if (err != 0) return err;
    ++done;
    if (rows == 0) break;
    // X = A21 W11^T
    err = npw_gemm(0, 0, 0, 1, src + (int64_t)j1 * n + j0, n, w11, ldw, nullptr, 0, x, B, rows, B,
                   B, 1.f, 0.f, s);
    if (err != 0) return err;
    ++done;
    // A22 - X X^T into l (the whole square, as the reference)
    err = npw_gemm(0, 0, 0, 1, x, B, x, B, src + (int64_t)j1 * n + j1, n, lo + (int64_t)j1 * n + j1,
                   n, rows, rows, B, -1.f, 1.f, s);
    if (err != 0) return err;
    ++done;
    potrf_store<<<rows * (B / 4) / NT, NT, 0, s>>>(x, lo, n, j0, rows);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    ++done;
    src = lo;
  }
  return w ? npw_trtri_levels(n, lo, w, scratch, stream, &done) : 0;
}

}  // namespace

extern "C" {

// Lower Cholesky factor of the (n, n) SPD a into l (strict upper 0), n a
// multiple of 128. scratch holds n x 128 floats: W11 (128 x 128), then X
// ((n - 128) x 128). a, l and scratch are fp32, row-major, contiguous,
// 16-byte aligned, not overlapping. Enqueues 4 n/128 - 3 launches on
// `stream` and adds each one that was enqueued to *launches (when not
// null); returns the first CUDA error (0 on success).
int npw_potrf(int n, const void* a, void* l, void* scratch, void* stream, int* launches) {
  int done = 0;
  const int err = potrf_sequence(n, a, l, nullptr, scratch, stream, done);
  if (launches) *launches += done;
  return err;
}

// (L, L^-1) of the (n, n) SPD a: l as npw_potrf's, w = l^-1 (strict upper
// 0). potrf's sequence with each W11 left in w's diagonal block, then
// trtri.cu's global levels (npw_trtri_levels) on (l, w). scratch holds
// max(n x 128, n^2 / 4) floats (the panels' X, then the levels' T). a, l,
// w and scratch are fp32, row-major, contiguous, 16-byte aligned, not
// overlapping. Enqueues (4 n/128 - 3) + 2 ceil(log2(n/128)) launches on
// `stream` and adds each one enqueued to *launches (when not null);
// returns the first CUDA error (0 on success).
int npw_potrf_inv(int n, const void* a, void* l, void* w, void* scratch, void* stream,
                  int* launches) {
  int done = 0;
  const int err = potrf_sequence(n, a, l, static_cast<float*>(w), scratch, stream, done);
  if (launches) *launches += done;
  return err;
}

// The diagonal step alone, for comparison with its plain version: d, l11
// and w11 are (128, 128) fp32, row-major, contiguous.
int npw_potrf_diag(const void* d, void* l11, void* w11, void* stream) {
  return static_cast<int>(diag_launch(static_cast<const float*>(d), B, static_cast<float*>(l11), B,
                                      static_cast<float*>(w11), B,
                                      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
