// trtri of a lower-triangular (n, n) fp32 tile, 128 | n <= 1024: W = L^-1,
// its strict upper triangle exactly 0 (L's strict upper is not read).
//
// Replaces numpywren_tpu/ops/pallas_factor.py:137 _trtri_kernel
// (trtri_pallas, and trsm_pallas through it); its global levels are also
// the off-diagonal half of :98 _potrf_inv_into (potrf_inv_pallas), which
// potrf.cu's sequence calls after its last panel (npw_potrf_inv).
//
// Bound: at n = 1024 the function is n^3/3 = 0.36 GFLOP (5.3 us at the
// FP32 FFMA peak) over 8 MB in and out, so the card is bound by the
// dependence chain of the inverse, not by its flops or bytes. The TPU
// kernel's shape (one core, 128 barrier-separated rows per diagonal block,
// then the block rows of W[i, :i] = -W[i, i] (L[i, :i] W[:i, :i]) one after
// another) ran here on one SM.
//
// Design: recursive doubling (LAPACK's blocked trtri). Once W is right on
// the aligned diagonal blocks of width h, each pair of neighbouring h-blocks
// A = [2hp, 2hp + h), C = [2hp + h, min(2hp + 2h, n)) gives
//   W[C, A] = -W[C, C] (L[C, A] W[A, A]),   W[A, C] = 0,
// and W is right on blocks of width 2h. Every pair of a level is
// independent, and so is every output tile of its two products.
//   1. trtri_diag, one launch of n/128 CTAs of 256 threads: each CTA holds
//      one 128 x 128 diagonal block of L and of W in shared memory. Warps
//      0-3 each invert one 32 x 32 sub-block by forward substitution in
//      registers (lane c owns column c; the sub-block's columns of L come
//      through a per-warp buffer, four entries a load, no barrier inside the
//      32 steps); then all warps run the levels h = 32 and 64 inside the
//      block, 4 x 4 outputs a thread, the zero triangles of W skipped. Six
//      CTA barriers in all.
//   2. per level h = 128, 256, 512 while h < n, two launches over a grid of
//      (64 x 64 output tiles, pairs): trtri_level_t forms T_p = L[C, A]
//      W[A, A] into scratch, trtri_level_w forms W[C, A] = -W[C, C] T_p and
//      zeros W[A, C]. 256 threads a CTA, 4 x 4 outputs each, 16-deep k slices
//      double-buffered in shared memory. W[A, A] and W[C, C] are lower
//      triangular, so the output column tile [n0, n0 + 64) of the first
//      product needs k >= n0 only and the output row tile [m0, m0 + 64) of
//      the second k < m0 + 64 only: a level is n h^2 flops, the whole
//      function n^3 / 3. 64-wide tiles keep 64 CTAs busy on the last level at
//      n = 1024, where 128-wide ones would leave 16.
// 1 + 2 ceil(log2(n / 128)) launches, enqueued from C on the caller's
// stream with no host synchronisation. Every element of W is written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 128;         // diagonal block of one CTA (the TPU's _B)
constexpr int R = 32;          // sub-block one warp inverts
constexpr int SP = B + 1;      // shared row stride: column walks hit 32 banks
constexpr int LP = R + 4;      // row stride of a warp's column buffer (float4-aligned)
constexpr int TP = B / 2 + 4;  // row stride of the in-block T (float4-aligned)
constexpr int NT = 256;        // threads a CTA
constexpr int TM = 64;         // level output tile
constexpr int BK = 16;         // level k slice
constexpr int KP = TM + 4;     // staging row stride (float4-aligned)

struct DiagSmem {
  float s[B * SP];      // the diagonal block of L (lower triangle read)
  float w[B * SP];      // its inverse (strict upper never read, stored as 0)
  float t[B / 2 * TP];  // T of the in-block levels
  float lt[4][R * LP];  // each inverting warp's sub-block, transposed
};

// Lane c of one warp writes column c of the inverse of the (R, R)
// lower-triangular sub-block at s (row stride SP) to w (same stride), by
// forward substitution: W[j, c] = (delta_jc - acc[j]) / L[j, j], then
// acc[i] += L[i, j] W[j, c] for i > j. lt is the warp's (R, LP) buffer and
// receives L transposed first (lt[j][i] = L[i, j]). W[j, c] = 0 for j < c
// exactly, so the sub-block's strict upper comes out 0.
__device__ __forceinline__ void warp_invert(const float* s, float* w, float* lt) {
  const int c = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < R; ++j) lt[j * LP + c] = s[c * SP + j];
  __syncwarp();
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float wj = ((c == j ? 1.f : 0.f) - acc[j]) / lt[j * LP + j];
    w[j * SP + c] = wj;
#pragma unroll
    for (int q = (j + 1) / 4; q < R / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(&lt[j * LP + 4 * q]);
      const float lc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * q + u;
        if (i > j) acc[i] = fmaf(lc[u], wj, acc[i]);
      }
    }
  }
}

// One doubling level of width h inside the block (h = 32 or 64): for the
// B / (2h) pairs, T = L[C, A] W[A, A] (k >= the output column's 4-group:
// W[A, A] is lower), barrier, W[C, A] = -W[C, C] T (k below the output
// row's 4-group), barrier. 4 x 4 outputs a thread.
__device__ __forceinline__ void block_level(DiagSmem& sm, int h) {
  const int tid = threadIdx.x, g = h / 4, items = (B / (2 * h)) * g * g;
  for (int e = tid; e < items; e += NT) {
    const int p = e / (g * g), f = e % (g * g), r0 = 4 * (f % g), q0 = 4 * (f / g);
    const int a0 = 2 * h * p, c0 = a0 + h;
    float acc[4][4] = {};
    for (int k = q0; k < h; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = sm.s[(c0 + r0 + u) * SP + a0 + k];
        b[u] = sm.w[(a0 + k) * SP + a0 + q0 + u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float4*>(&sm.t[(h * p + r0 + u) * TP + q0]) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }
  __syncthreads();
  for (int e = tid; e < items; e += NT) {
    const int p = e / (g * g), f = e % (g * g), r0 = 4 * (f % g), q0 = 4 * (f / g);
    const int a0 = 2 * h * p, c0 = a0 + h;
    float acc[4][4] = {};
    for (int k = 0; k < r0 + 4; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&sm.t[(h * p + k) * TP + q0]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = sm.w[(c0 + r0 + u) * SP + c0 + k];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a, bv[v], acc[u][v]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) sm.w[(c0 + r0 + u) * SP + a0 + q0 + v] = -acc[u][v];
  }
  __syncthreads();
}

// W's 128 x 128 diagonal blocks: CTA i inverts L[128 i : 128 (i + 1)] (row
// stride ld, 16-byte aligned rows) into the same block of w, strict upper 0.
__global__ void __launch_bounds__(NT, 1) trtri_diag(const float* l, float* w, int64_t ld) {
  extern __shared__ __align__(16) unsigned char raw[];
  DiagSmem& sm = *reinterpret_cast<DiagSmem*>(raw);
  const int tid = threadIdx.x;
  const int64_t off = (int64_t)blockIdx.x * B * (ld + 1);
  constexpr int PER = B * B / 4 / NT;
  {  // every load in flight at once: 16 float4 a thread
    float4 v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * NT, r = e / (B / 4), c = 4 * (e % (B / 4));
      v[i] = *reinterpret_cast<const float4*>(l + off + r * ld + c);
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
  if (tid < 4 * 32) {
    const int q = tid / 32;
    warp_invert(sm.s + q * R * (SP + 1), sm.w + q * R * (SP + 1), sm.lt[q]);
  }
  __syncthreads();
  block_level(sm, R);
  block_level(sm, 2 * R);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * NT, r = e / (B / 4), c = 4 * (e % (B / 4));
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = c + u <= r ? sm.w[r * SP + c + u] : 0.f;
    *reinterpret_cast<float4*>(w + off + r * ld + c) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// One 64 x 64 output tile of a global level's product, k in [k0, k1) (a
// multiple of 16): acc = a[0:64, k0:k1] b[k0:k1, 0:64], a and b row-major
// at lda and ldb with 16-byte aligned rows. Thread (ty, tx) = (tid / 16,
// tid % 16) owns rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3. The
// next slice is loaded into registers while the current one is multiplied.
__device__ __forceinline__ void tile_product(const float* a, int64_t lda, const float* b,
                                             int64_t ldb, int k0, int k1, float (&acc)[4][4]) {
  __shared__ __align__(16) float as[2][BK][KP];  // a's slice, transposed
  __shared__ __align__(16) float bs[2][BK][KP];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ar = tid / 4, ak = 4 * (tid % 4);    // a: row, 4 k's
  const int bk = tid / 16, bc = 4 * (tid % 16);  // b: k, 4 columns
  float4 ra = *reinterpret_cast<const float4*>(a + ar * lda + k0 + ak);
  float4 rb = *reinterpret_cast<const float4*>(b + (k0 + bk) * ldb + bc);
  as[0][ak][ar] = ra.x;
  as[0][ak + 1][ar] = ra.y;
  as[0][ak + 2][ar] = ra.z;
  as[0][ak + 3][ar] = ra.w;
  *reinterpret_cast<float4*>(&bs[0][bk][bc]) = rb;
  __syncthreads();
  const int slices = (k1 - k0) / BK;
  for (int t = 0; t < slices; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < slices;
    if (more) {
      const int k = k0 + (t + 1) * BK;
      ra = *reinterpret_cast<const float4*>(a + ar * lda + k + ak);
      rb = *reinterpret_cast<const float4*>(b + (k + bk) * ldb + bc);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[cur][kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[cur][kk][4 * tx]);
      const float x[4] = {av.x, av.y, av.z, av.w}, y[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(x[u], y[v], acc[u][v]);
    }
    if (more) {  // the other buffer was last read before the previous barrier
      as[cur ^ 1][ak][ar] = ra.x;
      as[cur ^ 1][ak + 1][ar] = ra.y;
      as[cur ^ 1][ak + 2][ar] = ra.z;
      as[cur ^ 1][ak + 3][ar] = ra.w;
      *reinterpret_cast<float4*>(&bs[cur ^ 1][bk][bc]) = rb;
    }
    __syncthreads();
  }
}

// The pair and output tile of this CTA at level h: (p, m0, n0, a0, c0, cn)
// with cn = |C|; false for a tile below C's last row.
struct Tile {
  int p, m0, n0, a0, c0, cn;
};

__device__ __forceinline__ bool level_tile(int n, int h, Tile& t) {
  const int tiles = h / TM;
  t.p = blockIdx.y;
  t.m0 = TM * (blockIdx.x / tiles);
  t.n0 = TM * (blockIdx.x % tiles);
  t.a0 = 2 * h * t.p;
  t.c0 = t.a0 + h;
  t.cn = min(h, n - t.c0);
  return t.m0 < t.cn;
}

// T_p[m0 :, n0 :] = L[C, A] W[A, A] for k >= n0, into t (pair p at t + p h h,
// row stride h).
__global__ void __launch_bounds__(NT) trtri_level_t(const float* l, const float* w, float* t,
                                                    int n, int h) {
  Tile q;
  if (!level_tile(n, h, q)) return;
  float acc[4][4] = {};
  tile_product(l + (int64_t)(q.c0 + q.m0) * n + q.a0, n, w + (int64_t)q.a0 * n + q.a0 + q.n0, n,
               q.n0, h, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = t + (int64_t)q.p * h * h + (int64_t)(q.m0 + 4 * ty) * h + q.n0 + 4 * tx;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(out + u * h) = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
}

// W[C, A][m0 :, n0 :] = -W[C, C] T_p for k < m0 + 64, and zeros into the
// mirrored tile of W[A, C].
__global__ void __launch_bounds__(NT) trtri_level_w(float* w, const float* t, int n, int h) {
  Tile q;
  if (!level_tile(n, h, q)) return;
  float acc[4][4] = {};
  tile_product(w + (int64_t)(q.c0 + q.m0) * n + q.c0, n, t + (int64_t)q.p * h * h + q.n0, h, 0,
               q.m0 + TM, acc);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float* out = w + (int64_t)(q.c0 + q.m0 + 4 * ty) * n + q.a0 + q.n0 + 4 * tx;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(out + u * n) =
        make_float4(-acc[u][0], -acc[u][1], -acc[u][2], -acc[u][3]);
  float* zero = w + (int64_t)(q.a0 + q.n0) * n + q.c0 + q.m0;
#pragma unroll
  for (int i = 0; i < TM * TM / 4 / NT; ++i) {
    const int e = tid + i * NT, r = e / (TM / 4), c = 4 * (e % (TM / 4));
    *reinterpret_cast<float4*>(zero + (int64_t)r * n + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

extern "C" {

// The global levels h = 128, 256, ... while h < n, in place on w (whose
// 128 x 128 diagonal blocks hold their inverses, strict upper 0): two
// launches a level. l and w are (n, n) fp32, row-major, contiguous, 16-byte
// aligned, n a multiple of 128; scratch holds n^2 / 4 floats (T). Adds each
// launch enqueued to *launches (when not null); returns the first CUDA
// error (0 on success).
int npw_trtri_levels(int n, const void* l, void* w, void* scratch, void* stream, int* launches) {
  if (n % B) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lo = static_cast<const float*>(l);
  float* wo = static_cast<float*>(w);
  float* t = static_cast<float*>(scratch);
  for (int h = B; h < n; h *= 2) {
    const int pairs = (n - h + 2 * h - 1) / (2 * h), tiles = h / TM;
    const dim3 grid(tiles * tiles, pairs);
    trtri_level_t<<<grid, NT, 0, s>>>(lo, wo, t, n, h);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    if (launches) ++*launches;
    trtri_level_w<<<grid, NT, 0, s>>>(wo, t, n, h);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    if (launches) ++*launches;
  }
  return 0;
}

// W = L^-1 of the lower-triangular (n, n) l into w (strict upper 0), n a
// multiple of 128 up to 1024; l's strict upper is not read. l, w fp32,
// row-major, contiguous, 16-byte aligned, not overlapping; scratch holds
// n^2 / 4 floats. Enqueues 1 + 2 ceil(log2(n / 128)) launches on `stream`
// and adds each one enqueued to *launches (when not null); returns the
// first CUDA error (0 on success).
int npw_trtri(int n, const void* l, void* w, void* scratch, void* stream, int* launches) {
  if (n <= 0) return 0;
  if (n % B) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(sizeof(DiagSmem));
  cudaError_t err =
      cudaFuncSetAttribute(trtri_diag, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  trtri_diag<<<n / B, NT, smem, s>>>(static_cast<const float*>(l), static_cast<float*>(w), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (launches) ++*launches;
  return npw_trtri_levels(n, l, w, scratch, stream, launches);
}

}  // extern "C"
