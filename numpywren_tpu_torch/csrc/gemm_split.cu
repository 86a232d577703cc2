// out = alpha * op(A) @ op(B) + beta * C on Hopper's bf16 tensor cores, as
// the TPU computes it: a split product of P bf16 planes an operand.
//
// Replaces two Pallas kernels of the JAX package:
// - numpywren_tpu/ops/gemm.py::matmul (_mm_kernel): P = 3 for fp32 at
//   precision HIGHEST (bf16x6), P = 1 for bf16 (DEFAULT: one MXU pass);
// - numpywren_tpu/ops/gemm3.py::matmul3 (_kernel, _split): P = 2 (bf16x3),
//   with alpha = -1, beta = 1 for the Cholesky trailing update c - a bᵀ.
// It is also the apply of the CholeskyQR2 chain (cholqr_chain.cu, P = 3 as
// the TPU's HIGHEST), called from C.
// Plane p of x is rn(x - the planes before it): at P = 3 hi, mid, lo
// (hi + mid + lo = x exactly while lo is a normal bf16, |x| >= ~2^-110), at
// P = 2 hi and lo, exactly matmul3's _split. The plane pairs (i, j) with
// i + j < P are multiplied: hh, hm, mh, hl, mm, lh at P = 3 (the dropped
// ml, lm, ll are below 2^-24 relative), hh, hl, lh at P = 2 (ll is below
// fp32's epsilon; lo's rounding leaves ~2^-16 relative a product). bf16 x
// bf16 products are exact in fp32.
//
// Bound: bf16 tensor-core issue, P(P+1)/2 products (989 TFLOP/s dense bf16
// on an H100 SXM): at 31744x1024 by 1024 six products take 0.404 ms, three
// 0.202, both under the FP32 FFMA bound of 0.994 ms for the same product.
// At 128 x 128 tiles a slice of depth 64 loads 2 * 128 * 64 * 2 * P bytes
// for 2 * 128 * 128 * 64 * P(P+1)/2 flops, 64 (P+1) flops a byte of shared
// memory, so loads must overlap the products: a producer warpgroup keeps
// TMA loads in flight while two consumer warpgroups multiply.
//
// Design:
// - Two passes. `gemm_split_pack_*` writes each operand's planes, K-major
//   ((rows, kp) per plane, op(A) as M x kp and op(B) as N x kp whatever ta
//   and tb are, the leading dimension folded in), K zero-padded to a
//   multiple of the slice depth. The mainloop then sees one layout. The
//   planes cost one extra read of each operand and a write of P bf16 per
//   element (~0.1 ms for both operands at 31744x1024, P = 3).
// - The mainloop's entry takes each operand's plane stride apart from its
//   row count. So one packed panel serves many products: the Cholesky packs
//   each panel b once at P = 2, and every trailing update c -= b[off:]
//   b[off:off+w]ᵀ maps rows [off, R) as A and [off, off + w) as B of the
//   same planes, R * kp apart (the base stays 128-byte aligned: kp is a
//   multiple of 64). TMA zero-fills rows past each map's count.
// - `gemm_split_mainloop`: one 128 x 128 output tile per CTA of three
//   warpgroups. Warpgroup 0 is the producer (setmaxnreg down to 40): one
//   thread issues TMA loads (cp.async.bulk.tensor over a CUtensorMap passed
//   as a __grid_constant__ parameter) of every plane's A and B tile for a
//   K slice into a ring of stages with full/empty mbarriers. Warpgroups 1-2
//   (setmaxnreg up to 232) each own 64 rows and issue wgmma m64n128k16 from
//   shared memory, 2 P(P+1) per slice (four k16 steps a pair), smallest
//   products first.
// - Slices are 64 deep: one 128 x 64 plane tile is 16 KB with 128-byte
//   rows (TMA's and wgmma's 128-byte swizzle). The ring has 192 KB: at
//   P = 3 a stage holds six tiles (96 KB) and the ring two; at P = 2 four
//   tiles (64 KB) and three stages, 197,680 bytes of dynamic shared memory
//   with the barriers and the alignment slack, of the 232,448 a block may
//   use; at P = 1 a stage is 32 KB and the ring six. Measured at
//   31744x1024 by 1024, P = 3, on an H100
//   (numpywren_tpu_torch/experiments/gemm_slice_depth.py), 32-deep
//   slices (64-byte swizzle, four 48 KB stages) took the same time within
//   1% and had a larger error against fp64 (2.96e-7 against 2.21e-7 at
//   K = 8192): twice the flushes, each a round-to-nearest add of a
//   truncated slice sum.
// - Each slice's products start from zero (scale-d 0) and the slice's sum
//   is added into a register fp32 sum with round-to-nearest adds once its
//   MMAs finish. The tensor cores' accumulation truncates (over all of K
//   in one accumulator the bf16x3 error grew to 2.9e-5 at K = 8192 on an
//   H100, against 4.4e-6 rounded to nearest). Within a slice the small
//   products go first (pair outer, k16 step inner), so only the four hh
//   steps truncate at the slice's full magnitude.
// - The flush doubles the accumulator registers (64 + 64 a thread at
//   n = 128), so 128 x 256 tiles do not fit a consumer's 232 registers.
// - Epilogue: alpha * acc + beta * C from registers, masked at ragged M and
//   N, written as fp32 or bf16 (__float2bfloat16_rn), two neighbouring
//   columns a store where the layout allows. `out` may alias `c`: each
//   element is read and written once, by one thread. With alpha = -1 and
//   beta = 1 it is c - acc, rounded once, as matmul3_ref computes.
// - The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint (the library does not link
//   libcuda).
// - A barrier wait that has not completed after ~10 s of clock traps, so a
//   pipeline fault becomes a launch error instead of a hang.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 64;  // output tile; slice depth (128 bytes of bf16)
constexpr int NT = 384;                     // producer warpgroup + two consumer warpgroups
constexpr int TILE_BYTES = BM * BK * 2;     // one plane's 128 x 64 tile (BN == BM)
constexpr int RING_BUDGET = 192 * 1024;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr long long WAIT_CYCLES = 20000000000LL;  // ~10 s

template <int P>
struct Ring {
  static constexpr int STAGE_BYTES = 2 * P * TILE_BYTES;
  static constexpr int STAGES = RING_BUDGET / STAGE_BYTES < 8 ? RING_BUDGET / STAGE_BYTES : 8;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + alignment
};

// The q-th plane pair, smallest products first: (i, s - i) for s = P-1 .. 0.
__host__ __device__ constexpr int pair_plane(int p, int q, bool second) {
  for (int s = p - 1; s >= 0; --s) {
    if (q <= s) return second ? s - q : q;
    q -= s + 1;
  }
  return 0;
}

template <int P>
__device__ __forceinline__ void split(float x, bf16 (&o)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    o[p] = __float2bfloat16_rn(x);
    x -= __bfloat162float(o[p]);  // exact in fp32
  }
}

__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* src, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const bf16* h = reinterpret_cast<const bf16*>(&a);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}

// planes[p][r][k] = plane p of x(r, k), x(r, k) at x[r * ldx + k]; 0 for
// cols <= k < kp. One thread per 8 consecutive k, 16 bytes a plane.
template <typename TIn, int P>
__global__ void gemm_split_pack_rows(const TIn* __restrict__ x, int64_t ldx, int rows, int cols,
                                     int kp, int vec, bf16* __restrict__ planes) {
  const int chunks = kp / 8;
  const int64_t total = (int64_t)rows * chunks, plane = (int64_t)rows * kp;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(idx / chunks), k0 = (int)(idx % chunks) * 8;
    const TIn* src = x + (int64_t)r * ldx + k0;
    float v[8];
    if (vec && k0 + 8 <= cols) {
      load8(src, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = k0 + e < cols ? npw::to_f32(src[e]) : 0.f;
    }
    __align__(16) bf16 o[P][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      bf16 s[P];
      split<P>(v[e], s);
#pragma unroll
      for (int p = 0; p < P; ++p) o[p][e] = s[p];
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint4*>(planes + p * plane + (int64_t)r * kp + k0) =
          *reinterpret_cast<const uint4*>(o[p]);
  }
}

// The same for x(r, k) at x[k * ldx + r] (op = transpose): a 32 x 32 tile
// through shared memory, read along r and written along k.
template <typename TIn, int P>
__global__ void gemm_split_pack_cols(const TIn* __restrict__ x, int64_t ldx, int rows, int cols,
                                     int kp, bf16* __restrict__ planes) {
  __shared__ float t[32][33];
  const int r0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int64_t plane = (int64_t)rows * kp;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, r = r0 + tx;
    t[i][tx] = (k < cols && r < rows) ? npw::to_f32(x[(int64_t)k * ldx + r]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i;
    if (r >= rows) continue;
    bf16 s[P];
    split<P>(t[tx][i], s);
#pragma unroll
    for (int p = 0; p < P; ++p) planes[p * plane + (int64_t)r * kp + k0 + tx] = s[p];
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WAIT_CYCLES) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row), "r"(plane)
      : "memory");
}

// K-major tile, 128-byte rows, 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  uint64_t d = 0;
  d |= (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;           // leading byte offset (unused: swizzled K-major)
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset: next 8-row group
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

// d = a b + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void load2(const float* p, float& x, float& y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x, y = v.y;
}
__device__ __forceinline__ void load2(const bf16* p, float& x, float& y) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  x = __low2float(v), y = __high2float(v);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// out = alpha * sum over the pair schedule of A_i B_jᵀ + beta * c, the
// planes read through map_a ((kp, m, P)) and map_b ((kp, n, P)).
template <int P, typename TOut>
__global__ void __launch_bounds__(NT, 1)
    gemm_split_mainloop(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b, int m, int n, int slices,
                        const TOut* c, int64_t ldc, TOut* out, int64_t ldo, float alpha,
                        float beta, int vec2) {
  using R = Ring<P>;
  constexpr int PAIRS = P * (P + 1) / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t full = ring + R::STAGES * R::STAGE_BYTES;
  const uint32_t empty = full + 8 * R::STAGES;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(empty + 8 * s, 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      for (int t = 0; t < slices; ++t) {
        const int s = t % R::STAGES;
        mbar_wait(empty + 8 * s, ((t / R::STAGES) & 1) ^ 1);
        const uint32_t st = ring + s * R::STAGE_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, R::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load(st + p * TILE_BYTES, &map_a, bar, t * BK, m0, p);
          tma_load(st + (P + p) * TILE_BYTES, &map_b, bar, t * BK, n0, p);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of the tile
    // d holds one slice's products (the tensor cores' accumulation
    // truncates); acc sums the slices in fp32, round-to-nearest
    float d[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int t = 0; t < slices; ++t) {
      const int s = t % R::STAGES;
      mbar_wait(full + 8 * s, (t / R::STAGES) & 1);
      const uint32_t st = ring + s * R::STAGE_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        const uint64_t da = make_desc(st + pair_plane(P, q, false) * TILE_BYTES + cw * 64 * 128);
        const uint64_t db = make_desc(st + (P + pair_plane(P, q, true)) * TILE_BYTES);
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)  // 16 bf16 = 32 bytes along the swizzled row
          wgmma_m64n128(d, da + ks * 2, db + ks * 2, q > 0 || ks > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += d[i];
    }

    // accumulator layout of m64nNk16: warp w of the group holds rows 16w..16w+15;
    // register 4j + {0,1} is (row l/4, cols 8j + 2(l%4) + {0,1}), 4j + {2,3} row + 8
    const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int rbase = m0 + cw * 64 + w * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + 8 * h;
        if (row >= m) continue;
        float v0 = alpha * acc[4 * j + 2 * h], v1 = alpha * acc[4 * j + 2 * h + 1];
        if (vec2 && col + 1 < n) {
          if (c != nullptr) {
            float c0, c1;
            load2(c + (int64_t)row * ldc + col, c0, c1);
            v0 += beta * c0;
            v1 += beta * c1;
          }
          store2(out + (int64_t)row * ldo + col, v0, v1);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= n) continue;
            float v = e ? v1 : v0;
            if (c != nullptr) v += beta * npw::to_f32(c[(int64_t)row * ldc + col + e]);
            out[(int64_t)row * ldo + col + e] = npw::from_f32<TOut>(v);
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (kp, rows, planes) bf16 planes, `plane_stride` elements apart, as a
// 3-D tensor map with (64, 128, 1) boxes in the 128-byte swizzle.
int encode(CUtensorMap* map, const void* planes, int rows, int kp, int64_t plane_stride, int p) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {(cuuint64_t)kp, (cuuint64_t)rows, (cuuint64_t)p};
  const cuuint64_t strides[2] = {(cuuint64_t)kp * 2, (cuuint64_t)plane_stride * 2};
  const cuuint32_t box[3] = {BK, BM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(planes), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename TIn, int P>
int launch_pack(int trans, const void* xv, int64_t ldx, int rows, int cols, int kp, bf16* planes,
                cudaStream_t s) {
  const TIn* x = static_cast<const TIn*>(xv);
  if (trans) {
    const dim3 grid(npw::cdiv(rows, 32), kp / 32);
    gemm_split_pack_cols<TIn, P><<<grid, 256, 0, s>>>(x, ldx, rows, cols, kp, planes);
  } else {
    const int vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && ldx % (16 / sizeof(TIn)) == 0;
    const int64_t total = (int64_t)rows * (kp / 8);
    int64_t blocks = (total + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    gemm_split_pack_rows<TIn, P><<<(unsigned)blocks, 256, 0, s>>>(x, ldx, rows, cols, kp, vec,
                                                                  planes);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int P, typename TOut>
int launch_mainloop(const void* a_planes, int64_t a_stride, const void* b_planes,
                    int64_t b_stride, int kp, const void* cv, int64_t ldc, void* outv,
                    int64_t ldo, int m, int n, float alpha, float beta, cudaStream_t s) {
  auto kernel = gemm_split_mainloop<P, TOut>;
  static int ready = -1;  // the kernel's set-up, once per process (host time)
  if (ready != 0) {
    // setmaxnreg moves registers inside the CTA's pool: a pool smaller than
    // what the consumers ask for would block them forever
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess && attr.numRegs * NT < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS)
      err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Ring<P>::SMEM);
    ready = static_cast<int>(err);
    if (ready != 0) return ready;
  }
  CUtensorMap map_a, map_b;
  int rc = encode(&map_a, a_planes, m, kp, a_stride, P);
  if (rc == 0) rc = encode(&map_b, b_planes, n, kp, b_stride, P);
  if (rc != 0) return rc;
  const TOut* c = static_cast<const TOut*>(cv);
  TOut* out = static_cast<TOut*>(outv);
  const uintptr_t pair = 2 * sizeof(TOut);
  const int vec2 = ldo % 2 == 0 && reinterpret_cast<uintptr_t>(out) % pair == 0 &&
                   (c == nullptr || (ldc % 2 == 0 && reinterpret_cast<uintptr_t>(c) % pair == 0));
  const dim3 grid(npw::cdiv(n, BN), npw::cdiv(m, BM));
  kernel<<<grid, NT, Ring<P>::SMEM, s>>>(map_a, map_b, m, n, kp / BK, c, ldc, out, ldo, alpha,
                                         beta, vec2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The slice depth, the ring's stages and the mainloop's dynamic shared
// bytes at `planes` (1, 2 or 3) planes; returns 0, or an error for another P.
int npw_gemm_split_plan(int planes, int* slice, int* stages, int* smem_bytes) {
  *slice = BK;
  switch (planes) {
    case 1: *stages = Ring<1>::STAGES, *smem_bytes = Ring<1>::SMEM; return 0;
    case 2: *stages = Ring<2>::STAGES, *smem_bytes = Ring<2>::SMEM; return 0;
    case 3: *stages = Ring<3>::STAGES, *smem_bytes = Ring<3>::SMEM; return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Pack x into `planes` bf16 planes (rows, kp) each, rows * kp apart,
// K-major: op(x)(r, k) is x[r * ldx + k], or x[k * ldx + r] with `trans`;
// cols <= kp, kp a multiple of the slice depth, zeros past cols. fp32 x
// gives 2 (hi, lo) or 3 (hi, mid, lo) planes, bf16 x one. `planes_out` is
// 16-byte aligned. Launches once on `stream` (none for rows == 0) and adds
// each launch enqueued to *launches (when not null); returns
// cudaGetLastError() (0 on success).
int npw_gemm_pack(int in_bf16, int planes, int trans, const void* x, long long ldx, int rows,
                  int cols, int kp, void* planes_out, void* stream, int* launches) {
  if (rows <= 0) return 0;
  if (kp <= 0 || kp % BK || kp < cols || cols < 0 || kp / 32 > 65535 ||
      (in_bf16 ? planes != 1 : planes != 2 && planes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* out = static_cast<bf16*>(planes_out);
  const int err = in_bf16       ? launch_pack<bf16, 1>(trans, x, ldx, rows, cols, kp, out, s)
                  : planes == 2 ? launch_pack<float, 2>(trans, x, ldx, rows, cols, kp, out, s)
                                : launch_pack<float, 3>(trans, x, ldx, rows, cols, kp, out, s);
  if (err == 0 && launches) ++*launches;
  return err;
}

// out = alpha * acc + beta * c over npw_gemm_pack's planes: op(A)'s m rows
// of kp at a_planes, its planes a_stride elements apart, op(B)'s n rows at
// b_planes, b_stride apart (a stride may exceed rows * kp: rows of a larger
// packed panel); acc is the sum of the plane pairs (i, j) with
// i + j < planes, planes 1, 2 or 3. c (may be null, may equal out) and out
// are fp32, or bf16 with out_bf16. Launches once on `stream` (none for m or
// n == 0) and adds each launch enqueued to *launches (when not null);
// returns the first CUDA error (0 on success).
int npw_gemm_split(int planes, int out_bf16, const void* a_planes, long long a_stride,
                   const void* b_planes, long long b_stride, int kp, const void* c,
                   long long ldc, void* out, long long ldo, int m, int n, float alpha,
                   float beta, void* stream, int* launches) {
  if (m <= 0 || n <= 0) return 0;
  if (kp <= 0 || kp % BK || planes < 1 || planes > 3 || npw::cdiv(m, BM) > 65535 ||
      a_stride < (long long)m * kp || b_stride < (long long)n * kp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NPW_MAINLOOP(P, T)                                                                   \
  launch_mainloop<P, T>(a_planes, a_stride, b_planes, b_stride, kp, c, ldc, out, ldo, m, n, \
                        alpha, beta, s)
  int err;
  switch (planes * 2 + (out_bf16 != 0)) {
    case 2: err = NPW_MAINLOOP(1, float); break;
    case 3: err = NPW_MAINLOOP(1, bf16); break;
    case 4: err = NPW_MAINLOOP(2, float); break;
    case 5: err = NPW_MAINLOOP(2, bf16); break;
    case 6: err = NPW_MAINLOOP(3, float); break;
    default: err = NPW_MAINLOOP(3, bf16); break;
  }
#undef NPW_MAINLOOP
  if (err == 0 && launches) ++*launches;
  return err;
}

}  // extern "C"
