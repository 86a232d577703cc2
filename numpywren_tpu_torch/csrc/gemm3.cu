// a @ op(b) at bf16x3 (fp32-parity) precision on Hopper's bf16 tensor cores,
// with an optional fused c - a @ op(b) epilogue.
//
// Replaces the Pallas kernel numpywren_tpu/ops/gemm3.py::matmul3 (_kernel and
// _split), the TPU path's "compensated" GEMM. Each fp32 operand element is
// split into bf16 hi + bf16 lo (hi = rn(x), lo = rn(x - hi)), and
//
//     a @ b  ~=  hi_a @ hi_b + hi_a @ lo_b + lo_a @ hi_b
//
// is summed in fp32 (lo_a @ lo_b is below fp32 epsilon). bf16 x bf16
// products are exact in fp32, so the result matches the plain fp32
// emulation (gemm3.py::matmul3_ref) up to summation order.
//
// Bound: bf16 tensor-core issue, three MMAs per product (989 TFLOP/s dense
// bf16 on an H100 SXM, so at most ~330 TFLOP/s of fp32-equivalent work).
// This first version keeps one 128 x 128 tile per SM with all threads both
// loading and multiplying, so barriers and the load issue cut into that.
//
// Design:
// - Two passes. `split_kernel` writes each operand's hi and lo as bf16
//   planes (rows x ldp, K padded with zeros to a multiple of 8) into a
//   workspace the wrapper allocates; B's planes are N-major whatever tb is.
//   The Pallas kernel splits in VMEM per block. Splitting inside the GEMM's
//   loop ran at half the speed of a GEMM over planes (a WMMA version on an
//   H100: 27 vs 57 TFLOP/s fp32-equivalent at 31744x1024 by 1024x1024),
//   because the conversions compete with the MMAs for issue slots. The
//   planes cost one extra read and write of each operand.
// - `gemm3_wgmma`: 2-D grid of 128 x 128 output tiles; two warpgroups each
//   own 64 rows and issue wgmma m64n128k16 (fp32 accumulators, 64 registers
//   a thread), three per 16-deep step, from shared memory. A loop over K in
//   64-deep slices replaces Pallas's sequential K axis. Each slice's four
//   plane tiles (A hi/lo, B hi/lo; 16 KB each) are K-major with 128-byte rows
//   in the 128-byte-swizzled layout the wgmma descriptors name, filled by
//   cp.async (16 bytes a thread, zero-filled past M, N and K). A ring of
//   three stages lets slice t+1 load while slice t multiplies.
// - Each slice's twelve MMAs start from zero (scale-d 0) and the slice's sum
//   is added into a second register accumulator with round-to-nearest fp32
//   adds once its MMAs finish (wgmma.wait_group 0). The tensor cores'
//   accumulation does not round to nearest, so summing all of K in one
//   wgmma accumulator gave an error that grew with K (2.9e-5 relative to an
//   fp64 product at K = 8192 on an H100, against 4.4e-6 for the same bf16x3
//   arithmetic rounded to nearest).
// - The epilogue writes c - acc (or acc) from the accumulator registers.
//   `out` may alias `c`: each element is read and written by one thread, once.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, NT = 256;
constexpr int STAGES = 3;
constexpr int TILE_BYTES = BM * BK * 2;          // one plane tile: 16 KB
constexpr int STAGE_BYTES = 4 * TILE_BYTES;      // a_hi, a_lo, b_hi, b_lo
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack
constexpr int CHUNKS_PER_T = 4 * BM * (BK / 8) / NT;     // 16-byte chunks

__device__ __forceinline__ void split(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// plane[r * ldp + c] = hi / lo of x(r, c), or of x(c, r) with `trans`;
// zero for cols <= c < ldp.
__global__ void split_kernel(const float* __restrict__ x, int64_t ldx, int rows, int cols,
                             int trans, __nv_bfloat16* __restrict__ hi,
                             __nv_bfloat16* __restrict__ lo, int ldp) {
  const int64_t total = (int64_t)rows * ldp;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(idx / ldp), c = (int)(idx % ldp);
    float v = 0.f;
    if (c < cols) v = trans ? x[(int64_t)c * ldx + r] : x[(int64_t)r * ldx + c];
    split(v, hi[idx], lo[idx]);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t saddr, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K-major tile, 128-byte rows, 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  uint64_t d = 0;
  d |= (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset (unused: swizzled K-major)
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

// out = acc or c - acc, acc = a_hi b_hiᵀ + a_hi b_loᵀ + a_lo b_hiᵀ over planes.
__global__ void __launch_bounds__(NT, 1)
    gemm3_wgmma(const __nv_bfloat16* __restrict__ a_hi, const __nv_bfloat16* __restrict__ a_lo,
                const __nv_bfloat16* __restrict__ b_hi, const __nv_bfloat16* __restrict__ b_lo,
                int ldp, const float* c, int64_t ldc, float* out, int64_t ldo, int m, int n,
                int k) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023u) & ~1023u;  // 128-byte swizzle wants 1 KB alignment
  const int tid = threadIdx.x;
  const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (k + BK - 1) / BK;

  auto load_stage = [&](int s, int k0) {
    const uint32_t st = sbase + s * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < CHUNKS_PER_T; ++i) {
      const int q = tid + i * NT;
      const int p = q / (BM * BK / 8), wq = q % (BM * BK / 8);
      const int row = wq / (BK / 8), j = wq % (BK / 8);
      const __nv_bfloat16* plane = p == 0 ? a_hi : p == 1 ? a_lo : p == 2 ? b_hi : b_lo;
      const int grow = (p < 2 ? m0 : n0) + row;
      const int col = k0 + j * 8;
      const bool ok = grow < (p < 2 ? m : n) && col < ldp;
      const __nv_bfloat16* src = ok ? plane + (int64_t)grow * ldp + col : plane;
      const uint32_t dst = st + p * TILE_BYTES + row * 128 + ((j ^ (row & 7)) << 4);
      cp_async16(dst, src, ok ? 16 : 0);
    }
  };

  // d holds one K slice's products (the tensor cores' accumulation is not
  // round-to-nearest: summed over all of K in d, the error grew with K, to
  // 2.9e-5 relative at K = 8192); acc sums the slices in fp32 on the CUDA
  // cores, round-to-nearest
  float d[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (ktiles > 0) load_stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // stage (t+1)%3 was last read by tile t-2's MMAs, finished before the barrier
    if (t + 1 < ktiles) load_stage((t + 1) % STAGES, (t + 1) * BK);
    cp_async_commit();
    const uint32_t st = sbase + (t % STAGES) * STAGE_BYTES;
    const uint64_t da_hi = make_desc(st + wg * 64 * 128);
    const uint64_t da_lo = make_desc(st + TILE_BYTES + wg * 64 * 128);
    const uint64_t db_hi = make_desc(st + 2 * TILE_BYTES);
    const uint64_t db_lo = make_desc(st + 3 * TILE_BYTES);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t off = (uint64_t)(ks * 32) >> 4;  // 16 bf16 along the swizzled row
      wgmma_m64n128(d, da_lo + off, db_hi + off, ks > 0);
      wgmma_m64n128(d, da_hi + off, db_lo + off, 1);
      wgmma_m64n128(d, da_hi + off, db_hi + off, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
  }

  // accumulator layout of m64nNk16: warp w of the group holds rows 16w..16w+15;
  // register 4j + {0,1} is (row l/4, cols 8j + 2(l%4) + {0,1}), 4j + {2,3} row + 8
  const int rbase = m0 + wg * 64 + w * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= n) continue;
        float v = acc[4 * j + 2 * h + e];
        if (c != nullptr) v = c[(int64_t)row * ldc + col + e] - v;
        out[(int64_t)row * ldo + col + e] = v;
      }
    }
  }
}

// The same for rows of 4 * q floats that are 16-byte aligned with no
// padding (cols % 8 == 0, so ldp == cols): one float4 in, 8 bytes out twice.
__global__ void split4_kernel(const float* __restrict__ x, int64_t ldx, int rows, int cols,
                              __nv_bfloat16* __restrict__ hi, __nv_bfloat16* __restrict__ lo) {
  const int q = cols / 4;
  const int64_t total = (int64_t)rows * q;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(idx / q), c = (int)(idx % q) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + (int64_t)r * ldx + c);
    __align__(8) __nv_bfloat16 h[4], l[4];
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
    const int64_t o = (int64_t)r * cols + c;
    *reinterpret_cast<uint2*>(hi + o) = *reinterpret_cast<const uint2*>(h);
    *reinterpret_cast<uint2*>(lo + o) = *reinterpret_cast<const uint2*>(l);
  }
}

void launch_split(const float* x, int64_t ldx, int rows, int cols, int trans, __nv_bfloat16* hi,
                  __nv_bfloat16* lo, int ldp, cudaStream_t s) {
  const bool vec = !trans && cols % 8 == 0 && ldx % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int64_t total = (int64_t)rows * (vec ? cols / 4 : ldp);
  int64_t blocks = (total + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (vec)
    split4_kernel<<<(unsigned)blocks, 256, 0, s>>>(x, ldx, rows, cols, hi, lo);
  else
    split_kernel<<<(unsigned)blocks, 256, 0, s>>>(x, ldx, rows, cols, trans, hi, lo, ldp);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// c may be null (no subtract) and may equal out. `workspace` holds
// 2 * (m + n) * ldp bf16 values, ldp = k rounded up to a multiple of 8.
int npw_gemm3(int tb, const float* a, long long lda, const float* b, long long ldb,
              const float* c, long long ldc, float* out, long long ldo, int m, int n, int k,
              void* workspace, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ldp = ((k + 7) / 8) * 8;
  __nv_bfloat16* a_hi = static_cast<__nv_bfloat16*>(workspace);
  __nv_bfloat16* a_lo = a_hi + (int64_t)m * ldp;
  __nv_bfloat16* b_hi = a_lo + (int64_t)m * ldp;
  __nv_bfloat16* b_lo = b_hi + (int64_t)n * ldp;
  if (k > 0) {
    launch_split(a, lda, m, k, 0, a_hi, a_lo, ldp, s);
    launch_split(b, ldb, n, k, tb ? 0 : 1, b_hi, b_lo, ldp, s);
  }
  cudaFuncSetAttribute(gemm3_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  const dim3 grid(npw::cdiv(n, BN), npw::cdiv(m, BM));
  gemm3_wgmma<<<grid, NT, SMEM_BYTES, s>>>(a_hi, a_lo, b_hi, b_lo, ldp, c, ldc, out, ldo, m, n,
                                           k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
