// Pieces of the pipelined bf16 matrix products (matmul_stats.cu,
// matmul_stats_bwd.cu): 16-byte asynchronous copies into a ring of
// shared-memory stages, XOR-swizzled tiles read with ldmatrix, and the
// tensor cores' m16n8k16 product fed from register fragments.
//
// Every kernel built on these runs 256 threads as 8 warps in a 4 x 2 grid
// over a 128-row tile; a warp owns 32 rows and half the tile's columns, in
// MI = 2 row fragments of 16 and NJ column fragments of 8. Fragment
// layouts (PTX ISA, mma.m16n8k16, bf16): with lane = 4*g + t,
//   A (16 x 16): reg 0 = (row g,   k 2t, 2t+1)   reg 1 = (row g+8, k 2t..)
//                reg 2 = (row g,   k 2t+8, +9)   reg 3 = (row g+8, k 2t+8..)
//   B (16 x 8):  reg 0 = (k 2t, 2t+1; col g)     reg 1 = (k 2t+8, +9; col g)
//   C (16 x 8):  c0, c1 = (row g, col 2t, 2t+1)  c2, c3 = (row g+8, ...)
// so a transform of an operand element knows its row and column from the
// lane alone.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace rt {

constexpr int kWarpsM = 4, kWarpsN = 2;  // the 4 x 2 warp grid
constexpr int kWarpRows = 32;            // rows of a warp: MI = 2 fragments
constexpr int kMI = kWarpRows / 16;

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros where !ok (no bytes are
// read then, and `fallback`, any valid address, stands in for `src`).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok, const void* fallback) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(ok ? src : fallback), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// swizzled tiles
// ---------------------------------------------------------------------------

// Element offset of 16-byte chunk `c` of row `r` in a bf16 tile of CPR
// chunks a row (a multiple of 8): within each group of 8 chunks the chunk
// index is XORed with the row's low 3 bits, so the 8 rows an ldmatrix
// phase reads at one logical chunk hit 8 distinct bank groups.
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CPR % 8 == 0, "swizzled rows are whole groups of 8 chunks");
  return r * CPR * 8 + (((c & ~7) | ((c ^ r) & 7)) << 3);
}

// ---------------------------------------------------------------------------
// ldmatrix and mma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a @ b, 16 x 8 x 16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's element offset for an x4 ldmatrix of fragments of a swizzled
// tile, at the first k step and the first fragment of its warp. Because a
// fragment's 8-row phases start at multiples of 8 rows and its chunk pairs
// at even chunks, the other steps and fragments follow from this base by an
// XOR of (s << 4) on the chunk bits, where the chunk pair moves by s, and an
// add where whole 16-row groups move: the kernels keep one base register an
// operand instead of one address for every (k step, fragment).
//
// A stored [row][k], no transpose: rows row0..row0+15, k chunks 0, 1;
//   k step kk: ^ (kk << 4); fragment i (16 rows further): + i*16*pitch.
template <int CPR>
__device__ __forceinline__ int a_frag_base(int row0, int lane) {
  return swz<CPR>(row0 + (lane & 15), lane >> 4);
}

// A stored [k][row], read with .trans: rows (stored chunks) from chunk0 on,
// k rows 0..15; fragment i (2 chunks further): ^ (i << 4); k step kk:
// + kk*16*pitch. chunk0 is a multiple of 4.
template <int CPR>
__device__ __forceinline__ int at_frag_base(int chunk0, int lane) {
  return swz<CPR>((lane & 7) + ((lane >> 4) << 3), chunk0 + ((lane >> 3) & 1));
}

// Two B fragments (columns col0..col0+15) of B stored [col][k], no
// transpose, regs {b[j][0], b[j][1], b[j+1][0], b[j+1][1]}: k step kk:
// ^ (kk << 4); the next pair (16 columns further): + 16*pitch.
template <int CPR>
__device__ __forceinline__ int b_frag_base(int col0, int lane) {
  return swz<CPR>(col0 + (lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
}

// Two B fragments of B stored [k][col], read with .trans, the same register
// order: columns (stored chunks) from chunk0 on, k rows 0..15; the next pair
// (2 chunks further): ^ (jj << 4); k step kk: + kk*16*pitch. chunk0 is a
// multiple of 4.
template <int CPR>
__device__ __forceinline__ int bt_frag_base(int chunk0, int lane) {
  return swz<CPR>((lane & 7) + (((lane >> 3) & 1) << 3), chunk0 + (lane >> 4));
}

// Zero a warp's accumulators.
template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[kMI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// ---------------------------------------------------------------------------
// elementwise transforms of a bf16x2 fragment register
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// round-to-nearest-even; the lower half holds the lower column
__device__ __forceinline__ uint32_t f2_to_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// [relu](x*a + b) of both elements, rounded to bf16 (the forward prologue)
template <bool RELU>
__device__ __forceinline__ uint32_t prologue2(uint32_t v, float a0, float a1,
                                              float b0, float b1) {
  const float2 x = bf2_to_f2(v);
  float h0 = mul_add(x.x, a0, b0), h1 = mul_add(x.y, a1, b1);
  if (RELU) {
    h0 = fmaxf(h0, 0.0f);
    h1 = fmaxf(h1, 0.0f);
  }
  return f2_to_bf2(h0, h1);
}

// g = gy + gs + 2*y*gss of both elements, rounded to bf16, given gss2 =
// 2*gss: (2*y)*gss and y*(2*gss) are the same exact product (doubling is
// exact), so they round alike, and the doubling is paid once a column
// instead of once an element.
__device__ __forceinline__ uint32_t fold2(uint32_t gy, uint32_t y, float gs0,
                                          float gs1, float gss2_0,
                                          float gss2_1) {
  const float2 g = bf2_to_f2(gy), yv = bf2_to_f2(y);
  return f2_to_bf2(__fadd_rn(__fadd_rn(g.x, gs0), __fmul_rn(yv.x, gss2_0)),
                   __fadd_rn(__fadd_rn(g.y, gs1), __fmul_rn(yv.y, gss2_1)));
}

// ---------------------------------------------------------------------------
// epilogue pieces
// ---------------------------------------------------------------------------

// Sum over the 8 row groups of a warp (lanes 4*g + t, g = 0..7): every lane
// ends with the same bits, the sum taken in one fixed order.
__device__ __forceinline__ float sum_over_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Column sums of a block tile: each warp has put its 32 rows' sums of NV
// quantities into red[(q * kWarpsM + wm) * BN + col]; after a barrier,
// thread t < NV*BN returns the sum over the 4 warp rows, in order, of
// quantity t / BN, column t % BN.
template <int BN, int NV>
__device__ __forceinline__ float reduce_warp_rows(const float* red) {
  static_assert(NV * BN <= kThreads, "one thread per reduced column");
  float total = 0.0f;
  if (threadIdx.x < NV * BN) {
    const int q = threadIdx.x / BN, col = threadIdx.x % BN;
#pragma unroll
    for (int w = 0; w < kWarpsM; ++w) total += red[(q * kWarpsM + w) * BN + col];
  }
  return total;
}

// A warp's 32 x WTN bf16 results through its own padded staging buffer to
// device memory in 16-byte chunks: v[i][j][e] is the fragment value at row
// 16i + 8(e/2) + g, column 8j + 2t + e%2 of the warp's tile, whose corner
// is (row0, col0) of `out` (R rows, C columns, row-major); rows past R and
// chunks past C are not written.
template <int WTN>
__device__ __forceinline__ void store_warp_tile(
    const float (&v)[kMI][WTN / 8][4], bf16* stage, bf16* out, int row0,
    int col0, int R, int C) {
  constexpr int P = WTN + 8;  // padded row: 16 bytes off the banks' period
  constexpr int CPRO = WTN / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();  // the previous tile's reads of `stage` are done
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < CPRO; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(stage + (16 * i + 8 * h + g) * P +
                                     8 * j + 2 * t) =
            f2_to_bf2(v[i][j][2 * h], v[i][j][2 * h + 1]);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < kWarpRows * CPRO / 32; ++it) {
    const int c = lane + 32 * it;
    const int r = c / CPRO, cc = (c % CPRO) * 8;
    if (row0 + r < R && col0 + cc < C)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * C + col0 + cc) =
          *reinterpret_cast<const uint4*>(stage + r * P + cc);
  }
}

// Bytes of one warp's staging buffer for store_warp_tile<WTN>.
template <int WTN>
__host__ __device__ constexpr int warp_stage_bytes() {
  return kWarpRows * (WTN + 8) * 2;
}

// Allow `kernel` `bytes` of dynamic shared memory (above the default 48 KB)
// on the current device, once a device: `done` is one static array of the
// calling launch function, so one per kernel instantiation.
constexpr int kMaxDevices = 64;
template <typename Kernel>
inline int allow_dynamic_smem(Kernel kernel, int bytes,
                              bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return static_cast<int>(err);
}

}  // namespace rt
