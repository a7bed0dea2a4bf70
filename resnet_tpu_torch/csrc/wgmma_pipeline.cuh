// The Hopper mainloop of the bf16 matrix products (matmul_stats.cu,
// matmul_stats_bwd.cu): TMA tile loads into a ring of shared-memory stages
// whose completion is reported to mbarriers, one producer warp that keeps
// the loads in flight, and two consumer warpgroups that run the tensor
// cores' asynchronous warpgroup product (wgmma, m64nNk16, bf16 in, float32
// accumulate) on the stages that have arrived, with both operands read
// from shared memory through descriptors.
//
// Every kernel built on these runs 384 threads: warpgroup 0 is the
// producer (one thread issues the copies; the group gives up registers
// with setmaxnreg, and its warps 1-3 can transform the stages that
// arrive), warpgroups 1 and 2 are the consumers, each owning 64 rows of
// the block's 128-row output tile, a warp 16 of them.
//
// Stages hold 64 x 64 bf16 boxes (128-byte rows) copied by TMA with the
// 128-byte swizzle: within each 1024-byte atom of 8 rows, 16-byte chunk c
// of row r lies at chunk c ^ (r % 8) (box_chunk). A tile wider than 64
// columns is loaded as boxes one after another. An operand that the
// function transforms first is rewritten in place, chunk by chunk, and
// made visible to wgmma by an async-proxy fence before a barrier: the
// BatchNorm prologue of x by the producer's transform warps, which hand
// each stage on through a `ready` barrier; the fold of the statistics'
// cotangents into gy (two operands read, more arithmetic) by the consumer
// warpgroup that reads it, where 96 threads were too few. Every product
// then reads shared memory, so one group of a warpgroup's products stays
// in flight while the next stage is prepared. Results leave by TMA stores
// of swizzled boxes.
//
// The float32 accumulator of m64nNk16 holds, for lane = 4*g + t of warp w
// of the warpgroup and each block j of 8 columns, d[4j], d[4j+1] = (row
// 16w + g, col 8j+2t, +1) and d[4j+2], d[4j+3] = (row 16w + g + 8, ...):
// an epilogue knows each element's row and column from the lane alone.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace rt {

constexpr int kWgThreads = 128;                   // threads of a warpgroup
constexpr int kConsumerWarps = 8;                 // two consumer warpgroups
constexpr int kBlockThreads = 3 * kWgThreads;     // producer + 2 consumers
// the producer warpgroup's warps 1-3 transform the stages that arrive
constexpr int kTransformWarps = 3, kTransformThreads = 32 * kTransformWarps;
constexpr int kBK = 64;                           // columns of a box
constexpr int kBoxBytes = 64 * kBK * 2;           // a 64 x 64 bf16 box
constexpr int kBoxChunks = kBoxBytes / 16;        // its 16-byte chunks
constexpr int kAtomBytes = 1024;                  // 8 swizzled 128-byte rows
// registers a thread after setmaxnreg: 128 * 56 + 256 * 224 <= 65536
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// shared memory, barriers, copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (a kernel's shared memory
// budget keeps 1024 bytes for this): the swizzle atoms' alignment.
__device__ __forceinline__ unsigned char* align_atoms(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + (((s + kAtomBytes - 1) & ~(kAtomBytes - 1)) - s);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The producer's arrival on a stage's barrier, with the bytes its copies
// will deliver (boxes partly or wholly outside the matrix count in full:
// TMA fills them with zeros).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One 64 x 64 box of a matrix described by `map`, columns c0.., rows
// r0.., into shared memory at dst (1024-byte aligned), reported to bar.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(r0)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous memory at src (16-byte aligned)
// into shared memory at dst, reported to bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The 256 consumer threads' own barrier (id 0 is __syncthreads').
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWgThreads) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand in shared memory: start address,
// leading and stride byte offsets, all >> 4; layout type 1 = 128B swizzle.
//   K-major (rows of the product's M or N, 64-deep k in one 128-byte row):
//     stride = 1024 (the next 8 rows); leading unused. A 16-deep k step
//     adds 32 bytes to the start.
//   MN-major (a 128-byte row is 64 of M or N, rows run along k, read with
//     the transpose bit): stride = 1024 (the next 8 k), leading = the bytes
//     from one 64-column box to the next. A 16-deep k step adds 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lead,
                                               uint32_t stride) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// this point (wgmma writes them asynchronously, unseen by the compiler).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N float32) = A (64 x 16) @ B (16 x N) [+ d if accumulate], N =
// 2 * R, both operands read through descriptors; TRANS_A = 1 reads A
// MN-major, TRANS_B = 1 B. A tile's first product starts the sum with
// accumulate = 0: no other instruction writes the accumulators, which
// would make the compiler serialize the products.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
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
// in-place transforms, stores
// ---------------------------------------------------------------------------

// Byte offset of chunk c of a run of 64 x 64 boxes, one after another:
// box c / 512, row (c / 8) % 64, 16-byte chunk c % 8 (columns 8 * (c % 8)
// on), swizzled.
__device__ __forceinline__ int box_chunk(int c) {
  const int r = (c >> 3) & 63;
  return (c >> 9) * kBoxBytes + r * 128 + ((((c & 7) ^ r) & 7) << 4);
}

// A transform warp's end of a stage: its writes made visible to wgmma,
// then its arrival on the stage's `ready` barrier (kTransformWarps).
__device__ __forceinline__ void transformed(uint64_t* ready) {
  fence_async_smem();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(ready);
}

// The 8 floats of v from i on (i a multiple of 4), zeros where !ok.
__device__ __forceinline__ void load8(float (&out)[8], const float* v, int i,
                                      bool ok) {
#pragma unroll
  for (int e = 0; e < 8; e += 4) {
    const float4 q = ok ? __ldg(reinterpret_cast<const float4*>(v + i + e))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    out[e] = q.x, out[e + 1] = q.y, out[e + 2] = q.z, out[e + 3] = q.w;
  }
}

// [relu](x*a + b) of a chunk's 8 bf16, in place, rounded to bf16.
template <bool RELU>
__device__ __forceinline__ void prologue_chunk(uint4* c, const float (&a)[8],
                                               const float (&b)[8]) {
  uint4 v = *c;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = prologue2<RELU>(w[e], a[2 * e], a[2 * e + 1], b[2 * e],
                           b[2 * e + 1]);
  *c = v;
}

// g = gy + gs + 2*y*gss of a chunk's 8 bf16 in place of gy, rounded to
// bf16 (q2 = 2*gss: see fold2), or zeros where !keep.
__device__ __forceinline__ void fold_chunk(uint4* gy, const uint4* y,
                                           const float (&s2)[8],
                                           const float (&q2)[8], bool keep) {
  uint4 v = *gy;
  const uint4 yv = *y;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
  const uint32_t* yw = reinterpret_cast<const uint32_t*>(&yv);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = fold2(w[e], yw[e], s2[2 * e], s2[2 * e + 1], q2[2 * e],
                 q2[2 * e + 1]);
  *gy = keep ? v : make_uint4(0u, 0u, 0u, 0u);
}

// The barrier of consumer warpgroup cg's 128 threads (ids 2 and 3).
__device__ __forceinline__ void wg_sync(int cg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + cg), "n"(kWgThreads)
               : "memory");
}

// One 64 x 64 box from shared memory at src (1024-byte aligned) to the
// matrix of `map` at columns c0.., rows r0..; TMA leaves out what lies
// outside the matrix. Completion is tracked per issuing thread.
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map,
                                              const void* src, int c0,
                                              int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(r0)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The columns [col0, col0 + BN) of a warpgroup's 64 rows (at row0) of a
// tile in d, rounded to bf16, to the matrix of `map` in passes of SW
// columns through the warpgroup's swizzled staging boxes (64 rows, SW / 64
// boxes 8 KB apart). block(j, v) may change a warp's values of column
// block j first: v[h][e] is (row 8h + g, column 8j + 2t + e) of its 16
// rows, which start at wrow16 (a multiple of 16) within the warpgroup's,
// so a row's swizzle is g. Thread wt == 0 issues the stores and, before a
// pass rewrites the boxes, waits until the last pass's stores have read
// them.
template <int BN, int SW, int R, typename Block>
__device__ __forceinline__ void store_rows(const float (&d)[R], Block block,
                                           const CUtensorMap* map,
                                           unsigned char* staging, int wt,
                                           int cg, int wrow16, int col0,
                                           int row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int pass = 0; pass < BN / SW; ++pass) {
    if (wt == 0) bulk_wait_read();
    wg_sync(cg);
#pragma unroll
    for (int jj = 0; jj < SW / 8; ++jj) {
      const int j = pass * SW / 8 + jj;
      float v[2][2] = {{d[4 * j], d[4 * j + 1]}, {d[4 * j + 2], d[4 * j + 3]}};
      block(j, v);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            staging + (jj >> 3) * kBoxBytes + (wrow16 + 8 * h + g) * 128 +
            ((((jj & 7) ^ g) & 7) << 4) + 4 * t) = f2_to_bf2(v[h][0], v[h][1]);
    }
    fence_async_smem();
    wg_sync(cg);
    if (wt == 0) {
#pragma unroll
      for (int i = 0; i < SW / 64; ++i)
        tma_store_box(map, staging + i * kBoxBytes, col0 + pass * SW + 64 * i,
                      row0);
      bulk_commit();
    }
  }
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// Launch functions return 0, a CUDA error, or one of these.
constexpr int kBadArgument = -1;    // an argument the kernels do not take
constexpr int kNoEncoder = -2;      // the driver has no cuTensorMapEncodeTiled
constexpr int kMapRefused = -3;     // the driver refused a tensor map

// The driver's cuTensorMapEncodeTiled, found through the runtime (the
// libraries link no libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 matrix (rows, cols) as TMA reads it: 64 x 64 boxes,
// 128-byte swizzle, zeros outside the matrix. base and the row pitch
// (cols * 2 bytes) must be multiples of 16 bytes.
inline int encode_box_map(CUtensorMap* map, const void* base, int rows,
                          int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBK, 64};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
         dims, pitch, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapRefused;
}

}  // namespace rt
