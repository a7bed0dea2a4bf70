// Shared pieces of the matmul-with-statistics kernels (matmul_stats.cu,
// matmul_stats_bwd.cu): 16-byte chunks of bf16 or float, the rounding-exact
// prologue and cotangent fold, and the float32 tile product of the float32
// kernels.
//
// The float32 kernels (run only in the parity checks) multiply through plain
// FMAs on the CUDA cores, so that float32 stays full precision (no TF32),
// and write their accumulators to a float32 staging tile in shared memory,
// from where their epilogues read them. The bf16 kernels take the Hopper
// tensor-core mainloop of wgmma_pipeline.cuh instead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kThreads = 256;  // 8 warps a block, in every kernel
using bf16 = __nv_bfloat16;

// Elements of T in one 16-byte chunk: 8 bf16 or 4 float.
template <typename T>
struct Chunk {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_float<bf16>(bf16 v) {
  return __bfloat162float(v);
}

// Round-to-nearest-even, as a cast to the tensor's dtype does.
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw,
                                       float (&out)[Chunk<T>::N]) {
  const T* p = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Chunk<T>::N; ++i) out[i] = to_float<T>(p[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&in)[Chunk<T>::N]) {
  uint4 raw;
  T* p = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Chunk<T>::N; ++i) p[i] = from_float<T>(in[i]);
  return raw;
}

// One 16-byte read-only load, or zeros where the chunk lies past an edge.
__device__ __forceinline__ uint4 load16(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p))
            : make_uint4(0u, 0u, 0u, 0u);
}

// x*a + b in float32 with both roundings kept (never contracted to an FMA),
// as the plain PyTorch expression rounds.
__device__ __forceinline__ float mul_add(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// g = gy + gs + 2*y*gss, the statistics' cotangents folded into gy, in the
// reference's association: (gy + gs) + ((2*y) * gss).
__device__ __forceinline__ float fold_g(float gy, float y, float gs,
                                        float gss) {
  return __fadd_rn(__fadd_rn(gy, gs), __fmul_rn(__fmul_rn(2.0f, y), gss));
}

// C (TM x TN, float32) += A (TM x TK) @ B (TK x TN) over shared-memory tiles
// of T (float only). A(i, k) lives at As[i*LDA + k], or As[k*LDA + i] with
// A_COL; B(k, j) at Bs[k*LDB + j], or Bs[j*LDB + k] with B_COL.
template <typename T, int TM, int TN, int TK, bool A_COL, bool B_COL, int LDA,
          int LDB>
struct TileMma;

// float32: 256 threads as a 16 x 16 grid; thread (ty, tx) owns rows
// ty + 16*i and columns tx + 16*j, accumulated with FMAs.
template <int TM, int TN, int TK, bool A_COL, bool B_COL, int LDA, int LDB>
struct TileMma<float, TM, TN, TK, A_COL, B_COL, LDA, LDB> {
  static constexpr int RM = TM / 16, RN = TN / 16;
  static_assert(RM >= 1 && RN >= 1 && TM % 16 == 0 && TN % 16 == 0,
                "tile does not split over 16 x 16 threads");

  float acc[RM][RN];
  int ty, tx;

  __device__ __forceinline__ void init() {
    ty = threadIdx.x >> 4;
    tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
  }

  __device__ __forceinline__ void step(const float* As, const float* Bs) {
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + 16 * i;
        av[i] = A_COL ? As[kk * LDA + r] : As[r * LDA + kk];
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tx + 16 * j;
        bv[j] = B_COL ? Bs[c * LDB + kk] : Bs[kk * LDB + c];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        C[(ty + 16 * i) * ldc + tx + 16 * j] = acc[i][j];
  }
};

// Sum per-thread column partials over the threads of a block in a fixed
// order. Thread t holds VEC partials of columns cc..cc+VEC-1 for each of NV
// quantities; `red` is shared memory of NV * RSTEP * TN floats that no thread
// still reads. Afterwards thread t < NV*TN holds in the return value the
// block's sum of quantity t / TN, column t % TN.
template <int VEC, int TN, int NV>
__device__ __forceinline__ float block_column_sums(float (&part)[NV][VEC],
                                                   float* red) {
  constexpr int CPR = TN / VEC;
  constexpr int RSTEP = kThreads / CPR;
  static_assert(NV * TN <= kThreads, "one thread per reduced column");
  const int cc = (threadIdx.x % CPR) * VEC;
  const int rbase = threadIdx.x / CPR;
#pragma unroll
  for (int q = 0; q < NV; ++q)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      red[(q * RSTEP + rbase) * TN + cc + i] = part[q][i];
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < NV * TN) {
    const int q = threadIdx.x / TN, col = threadIdx.x % TN;
    for (int r = 0; r < RSTEP; ++r) total += red[(q * RSTEP + r) * TN + col];
  }
  return total;
}

}  // namespace rt
