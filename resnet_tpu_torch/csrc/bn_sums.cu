// The BatchNorm backward's pair of column sums. For gy, x (M, C) in bf16 or
// float32 and per-column float32 mean, inv:
//
//   S1[c] = sum_rows gy[r, c]
//   S2[c] = sum_rows gy[r, c] * xhat[r, c],  xhat = (x - mean[c]) * inv[c]
//
// all in float32; xhat is rounded as written (subtract, then multiply), the
// product is rounded, then added.
//
// Replaces the TPU kernel tools/reduce_probe.py, the inner `kernel` of
// `pallas_sums`. That kernel walks the rows in one sequential grid and keeps
// (8, C) float32 accumulators resident in fast memory from one grid step to
// the next. Here blocks run in parallel and in no order, so nothing carries
// over between them: each block owns a split of the rows and writes float32
// partials of shape (splits, C) for S1 and S2, which the wrapper adds in a
// fixed order (one torch.sum over the split axis). No atomics: a run gives
// the same bits every time.
//
// What bounds it on an H100: bytes. It must read gy and x once each
// (2*M*C elements) and does 5 float32 operations an element pair, far below
// the card's rate; so the design is about keeping enough loads in flight:
//
//   - a thread owns 8 neighbouring columns (one 16-byte chunk of bf16, two
//     of float32) and walks its block's rows with a stride of the block's
//     row lanes, kUnroll rows at a time, all loads of those rows issued
//     before any arithmetic;
//   - neighbouring threads own neighbouring chunks of one row, so C/8
//     threads cover a row and a warp reads whole rows (C=64: four rows,
//     512 contiguous bytes; C=2048: one row spans 256 threads);
//   - 16 float32 accumulators stay in registers; at the end the block adds
//     its row lanes in shared memory, in lane order;
//   - the wrapper picks the number of splits so that a few blocks exist per
//     SM at every ResNet-50 shape, each lane walking at least a few rows.
//
// The loads are streaming (__ldcs): the data is read once and need not stay
// in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;    // columns a thread owns; the wrapper's C % 8
constexpr int kUnroll = 4;  // rows a thread loads before it adds any

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_sums_kernel(const T* __restrict__ gy, const T* __restrict__ x,
               const float* __restrict__ mean, const float* __restrict__ inv,
               float* __restrict__ ps1, float* __restrict__ ps2, int M, int C,
               int row_threads, int rows_per_split) {
  // 16-byte loads per 8 columns: 1 for bf16, 2 for float32
  constexpr int kLoads = kCols * sizeof(T) / 16;
  const int chunks = C / kCols;
  const int lanes = kThreads / row_threads;  // rows walked side by side
  const int tx = threadIdx.x % row_threads;
  const int ty = threadIdx.x / row_threads;
  const int chunk = blockIdx.x * row_threads + tx;
  const int col0 = chunk * kCols;
  const bool active = ty < lanes && chunk < chunks;
  const long long row_begin = (long long)blockIdx.y * rows_per_split;
  const long long row_end =
      min((long long)M, row_begin + (long long)rows_per_split);

  float s1[kCols], s2[kCols], mu[kCols], iv[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    s1[i] = 0.0f;
    s2[i] = 0.0f;
    mu[i] = active ? mean[col0 + i] : 0.0f;
    iv[i] = active ? inv[col0 + i] : 0.0f;
  }

  if (active) {
    const long long step = (long long)lanes * kUnroll;
    for (long long r0 = row_begin + ty; r0 < row_end; r0 += step) {
      uint4 graw[kUnroll][kLoads], xraw[kUnroll][kLoads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + (long long)u * lanes;
        const uint4* gp =
            reinterpret_cast<const uint4*>(gy + r * C + col0);
        const uint4* xp = reinterpret_cast<const uint4*>(x + r * C + col0);
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          // rows past the split read as zero: gy = 0 adds nothing to
          // either sum (xhat of a zero x is finite)
          graw[u][j] = r < row_end ? __ldcs(gp + j) : make_uint4(0, 0, 0, 0);
          xraw[u][j] = r < row_end ? __ldcs(xp + j) : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* g = reinterpret_cast<const T*>(graw[u]);
        const T* xv = reinterpret_cast<const T*>(xraw[u]);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const float gf = to_float(g[i]);
          const float xh = __fmul_rn(__fsub_rn(to_float(xv[i]), mu[i]), iv[i]);
          s1[i] = __fadd_rn(s1[i], gf);
          s2[i] = __fadd_rn(s2[i], __fmul_rn(gf, xh));
        }
      }
    }
  }

  // add the row lanes, in lane order, per column of the block
  __shared__ float sh1[kThreads * kCols];
  __shared__ float sh2[kThreads * kCols];
  const int width = row_threads * kCols;  // columns the block covers
  if (ty < lanes) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      sh1[ty * width + tx * kCols + i] = s1[i];
      sh2[ty * width + tx * kCols + i] = s2[i];
    }
  }
  __syncthreads();
  const int block_col0 = blockIdx.x * width;
  for (int o = threadIdx.x; o < width; o += kThreads) {
    if (block_col0 + o >= C) break;
    float a1 = 0.0f, a2 = 0.0f;
    for (int l = 0; l < lanes; ++l) {
      a1 = __fadd_rn(a1, sh1[l * width + o]);
      a2 = __fadd_rn(a2, sh2[l * width + o]);
    }
    const long long out = (long long)blockIdx.y * C + block_col0 + o;
    ps1[out] = a1;
    ps2[out] = a2;
  }
}

template <typename T>
int launch(const void* gy, const void* x, const float* mean, const float* inv,
           float* ps1, float* ps2, int M, int C, int splits,
           int rows_per_split, cudaStream_t stream) {
  const int chunks = C / kCols;
  const int row_threads = chunks < kThreads ? chunks : kThreads;
  const dim3 grid((chunks + row_threads - 1) / row_threads, splits);
  bn_sums_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(gy), static_cast<const T*>(x), mean, inv, ps1,
      ps2, M, C, row_threads, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bf16, 1 = float32. gy, x: (M, C) row-major, 16-byte aligned,
// C a multiple of 8; mean, inv: (C,) float32; ps1, ps2: (splits, C) float32,
// every entry written. splits * rows_per_split >= M. Returns
// cudaGetLastError() after the launch, -1 for an argument it does not take.
extern "C" int bn_sums_launch(const void* gy, const void* x, const void* mean,
                              const void* inv, void* ps1, void* ps2, int M,
                              int C, int splits, int rows_per_split, int dtype,
                              void* stream) {
  if (M < 1 || C < kCols || C % kCols != 0 || splits < 1 || splits > 65535 ||
      rows_per_split < 1 || (long long)splits * rows_per_split < M)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fm = static_cast<const float*>(mean);
  const float* fi = static_cast<const float*>(inv);
  float* f1 = static_cast<float*>(ps1);
  float* f2 = static_cast<float*>(ps2);
  if (dtype == 0)
    return launch<bf16>(gy, x, fm, fi, f1, f2, M, C, splits, rows_per_split,
                        s);
  if (dtype == 1)
    return launch<float>(gy, x, fm, fi, f1, f2, M, C, splits, rows_per_split,
                         s);
  return -1;
}
