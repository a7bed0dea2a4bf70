// The bn-ema BatchNorm's training kernels over an (M, C) matrix: the rows
// of a channels-last NCHW activation, one column a channel, in bf16 or
// float32.
//
//   forward (bn_sums_forward_launch):
//   bn_sums_stats_kernel    S1[c] = sum_rows x[r, c], S2[c] = sum_rows x^2
//   bn_sums_finalize_kernel per channel: the split partials added, the batch
//                           statistics, the ema_clamp clip, the running
//                           statistics refreshed in place, and the vectors
//                           mean, inv, a the apply and the backward read
//   bn_sums_apply_kernel    y = (x - mean[c]) * a[c] + bias[c]
//   backward (bn_sums_launch):
//   bn_sums_kernel (K5)     S1[c] = sum_rows gy[r, c]
//                           S2[c] = sum_rows gy[r, c] * xhat[r, c],
//                           xhat = (x - mean[c]) * inv[c]
//   bn_sums_reduce_kernel   the split partials of S1 and S2 added
//   bn_sums_dx_kernel       dx = (gy - S1[c] / M) * a[c]
//
// One launch function for each direction keeps the host's share small:
// one call from Python starts the three kernels.
//
// All arithmetic is float32 with round-to-nearest intrinsics, in the order
// the plain versions (ops/bn_ema.py) write it, so no multiply-add is
// contracted; each output is rounded once to its dtype.
//
// K5 replaces the TPU kernel tools/reduce_probe.py, the inner `kernel` of
// `pallas_sums`. That kernel walks the rows in one sequential grid and keeps
// (8, C) float32 accumulators resident in fast memory from one grid step to
// the next. Here blocks run in parallel and in no order, so nothing carries
// over between them: each block owns a split of the rows and writes float32
// partials of shape (splits, C) for S1 and S2, added afterwards in a fixed
// order (by the reduce and the finalize kernels). No atomics: a run gives
// the same bits every time.
//
// The other five replace no TPU kernel: the JAX package left BatchNorm to
// XLA, which fuses it. They take the place of PyTorch's eager float32
// chain (casts, two mean reductions, some 25 per-channel ops, three
// full-tensor passes, and autograd's replay of them), some 60 launches a
// layer against 3 forward and 3 backward.
//
// What bounds them on an H100: bytes. A layer must read x for its
// statistics, read x and write y to apply them, read gy and x for the
// backward's sums and read gy and write dx: 14 bytes an element in bf16,
// at a few float32 operations an element, far below the card's rate. So
// the design is about keeping enough loads in flight:
//
//   - a thread owns 8 neighbouring columns (one 16-byte chunk of bf16, two
//     of float32) and walks its block's rows with a stride of the block's
//     row lanes, kUnroll rows at a time, all loads of those rows issued
//     before any arithmetic;
//   - neighbouring threads own neighbouring chunks of one row, so C/8
//     threads cover a row and a warp reads whole rows (C=64: four rows,
//     512 contiguous bytes; C=2048: one row spans 256 threads);
//   - the per-channel vectors a thread needs are loaded once into its
//     registers; the sums' 16 float32 accumulators stay there too, and at
//     the end the block adds its row lanes in shared memory, in lane order;
//   - the wrapper picks the number of splits so that a few blocks exist per
//     SM at every ResNet shape, each lane walking at least a few rows.
//
// The loads are streaming (__ldcs): each kernel reads its inputs once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;    // columns a thread owns; the wrapper's C % 8
constexpr int kUnroll = 4;  // rows a thread loads before it adds any
// the finalize kernel: a block owns kFinCols channels and adds their
// partials in kFinGroups interleaved groups of splits, then the groups
constexpr int kFinCols = 32;
constexpr int kFinGroups = 16;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, bf16* out) {
  *out = __float2bfloat16_rn(v);
}

// where a thread sits in the (column block, split) grid of the row kernels
struct RowWalk {
  int lanes, ty, col0;
  bool active;
  long long row_begin, row_end;

  __device__ RowWalk(int M, int C, int row_threads, int rows_per_split) {
    const int chunks = C / kCols;
    lanes = kThreads / row_threads;  // rows walked side by side
    const int tx = threadIdx.x % row_threads;
    ty = threadIdx.x / row_threads;
    const int chunk = blockIdx.x * row_threads + tx;
    col0 = chunk * kCols;
    active = ty < lanes && chunk < chunks;
    row_begin = (long long)blockIdx.y * rows_per_split;
    row_end = min((long long)M, row_begin + (long long)rows_per_split);
  }
};

// The column sums of one block's split, written as its row of the (splits,
// C) partials. kSelf: the statistics (gy is x, mean 0, inv 1, so S2 is the
// sum of x*x), one load stream. Otherwise K5.
template <typename T, bool kSelf>
__device__ __forceinline__ void column_sums(
    const T* __restrict__ gy, const T* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ inv,
    float* __restrict__ ps1, float* __restrict__ ps2, int M, int C,
    int row_threads, int rows_per_split) {
  // 16-byte loads per 8 columns: 1 for bf16, 2 for float32
  constexpr int kLoads = kCols * sizeof(T) / 16;
  // the statistics read one stream: as many bytes in flight as K5's two,
  // in twice the rows for bf16
  constexpr int kRows = kSelf ? 2 * kUnroll / kLoads : kUnroll;
  const RowWalk w(M, C, row_threads, rows_per_split);

  float s1[kCols], s2[kCols], mu[kCols], iv[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    s1[i] = 0.0f;
    s2[i] = 0.0f;
    mu[i] = (!kSelf && w.active) ? mean[w.col0 + i] : 0.0f;
    iv[i] = (!kSelf && w.active) ? inv[w.col0 + i] : 1.0f;
  }

  if (w.active) {
    const long long step = (long long)w.lanes * kRows;
    for (long long r0 = w.row_begin + w.ty; r0 < w.row_end; r0 += step) {
      uint4 graw[kSelf ? 1 : kRows][kLoads], xraw[kRows][kLoads];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const long long r = r0 + (long long)u * w.lanes;
        const uint4* xp =
            reinterpret_cast<const uint4*>(x + r * C + w.col0);
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          // rows past the split read as zero: a zero gy adds nothing to
          // either sum (xhat of a zero x is finite), and neither does a
          // zero x to the statistics
          xraw[u][j] =
              r < w.row_end ? __ldcs(xp + j) : make_uint4(0, 0, 0, 0);
          if (!kSelf) {
            const uint4* gp =
                reinterpret_cast<const uint4*>(gy + r * C + w.col0);
            graw[kSelf ? 0 : u][j] =
                r < w.row_end ? __ldcs(gp + j) : make_uint4(0, 0, 0, 0);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const T* xv = reinterpret_cast<const T*>(xraw[u]);
        const T* g =
            kSelf ? xv : reinterpret_cast<const T*>(graw[kSelf ? 0 : u]);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const float gf = to_float(g[i]);
          const float xh =
              kSelf ? gf
                    : __fmul_rn(__fsub_rn(to_float(xv[i]), mu[i]), iv[i]);
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
  if (w.ty < w.lanes) {
    const int tx = threadIdx.x % row_threads;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      sh1[w.ty * width + tx * kCols + i] = s1[i];
      sh2[w.ty * width + tx * kCols + i] = s2[i];
    }
  }
  __syncthreads();
  const int block_col0 = blockIdx.x * width;
  for (int o = threadIdx.x; o < width; o += kThreads) {
    if (block_col0 + o >= C) break;
    float a1 = 0.0f, a2 = 0.0f;
    for (int l = 0; l < w.lanes; ++l) {
      a1 = __fadd_rn(a1, sh1[l * width + o]);
      a2 = __fadd_rn(a2, sh2[l * width + o]);
    }
    const long long out = (long long)blockIdx.y * C + block_col0 + o;
    ps1[out] = a1;
    ps2[out] = a2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_sums_kernel(const T* __restrict__ gy, const T* __restrict__ x,
               const float* __restrict__ mean, const float* __restrict__ inv,
               float* __restrict__ ps1, float* __restrict__ ps2, int M, int C,
               int row_threads, int rows_per_split) {
  column_sums<T, false>(gy, x, mean, inv, ps1, ps2, M, C, row_threads,
                        rows_per_split);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_sums_stats_kernel(const T* __restrict__ x, float* __restrict__ ps1,
                     float* __restrict__ ps2, int M, int C, int row_threads,
                     int rows_per_split) {
  column_sums<T, true>(nullptr, x, nullptr, nullptr, ps1, ps2, M, C,
                       row_threads, rows_per_split);
}

// out = (in - p[c]) * q[c] + r[c], or without r (r null) (in - p[c]) *
// q[c]; p[c] = pv[c] / p_div where p_div is not 0
template <typename T>
__device__ __forceinline__ void column_affine(
    const T* __restrict__ in, const float* __restrict__ pv, float p_div,
    const float* __restrict__ q, const float* __restrict__ r,
    T* __restrict__ out, int M, int C, int row_threads,
    int rows_per_split) {
  constexpr int kLoads = kCols * sizeof(T) / 16;
  const RowWalk w(M, C, row_threads, rows_per_split);
  if (!w.active) return;
  float pc[kCols], qc[kCols], rc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    pc[i] = p_div != 0.0f ? __fdiv_rn(pv[w.col0 + i], p_div)
                          : pv[w.col0 + i];
    qc[i] = q[w.col0 + i];
    rc[i] = r != nullptr ? r[w.col0 + i] : 0.0f;
  }
  const long long step = (long long)w.lanes * kUnroll;
  for (long long r0 = w.row_begin + w.ty; r0 < w.row_end; r0 += step) {
    uint4 raw[kUnroll][kLoads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r0 + (long long)u * w.lanes;
      const uint4* ip =
          reinterpret_cast<const uint4*>(in + row * C + w.col0);
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
        raw[u][j] = row < w.row_end ? __ldcs(ip + j) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r0 + (long long)u * w.lanes;
      if (row >= w.row_end) break;
      const T* v = reinterpret_cast<const T*>(raw[u]);
      uint4 packed[kLoads];
      T* o = reinterpret_cast<T*>(packed);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        float y = __fmul_rn(__fsub_rn(to_float(v[i]), pc[i]), qc[i]);
        if (r != nullptr) y = __fadd_rn(y, rc[i]);
        from_float(y, o + i);
      }
      uint4* op = reinterpret_cast<uint4*>(out + row * C + w.col0);
#pragma unroll
      for (int j = 0; j < kLoads; ++j) op[j] = packed[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_sums_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ a,
                     const float* __restrict__ bias, T* __restrict__ y,
                     int M, int C, int row_threads, int rows_per_split) {
  column_affine<T>(x, mean, 0.0f, a, bias, y, M, C, row_threads,
                   rows_per_split);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_sums_dx_kernel(const T* __restrict__ gy, const float* __restrict__ s1,
                  float count, const float* __restrict__ a,
                  T* __restrict__ dx, int M, int C, int row_threads,
                  int rows_per_split) {
  column_affine<T>(gy, s1, count, a, nullptr, dx, M, C, row_threads,
                   rows_per_split);
}

// The column sums (S1, S2) of channel c from the (splits, C) partials, in
// a fixed order: group g of the block adds splits g, g + kFinGroups, ...,
// then the block's group-0 thread adds the groups in order. Returns false
// in every other thread, which has nothing more to do.
__device__ __forceinline__ bool add_splits(const float* __restrict__ ps1,
                                           const float* __restrict__ ps2,
                                           int splits, int C, int c,
                                           float* t1, float* t2) {
  const int lc = threadIdx.x % kFinCols;
  const int g = threadIdx.x / kFinCols;
  float s1 = 0.0f, s2 = 0.0f;
  if (c < C) {
    for (int s = g; s < splits; s += kFinGroups) {
      s1 = __fadd_rn(s1, ps1[(long long)s * C + c]);
      s2 = __fadd_rn(s2, ps2[(long long)s * C + c]);
    }
  }
  __shared__ float sh1[kFinGroups][kFinCols];
  __shared__ float sh2[kFinGroups][kFinCols];
  sh1[g][lc] = s1;
  sh2[g][lc] = s2;
  __syncthreads();
  if (g != 0 || c >= C) return false;
  float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kFinGroups; ++i) {
    a1 = __fadd_rn(a1, sh1[i][lc]);
    a2 = __fadd_rn(a2, sh2[i][lc]);
  }
  *t1 = a1;
  *t2 = a2;
  return true;
}

// K5's partials added: out1 = S1, out2 = S2
__global__ void __launch_bounds__(kFinCols * kFinGroups)
bn_sums_reduce_kernel(const float* __restrict__ ps1,
                      const float* __restrict__ ps2, int splits, int C,
                      float* __restrict__ out1, float* __restrict__ out2) {
  const int c = blockIdx.x * kFinCols + threadIdx.x % kFinCols;
  float t1, t2;
  if (!add_splits(ps1, ps2, splits, C, c, &t1, &t2)) return;
  out1[c] = t1;
  out2[c] = t2;
}

// One thread a channel, after add_splits: the plain version's finalize,
// operation for operation.
__global__ void __launch_bounds__(kFinCols * kFinGroups)
bn_sums_finalize_kernel(const float* __restrict__ ps1,
                        const float* __restrict__ ps2, int splits, int C,
                        float count, float* __restrict__ running_mean,
                        float* __restrict__ running_var,
                        const float* __restrict__ weight,
                        float* __restrict__ mean_out,
                        float* __restrict__ inv_out,
                        float* __restrict__ a_out, float eps, float momentum,
                        float keep_new, float clamp, float clamp2,
                        float clamp_minus_1) {
  const int c = blockIdx.x * kFinCols + threadIdx.x % kFinCols;
  float t1, t2;
  if (!add_splits(ps1, ps2, splits, C, c, &t1, &t2)) return;
  const float bmean = __fdiv_rn(t1, count);
  const float bsq = __fdiv_rn(t2, count);
  const float bvar = fmaxf(__fsub_rn(bsq, __fmul_rn(bmean, bmean)), 0.0f);
  // the running statistics as they stand before this step's refresh
  const float rm = running_mean[c];
  const float rv = running_var[c];
  float var = rv, mean = rm;
  if (clamp > 0.0f) {
    var = fminf(fmaxf(rv, __fdiv_rn(bvar, clamp2)),
                __fadd_rn(__fmul_rn(bvar, clamp2), eps));
    const float sd = __fmul_rn(__fsqrt_rn(__fadd_rn(bvar, eps)),
                               clamp_minus_1);
    mean = fminf(fmaxf(rm, __fsub_rn(bmean, sd)), __fadd_rn(bmean, sd));
  }
  running_mean[c] = __fadd_rn(__fmul_rn(momentum, rm),
                              __fmul_rn(keep_new, bmean));
  running_var[c] = __fadd_rn(__fmul_rn(momentum, rv),
                             __fmul_rn(keep_new, bvar));
  // the live mean carries the gradient; its value is the clipped one
  mean_out[c] = __fadd_rn(bmean, __fsub_rn(mean, bmean));
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  inv_out[c] = inv;
  a_out[c] = weight != nullptr ? __fmul_rn(inv, weight[c]) : inv;
}

// the row kernels' launch geometry: C/8 threads a row, at most a block
struct Geometry {
  int row_threads;
  dim3 grid;
  Geometry(int C, int splits) {
    const int chunks = C / kCols;
    row_threads = chunks < kThreads ? chunks : kThreads;
    grid = dim3((chunks + row_threads - 1) / row_threads, splits);
  }
};

// the per-channel kernels' grid
dim3 channel_grid(int C) { return dim3((C + kFinCols - 1) / kFinCols); }

bool bad_rows(int M, int C, int splits, int rows_per_split) {
  return M < 1 || C < kCols || C % kCols != 0 || splits < 1 ||
         splits > 65535 || rows_per_split < 1 ||
         (long long)splits * rows_per_split < M;
}

template <typename T>
int backward(const void* gy, const void* x, const float* mean,
             const float* inv, const float* a, float* part, float* sums,
             void* dx, int M, int C, int splits, int rows_per_split,
             cudaStream_t stream) {
  const Geometry geo(C, splits);
  float* ps1 = part;
  float* ps2 = part + (long long)splits * C;
  bn_sums_kernel<T><<<geo.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(gy), static_cast<const T*>(x), mean, inv, ps1,
      ps2, M, C, geo.row_threads, rows_per_split);
  bn_sums_reduce_kernel<<<channel_grid(C), kFinCols * kFinGroups, 0,
                          stream>>>(ps1, ps2, splits, C, sums, sums + C);
  if (dx != nullptr)
    bn_sums_dx_kernel<T><<<geo.grid, kThreads, 0, stream>>>(
        static_cast<const T*>(gy), sums, static_cast<float>(M), a,
        static_cast<T*>(dx), M, C, geo.row_threads, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward(const void* x, float* part, float* running_mean,
            float* running_var, const float* weight, const float* bias,
            float* vectors, void* y, int M, int C, int splits,
            int rows_per_split, float eps, float momentum, float keep_new,
            float clamp, float clamp2, float clamp_minus_1,
            cudaStream_t stream) {
  const Geometry geo(C, splits);
  float* ps1 = part;
  float* ps2 = part + (long long)splits * C;
  float* mean = vectors;
  float* inv = vectors + C;
  float* a = vectors + 2 * C;
  bn_sums_stats_kernel<T><<<geo.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), ps1, ps2, M, C, geo.row_threads,
      rows_per_split);
  bn_sums_finalize_kernel<<<channel_grid(C), kFinCols * kFinGroups, 0,
                            stream>>>(
      ps1, ps2, splits, C, static_cast<float>(M), running_mean, running_var,
      weight, mean, inv, a, eps, momentum, keep_new, clamp, clamp2,
      clamp_minus_1);
  bn_sums_apply_kernel<T><<<geo.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, a, bias, static_cast<T*>(y), M, C,
      geo.row_threads, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch functions take matrices (M, C) row-major, 16-byte aligned, C
// a multiple of 8, in bf16 (dtype 0) or float32 (dtype 1); per-channel
// vectors (C,) float32; part: 2 * splits * C float32 of scratch, the
// partials of the two sums; splits * rows_per_split >= M. They launch on
// `stream` and return cudaGetLastError() after the launches, -1 for an
// argument they do not take.

// The backward: K5's sums of gy, x with mean, inv, added into sums (2, C):
// S1 then S2; then, unless dx is null, dx = (gy - S1 / M) * a in gy's
// dtype (a may be null without dx).
extern "C" int bn_sums_launch(const void* gy, const void* x, const void* mean,
                              const void* inv, const void* a, void* part,
                              void* sums, void* dx, int M, int C, int splits,
                              int rows_per_split, int dtype, void* stream) {
  if (bad_rows(M, C, splits, rows_per_split) || (dx != nullptr && !a))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fm = static_cast<const float*>(mean);
  const float* fi = static_cast<const float*>(inv);
  const float* fa = static_cast<const float*>(a);
  float* fp = static_cast<float*>(part);
  float* fs = static_cast<float*>(sums);
  if (dtype == 0)
    return backward<bf16>(gy, x, fm, fi, fa, fp, fs, dx, M, C, splits,
                          rows_per_split, s);
  if (dtype == 1)
    return backward<float>(gy, x, fm, fi, fa, fp, fs, dx, M, C, splits,
                           rows_per_split, s);
  return -1;
}

// The forward: the statistics of x over its M rows, the finalize (the
// running statistics read and refreshed in place; weight null for no
// scale) into vectors (3, C): mean, inv, a; then y = (x - mean) * a + bias
// in x's dtype. clamp2 = clamp^2 and clamp_minus_1 = clamp - 1 as the
// caller rounds them; keep_new = 1 - momentum.
extern "C" int bn_sums_forward_launch(
    const void* x, void* part, void* running_mean, void* running_var,
    const void* weight, const void* bias, void* vectors, void* y, int M,
    int C, int splits, int rows_per_split, int dtype, float eps,
    float momentum, float keep_new, float clamp, float clamp2,
    float clamp_minus_1, void* stream) {
  if (bad_rows(M, C, splits, rows_per_split)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fp = static_cast<float*>(part);
  float* rm = static_cast<float*>(running_mean);
  float* rv = static_cast<float*>(running_var);
  const float* fw = static_cast<const float*>(weight);
  const float* fb = static_cast<const float*>(bias);
  float* fv = static_cast<float*>(vectors);
  if (dtype == 0)
    return forward<bf16>(x, fp, rm, rv, fw, fb, fv, y, M, C, splits,
                         rows_per_split, eps, momentum, keep_new, clamp,
                         clamp2, clamp_minus_1, s);
  if (dtype == 1)
    return forward<float>(x, fp, rm, rv, fw, fb, fv, y, M, C, splits,
                          rows_per_split, eps, momentum, keep_new, clamp,
                          clamp2, clamp_minus_1, s);
  return -1;
}
