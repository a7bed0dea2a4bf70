// Backward of the matrix product with BatchNorm prologue and statistics
// epilogue (matmul_stats.cu). From the cotangents (gy, gsum, gsumsq), the
// saved (rounded) y, x, W and per-channel float32 vectors a, b, inv, minv:
//
//   g    = gy + gsum + 2*y*gsumsq          float32, rounded to x's dtype,
//                                          never written to device memory
//   act  = x, or [relu](x*a + b) rounded to x's dtype; never written either
//   dW   = act^T @ g                       float32
//   gact = g @ W^T                         float32
//   dx   = gact                                        (NORMALIZE off)
//   dx   = gxh * a,  gxh = gact * [x*a + b > 0]        (NORMALIZE on; the
//                                          mask only with RELU, tested in
//                                          float32 before any rounding)
//   dgamma = sum_rows gxh * (x*inv + minv),  dbeta = sum_rows gxh
//
// Replaces the TPU kernel resnet_tpu/ops/fused_unit.py::_bwd_kernel. That
// kernel walks M in one sequential grid and keeps the whole (K, N) float32 dW
// and W^T resident in fast memory, which is why it has a fit rule and hands
// its largest shape to plain matrix products. Here blocks run in no order and
// nothing is resident, so the work is two kernels on one stream, each forming
// g in registers from tiles of (gy, y), and every shape is taken:
//
//   bwd_dx_kernel  a block owns 128 x 64 of dx, walks N in steps of 32
//                  (A = g tile, B = Wt tile as it lies), and in its epilogue
//                  reads its x tile once for the mask, the `a` fold and the
//                  dgamma/dbeta partials, written as (M/128, K) float32 that
//                  the wrapper sums: no separate sweep over the activations.
//   bwd_dw_kernel  a block owns 64 x 64 of dW^T (N, K) and one split of the
//                  M rows, walks them in steps of 32 (A = g tile read as
//                  g^T, B = act tile recomputed from x), and writes its
//                  float32 partial to (splits, N, K) scratch that the wrapper
//                  sums in a fixed order. The wrapper picks the split count
//                  so that about a thousand blocks exist whatever K*N is:
//                  M reaches 401408 where K*N is 64*64.
//
// What bounds it on an H100: memory at most ResNet-50 shapes (it must read
// gy, y, x, W and write dx and dW); the 512x2048 and 1024x2048 shapes are
// bound by the two products. Both kernels read (gy, y), so those cross device
// memory (or L2) twice: that is the price of forming g without storing it.
// No atomics: results are the same from run to run.
//
// dW leaves in the weight's own layout, dW^T (N, K). Rows past M are zeroed
// after g and act are formed; chunks past K or N are zero-filled, so any M
// and any K, N that are multiples of 8 are taken.

#include "tile_mma.cuh"

namespace {

using namespace rt;

// DX_BM is also ops/matmul_stats_cuda.py's BLOCK_ROWS; DW_BN, DW_BK, DW_BM
// its DW_TILE and DW_ROW_STEP
constexpr int DX_BM = 128, DX_BK = 64, DX_BN = 32;  // dx tile; N step
constexpr int DW_BN = 64, DW_BK = 64, DW_BM = 32;   // dW^T tile; M step

template <typename T, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ gy, const T* __restrict__ y,
              const T* __restrict__ x, const T* __restrict__ wt,
              const float* __restrict__ gs, const float* __restrict__ gss,
              const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ inv, const float* __restrict__ minv,
              T* __restrict__ dx, float* __restrict__ pdgamma,
              float* __restrict__ pdbeta, int M, int K, int N) {
  constexpr int VEC = Chunk<T>::N;
  constexpr int LDA = DX_BN + VEC, LDB = DX_BK + VEC, LDC = DX_BK + 4;
  constexpr int A_CPR = DX_BN / VEC, B_CPR = DX_BK / VEC;
  constexpr int A_ITERS = DX_BM * A_CPR / kThreads;
  constexpr int B_ITERS = DX_BN * B_CPR / kThreads;
  constexpr int TILE_BYTES = (DX_BM * LDA + DX_BN * LDB) * sizeof(T);
  constexpr int C_BYTES = DX_BM * LDC * sizeof(float);
  constexpr int SMEM = TILE_BYTES > C_BYTES ? TILE_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + DX_BM * LDA;
  float* C = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * DX_BK;
  const int m0 = blockIdx.y * DX_BM;

  uint4 rgy[A_ITERS], ry[A_ITERS], rb[B_ITERS];

  auto load_tiles = [&](int n0) {
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / A_CPR, nc = (c % A_CPR) * VEC;
      const bool ok = (m0 + r < M) && (n0 + nc < N);
      const size_t at = (size_t)(m0 + r) * N + n0 + nc;
      rgy[it] = load16(gy + at, ok);
      ry[it] = load16(y + at, ok);
    }
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / B_CPR, kc = (c % B_CPR) * VEC;
      const bool ok = (n0 + r < N) && (k0 + kc < K);
      rb[it] = load16(wt + (size_t)(n0 + r) * K + k0 + kc, ok);
    }
  };

  auto store_tiles = [&](int n0) {
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / A_CPR, nc = (c % A_CPR) * VEC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);  // rows past M: g = 0, not gs
      if ((m0 + r < M) && (n0 + nc < N)) {
        float gv[VEC], yv[VEC];
        unpack<T>(rgy[it], gv);
        unpack<T>(ry[it], yv);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          gv[i] = fold_g(gv[i], yv[i], __ldg(gs + n0 + nc + i),
                         __ldg(gss + n0 + nc + i));
        v = pack<T>(gv);  // g rounded to x's dtype before the product
      }
      *reinterpret_cast<uint4*>(As + r * LDA + nc) = v;
    }
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / B_CPR, kc = (c % B_CPR) * VEC;
      *reinterpret_cast<uint4*>(Bs + r * LDB + kc) = rb[it];
    }
  };

  // gact (m, k) = sum_n g(m, n) * Wt(n, k): both tiles row-major
  TileMma<T, DX_BM, DX_BK, DX_BN, false, false, LDA, LDB> mma;
  mma.init();

  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int n0 = 0; n0 < N; n0 += DX_BN) {
    const bool more = n0 + DX_BN < N;
    if (more) load_tiles(n0 + DX_BN);
    mma.step(As, Bs);
    __syncthreads();
    if (more) {
      store_tiles(n0 + DX_BN);
      __syncthreads();
    }
  }

  mma.store(C, LDC);
  __syncthreads();
  constexpr int CPRO = DX_BK / VEC;
  constexpr int RSTEP = kThreads / CPRO;
  const int cc = (tid % CPRO) * VEC;
  const int rbase = tid / CPRO;
  const bool col_ok = k0 + cc < K;
  float av[VEC], bv[VEC], iv[VEC], mv[VEC];
  float part[2][VEC];  // dgamma, dbeta partials of this thread's columns
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    part[0][i] = part[1][i] = 0.0f;
    if constexpr (NORMALIZE) {
      av[i] = col_ok ? __ldg(a + k0 + cc + i) : 0.0f;
      bv[i] = col_ok ? __ldg(b + k0 + cc + i) : 0.0f;
      iv[i] = col_ok ? __ldg(inv + k0 + cc + i) : 0.0f;
      mv[i] = col_ok ? __ldg(minv + k0 + cc + i) : 0.0f;
    }
  }
#pragma unroll
  for (int it = 0; it < DX_BM / RSTEP; ++it) {
    const int r = rbase + it * RSTEP;
    const bool ok = (m0 + r < M) && col_ok;
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = C[r * LDC + cc + i];
    if constexpr (NORMALIZE) {
      float xv[VEC];
      unpack<T>(load16(x + (size_t)(m0 + r) * K + k0 + cc, ok), xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        // rows past M have gact = 0 exactly, so they add nothing below
        const float xh = mul_add(xv[i], av[i], bv[i]);
        const float gxh = (RELU && !(xh > 0.0f)) ? 0.0f : v[i];
        const float xhat = mul_add(xv[i], iv[i], mv[i]);
        part[0][i] = fmaf(gxh, xhat, part[0][i]);
        part[1][i] += gxh;
        v[i] = __fmul_rn(gxh, av[i]);
      }
    }
    if (ok)
      *reinterpret_cast<uint4*>(dx + (size_t)(m0 + r) * K + k0 + cc) =
          pack<T>(v);
  }
  if constexpr (NORMALIZE) {
    __syncthreads();  // all reads of C done: its memory becomes the scratch
    const float total = block_column_sums<VEC, DX_BK, 2>(part, C);
    if (tid < 2 * DX_BK && k0 + tid % DX_BK < K)
      (tid < DX_BK ? pdgamma
                   : pdbeta)[(size_t)blockIdx.y * K + k0 + tid % DX_BK] = total;
  }
}

template <typename T, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_dw_kernel(const T* __restrict__ gy, const T* __restrict__ y,
              const T* __restrict__ x, const float* __restrict__ gs,
              const float* __restrict__ gss, const float* __restrict__ a,
              const float* __restrict__ b, float* __restrict__ dwt_part,
              int M, int K, int N, int rows_per_split) {
  constexpr int VEC = Chunk<T>::N;
  constexpr int LDA = DW_BN + VEC, LDB = DW_BK + VEC, LDC = DW_BK + 4;
  constexpr int A_CPR = DW_BN / VEC, B_CPR = DW_BK / VEC;
  constexpr int A_ITERS = DW_BM * A_CPR / kThreads;
  constexpr int B_ITERS = DW_BM * B_CPR / kThreads;
  constexpr int TILE_BYTES = DW_BM * (LDA + LDB) * sizeof(T);
  constexpr int C_BYTES = DW_BN * LDC * sizeof(float);
  constexpr int SMEM = TILE_BYTES > C_BYTES ? TILE_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);  // g tile, [m][n]
  T* Bs = As + DW_BM * LDA;            // act tile, [m][k]
  float* C = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * DW_BK;
  const int n0 = blockIdx.y * DW_BN;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);

  uint4 rgy[A_ITERS], ry[A_ITERS], rx[B_ITERS];

  auto load_tiles = [&](int m0) {
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / A_CPR, nc = (c % A_CPR) * VEC;
      const bool ok = (m0 + r < m_end) && (n0 + nc < N);
      const size_t at = (size_t)(m0 + r) * N + n0 + nc;
      rgy[it] = load16(gy + at, ok);
      ry[it] = load16(y + at, ok);
    }
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / B_CPR, kc = (c % B_CPR) * VEC;
      const bool ok = (m0 + r < m_end) && (k0 + kc < K);
      rx[it] = load16(x + (size_t)(m0 + r) * K + k0 + kc, ok);
    }
  };

  auto store_tiles = [&](int m0) {
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / A_CPR, nc = (c % A_CPR) * VEC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if ((m0 + r < m_end) && (n0 + nc < N)) {
        float gv[VEC], yv[VEC];
        unpack<T>(rgy[it], gv);
        unpack<T>(ry[it], yv);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          gv[i] = fold_g(gv[i], yv[i], __ldg(gs + n0 + nc + i),
                         __ldg(gss + n0 + nc + i));
        v = pack<T>(gv);
      }
      *reinterpret_cast<uint4*>(As + r * LDA + nc) = v;
    }
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / B_CPR, kc = (c % B_CPR) * VEC;
      uint4 v = rx[it];
      if constexpr (NORMALIZE) {
        if ((m0 + r < m_end) && (k0 + kc < K)) {
          float xv[VEC];
          unpack<T>(v, xv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float xh = mul_add(xv[i], __ldg(a + k0 + kc + i),
                               __ldg(b + k0 + kc + i));
            if (RELU) xh = fmaxf(xh, 0.0f);
            xv[i] = xh;
          }
          v = pack<T>(xv);  // act rounded to x's dtype before the product
        }
      }
      *reinterpret_cast<uint4*>(Bs + r * LDB + kc) = v;
    }
  };

  // dWt (n, k) = sum_m g(m, n) * act(m, k): A is the g tile read as g^T
  // (column-major A), B the act tile as it lies
  TileMma<T, DW_BN, DW_BK, DW_BM, true, false, LDA, LDB> mma;
  mma.init();

  if (m_begin < m_end) {
    load_tiles(m_begin);
    store_tiles(m_begin);
  }
  __syncthreads();
  for (int m0 = m_begin; m0 < m_end; m0 += DW_BM) {
    const bool more = m0 + DW_BM < m_end;
    if (more) load_tiles(m0 + DW_BM);
    mma.step(As, Bs);
    __syncthreads();
    if (more) {
      store_tiles(m0 + DW_BM);
      __syncthreads();
    }
  }

  mma.store(C, LDC);
  __syncthreads();
  constexpr int CPRO = DW_BK / 4;  // float4 chunks per row of the partial
  float* out = dwt_part + (size_t)blockIdx.z * N * K;
#pragma unroll
  for (int it = 0; it < DW_BN * CPRO / kThreads; ++it) {
    const int c = tid + it * kThreads;
    const int r = c / CPRO, cc = (c % CPRO) * 4;
    if ((n0 + r < N) && (k0 + cc < K))
      *reinterpret_cast<float4*>(out + (size_t)(n0 + r) * K + k0 + cc) =
          *reinterpret_cast<const float4*>(C + r * LDC + cc);
  }
}

template <typename T, bool NORMALIZE, bool RELU>
int launch_both(const void* gy, const void* y, const void* x, const void* wt,
                const float* gs, const float* gss, const float* a,
                const float* b, const float* inv, const float* minv, void* dx,
                float* pdgamma, float* pdbeta, float* dwt_part, int M, int K,
                int N, int splits, int rows_per_split, cudaStream_t stream) {
  const dim3 dx_grid((K + DX_BK - 1) / DX_BK, (M + DX_BM - 1) / DX_BM);
  bwd_dx_kernel<T, NORMALIZE, RELU><<<dx_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(gy), static_cast<const T*>(y),
      static_cast<const T*>(x), static_cast<const T*>(wt), gs, gss, a, b, inv,
      minv, static_cast<T*>(dx), pdgamma, pdbeta, M, K, N);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 dw_grid((K + DW_BK - 1) / DW_BK, (N + DW_BN - 1) / DW_BN, splits);
  bwd_dw_kernel<T, NORMALIZE, RELU><<<dw_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(gy), static_cast<const T*>(y),
      static_cast<const T*>(x), gs, gss, a, b, dwt_part, M, K, N,
      rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* gy, const void* y, const void* x, const void* wt,
           const float* gs, const float* gss, const float* a, const float* b,
           const float* inv, const float* minv, void* dx, float* pdgamma,
           float* pdbeta, float* dwt_part, int M, int K, int N, int splits,
           int rows_per_split, int normalize, int relu, cudaStream_t stream) {
#define RT_ARGS                                                              \
  gy, y, x, wt, gs, gss, a, b, inv, minv, dx, pdgamma, pdbeta, dwt_part, M,  \
      K, N, splits, rows_per_split, stream
  if (!normalize) return launch_both<T, false, false>(RT_ARGS);
  if (relu) return launch_both<T, true, true>(RT_ARGS);
  return launch_both<T, true, false>(RT_ARGS);
#undef RT_ARGS
}

}  // namespace

// dtype: 0 = bf16, 1 = float32. gs, gss: (N,) float32; a, b, inv, minv: (K,)
// float32, read only with normalize. pdgamma, pdbeta: (ceil(M/128), K)
// float32, written only with normalize. dwt_part: (splits, N, K) float32 with
// splits * rows_per_split >= M and rows_per_split a multiple of 32. Starts
// both kernels on `stream`; returns the first non-zero cudaGetLastError(),
// 0 if both launched, -1 for an argument it does not take.
extern "C" int matmul_stats_bwd_launch(
    const void* gy, const void* y, const void* x, const void* wt,
    const void* gs, const void* gss, const void* a, const void* b,
    const void* inv, const void* minv, void* dx, void* pdgamma, void* pdbeta,
    void* dwt_part, int M, int K, int N, int splits, int rows_per_split,
    int dtype, int normalize, int relu, void* stream) {
  if (splits < 1 || rows_per_split % DW_BM != 0 ||
      (long long)splits * rows_per_split < M)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fgs = static_cast<const float*>(gs);
  const float* fgss = static_cast<const float*>(gss);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* finv = static_cast<const float*>(inv);
  const float* fminv = static_cast<const float*>(minv);
  float* fpg = static_cast<float*>(pdgamma);
  float* fpb = static_cast<float*>(pdbeta);
  float* fdw = static_cast<float*>(dwt_part);
  if (dtype == 0)
    return launch<rt::bf16>(gy, y, x, wt, fgs, fgss, fa, fb, finv, fminv, dx,
                            fpg, fpb, fdw, M, K, N, splits, rows_per_split,
                            normalize, relu, s);
  if (dtype == 1)
    return launch<float>(gy, y, x, wt, fgs, fgss, fa, fb, finv, fminv, dx,
                         fpg, fpb, fdw, M, K, N, splits, rows_per_split,
                         normalize, relu, s);
  return -1;
}
