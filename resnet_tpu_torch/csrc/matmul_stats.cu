// Matrix product with a BatchNorm prologue and a statistics epilogue:
//
//   act = x                          (NORMALIZE off)
//   act = [relu](x*a + b)            (NORMALIZE on; float32, both roundings
//                                     kept, then rounded to x's dtype)
//   y   = act @ W                    (float32 accumulate, stored in x's dtype)
//   psum[i], psumsq[i] = column sums of y and y*y over the i-th 128 rows,
//                        taken from the float32 accumulator, NOT from the
//                        rounded y that is stored
//
// One kernel replaces three TPU kernels that compute this same function:
// resnet_tpu/ops/fused_convbn.py::_kernel (no prologue),
// resnet_tpu/ops/fused_chain.py::_kernel (prologue) and
// resnet_tpu/ops/fused_unit.py::_fwd_kernel (either). A 1x1 convolution over
// NHWC activations is this product with M = N*H*W rows, K = Cin, N = Cout.
//
// What bounds it on an H100: memory, for all but the widest shapes. It must
// read x (M*K) and W (K*N) and write y (M*N); at ResNet-50's shapes K*N/(K+N)
// is under the card's 295 bf16 operations per byte except for 512x2048 and
// 1024x2048. What the design does about it: x and y cross device memory once
// (blocks that share a row panel of x run next to each other, so its
// re-reads for other column tiles hit L2), the normalize+ReLU pass and both
// statistics passes that a separate BatchNorm would make over the activation
// never happen, and the statistics leave as (M/128, N) float32 partials that
// the wrapper sums, so there are no atomics and the result is the same from
// run to run.
//
// Layout: x (M, K) and y (M, N) row-major; W is passed as Wt (N, K)
// row-major, the layout of a 1x1 conv's OIHW weight. A block of 256 threads
// owns a 128 x 64 tile of y and walks K in steps of 32 through shared memory,
// with the next step's global loads in flight while the current one is
// multiplied. Rows past M are zeroed AFTER the prologue (relu(b) != 0 would
// poison the sums); chunks past K or N are zero-filled, so any M and any K, N
// that are multiples of 8 are taken.

#include "tile_mma.cuh"

namespace {

using namespace rt;

// BM is also ops/matmul_stats_cuda.py's BLOCK_ROWS: the rows of one partial
constexpr int BM = 128, BN = 64, BK = 32;

template <typename T, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kThreads, 3)
matmul_stats_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                    const float* __restrict__ a, const float* __restrict__ b,
                    T* __restrict__ y, float* __restrict__ psum,
                    float* __restrict__ psumsq, int M, int K, int N) {
  constexpr int VEC = Chunk<T>::N;
  constexpr int LDT = BK + VEC;  // padded tile rows, still 16-byte multiples
  constexpr int LDC = BN + 4;
  constexpr int CPR = BK / VEC;  // chunks per tile row
  constexpr int A_ITERS = BM * CPR / kThreads;
  constexpr int B_ITERS = BN * CPR / kThreads;
  constexpr int TILE_BYTES = (BM + BN) * LDT * sizeof(T);
  constexpr int C_BYTES = BM * LDC * sizeof(float);
  constexpr int SMEM = TILE_BYTES > C_BYTES ? TILE_BYTES : C_BYTES;
  // the input tiles and the accumulator staging tile share one buffer
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * LDT;
  float* C = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  uint4 ra[A_ITERS], rb[B_ITERS];

  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / CPR, kc = (c % CPR) * VEC;
      const bool ok = (m0 + r < M) && (k0 + kc < K);
      ra[it] = load16(x + (size_t)(m0 + r) * K + k0 + kc, ok);
    }
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / CPR, kc = (c % CPR) * VEC;
      const bool ok = (n0 + r < N) && (k0 + kc < K);
      rb[it] = load16(wt + (size_t)(n0 + r) * K + k0 + kc, ok);
    }
  };

  auto store_tiles = [&](int k0) {
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / CPR, kc = (c % CPR) * VEC;
      uint4 v = ra[it];
      if constexpr (NORMALIZE) {
        // rows past M and chunks past K stay zero: masked after the prologue
        if ((m0 + r < M) && (k0 + kc < K)) {
          float xv[VEC];
          unpack<T>(v, xv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float xh = mul_add(xv[i], __ldg(a + k0 + kc + i),
                               __ldg(b + k0 + kc + i));
            if (RELU) xh = fmaxf(xh, 0.0f);
            xv[i] = xh;
          }
          v = pack<T>(xv);  // rounded to x's dtype before the product
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDT + kc) = v;
    }
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / CPR, kc = (c % CPR) * VEC;
      *reinterpret_cast<uint4*>(Bs + r * LDT + kc) = rb[it];
    }
  };

  // A(i, k) = As[i*LDT + k]; B(k, j) = Wt tile [j][k]: column-major B
  TileMma<T, BM, BN, BK, false, true, LDT, LDT> mma;
  mma.init();

  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load_tiles(k0 + BK);
    mma.step(As, Bs);
    __syncthreads();
    if (more) {
      store_tiles(k0 + BK);
      __syncthreads();
    }
  }

  // Epilogue. Every thread takes 16-byte chunks of y in store order and keeps
  // the column sums of its chunks' columns, from the float32 accumulator.
  mma.store(C, LDC);
  __syncthreads();
  constexpr int CPRO = BN / VEC;
  constexpr int RSTEP = kThreads / CPRO;
  const int cc = (tid % CPRO) * VEC;
  const int rbase = tid / CPRO;
  float part[2][VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[0][i] = part[1][i] = 0.0f;
#pragma unroll
  for (int it = 0; it < BM / RSTEP; ++it) {
    const int r = rbase + it * RSTEP;
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      v[i] = C[r * LDC + cc + i];  // rows past M hold exact zeros
      part[0][i] += v[i];
      part[1][i] = fmaf(v[i], v[i], part[1][i]);
    }
    if ((m0 + r < M) && (n0 + cc < N))
      *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * N + n0 + cc) =
          pack<T>(v);
  }
  __syncthreads();  // all reads of C done: its memory becomes the scratch
  const float total = block_column_sums<VEC, BN, 2>(part, C);
  if (tid < 2 * BN && n0 + tid % BN < N)
    (tid < BN ? psum : psumsq)[(size_t)blockIdx.y * N + n0 + tid % BN] = total;
}

template <typename T>
int launch(const void* x, const void* wt, const void* a, const void* b,
           void* y, void* psum, void* psumsq, int M, int K, int N,
           int normalize, int relu, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
#define RT_LAUNCH(NORM, RL)                                                  \
  matmul_stats_kernel<T, NORM, RL><<<grid, kThreads, 0, stream>>>(           \
      static_cast<const T*>(x), static_cast<const T*>(wt),                   \
      static_cast<const float*>(a), static_cast<const float*>(b),            \
      static_cast<T*>(y), static_cast<float*>(psum),                         \
      static_cast<float*>(psumsq), M, K, N)
  if (!normalize)
    RT_LAUNCH(false, false);
  else if (relu)
    RT_LAUNCH(true, true);
  else
    RT_LAUNCH(true, false);
#undef RT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bf16, 1 = float32. psum, psumsq: (ceil(M/128), N) float32.
// Returns cudaGetLastError() of the launch (0 = launched), or -1 for a
// dtype code it does not know.
extern "C" int matmul_stats_launch(const void* x, const void* wt,
                                   const void* a, const void* b, void* y,
                                   void* psum, void* psumsq, int M, int K,
                                   int N, int dtype, int normalize, int relu,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<rt::bf16>(x, wt, a, b, y, psum, psumsq, M, K, N, normalize,
                            relu, s);
  if (dtype == 1)
    return launch<float>(x, wt, a, b, y, psum, psumsq, M, K, N, normalize,
                         relu, s);
  return -1;
}
