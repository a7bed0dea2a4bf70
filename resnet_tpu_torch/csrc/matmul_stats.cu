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
// 1024x2048, where the tensor cores bound it. So the kernel has to keep
// device memory busy all the time and the tensor cores fed at the wide
// shapes. What the design does about it (bf16, matmul_stats_kernel):
//
//   - A persistent grid (one block an SM) walks its output tiles of 128 x
//     128 (128 x 64 where the output is at most 64 wide) one after
//     another, and a ring of 4 shared-memory
//     stages runs over the block's whole sequence of (tile, 64-deep k step):
//     16-byte cp.async copies keep 3 stages in flight, so the next tile's
//     operands load during this tile's product and epilogue. At K = 64 a
//     tile is one stage, and the ring is what keeps memory busy.
//   - Stages are XOR-swizzled so that ldmatrix reads hit distinct banks;
//     the product is mma.sync m16n8k16 (bf16 in, float32 accumulate) from
//     register fragments, 8 warps as 4 x 2, a warp 32 rows by half the
//     tile. The prologue runs on the A fragments in registers, with a and b
//     staged beside each stage; accumulators stay in registers into the
//     epilogue.
//   - The epilogue takes the column sums from the accumulators (rows past M
//     count as exact zeros) by warp shuffles, then across the 4 warp rows in
//     a fixed order, and stores y through a small per-warp staging buffer in
//     16-byte chunks. The statistics leave as (N, ceil(M/128)) float32
//     partials that the wrapper sums along their rows: no atomics, the same
//     bits every run.
//   - x and y cross device memory once (the tiles of one row panel are
//     walked by neighbouring blocks at the same time, so x's re-reads for
//     other column tiles hit L2), and the normalize+ReLU pass and both
//     statistics passes that a separate BatchNorm would make never happen.
//
// float32 (matmul_stats_f32_kernel, run only in the parity checks) keeps a
// plain loop: 128 x 64 tiles, one buffer, FMAs on the CUDA cores so that
// float32 stays full precision (no TF32), a float32 staging tile.
//
// Layout: x (M, K) and y (M, N) row-major; W is passed as Wt (N, K)
// row-major, the layout of a 1x1 conv's OIHW weight. Chunks past M, K or N
// are zero-filled, so any M and any K, N that are multiples of 8 are taken.

#include "mma_pipeline.cuh"

namespace {

using namespace rt;

// BM is also ops/matmul_stats_cuda.py's BLOCK_ROWS: the rows of one partial
constexpr int BM = 128;

// ---------------------------------------------------------------------------
// bf16: the pipelined kernel
// ---------------------------------------------------------------------------

constexpr int kBK = 64, kStages = 4;
constexpr int kCPR = kBK / 8;  // 16-byte chunks in a stage row

template <int BN>
struct FwdSmem {
  static constexpr int WTN = BN / kWarpsN;          // columns of a warp
  static constexpr int A = BM * kBK, B = BN * kBK;  // elements of a stage
  static constexpr int STAGE = (A + B) * 2 + 2 * kBK * 4;  // + a, b
  static constexpr int RING = kStages * STAGE;
  static constexpr int OUT = kThreads / 32 * warp_stage_bytes<WTN>();
  static constexpr int RED = 2 * kWarpsM * BN * 4;
  static constexpr int BYTES = RING + OUT + RED;
};

// __launch_bounds__(256, 2) caps a thread at 128 registers; shared memory
// keeps one block on an SM.
template <int BN, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
matmul_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                    const float* __restrict__ a, const float* __restrict__ b,
                    bf16* __restrict__ y, float* __restrict__ psum,
                    float* __restrict__ psumsq, int M, int K, int N) {
  using S = FwdSmem<BN>;
  constexpr int WTN = S::WTN, NJ = WTN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
  bf16* out_stage = reinterpret_cast<bf16*>(
      smem + S::RING + warp * warp_stage_bytes<WTN>());
  float* red = reinterpret_cast<float*>(smem + S::RING + S::OUT);

  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_m * tiles_n;
  const int ksteps = (K + kBK - 1) / kBK;
  const int my_tiles = (int)blockIdx.x < tiles
                           ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                           : 0;
  const int steps = my_tiles * ksteps;

  // start the copies of step p of the block's sequence into its stage
  auto load_stage = [&](int p) {
    if (p < steps) {
      const int tile = blockIdx.x + (p / ksteps) * gridDim.x;
      const int k0 = (p % ksteps) * kBK;
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      bf16* As = reinterpret_cast<bf16*>(smem + p % kStages * S::STAGE);
      bf16* Bs = As + S::A;
      float* vec = reinterpret_cast<float*>(Bs + S::B);
#pragma unroll
      for (int it = 0; it < BM * kCPR / kThreads; ++it) {
        const int c = tid + it * kThreads, r = c / kCPR, kc = c % kCPR;
        const bool ok = (m0 + r < M) && (k0 + kc * 8 < K);
        cp_async16(As + swz<kCPR>(r, kc), x + (size_t)(m0 + r) * K + k0 + kc * 8,
                   ok, x);
      }
#pragma unroll
      for (int it = 0; it < BN * kCPR / kThreads; ++it) {
        const int c = tid + it * kThreads, r = c / kCPR, kc = c % kCPR;
        const bool ok = (n0 + r < N) && (k0 + kc * 8 < K);
        cp_async16(Bs + swz<kCPR>(r, kc),
                   wt + (size_t)(n0 + r) * K + k0 + kc * 8, ok, wt);
      }
      if (NORMALIZE && tid < 2 * kBK / 4) {  // a then b, 4 floats a chunk
        const int q = tid / (kBK / 4), kc = (tid % (kBK / 4)) * 4;
        cp_async16(vec + q * kBK + kc, (q ? b : a) + k0 + kc, k0 + kc < K, a);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  const int a_base = a_frag_base<kCPR>(wm * kWarpRows, lane);
  const int b_base = b_frag_base<kCPR>(wn * WTN, lane);
  float acc[kMI][NJ][4];
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) load_stage(p);

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's stage landed; the oldest one is free
    load_stage(step + kStages - 1);
    const int ks = step % ksteps;
    if (ks == 0) zero(acc);
    const bf16* As =
        reinterpret_cast<const bf16*>(smem + step % kStages * S::STAGE);
    const bf16* Bs = As + S::A;
    const float* vec = reinterpret_cast<const float*>(Bs + S::B);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // both A fragments first (with the prologue), then the B fragments a
      // pair of 8-column blocks at a time: few registers live at once
      uint32_t af[kMI][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        ldsm_x4(af[i], As + (a_base ^ (kk << 4)) + i * 16 * kBK);
        if constexpr (NORMALIZE) {
          const int k = kk * 16 + 2 * t;
          const float2 alo = *reinterpret_cast<const float2*>(vec + k);
          const float2 ahi = *reinterpret_cast<const float2*>(vec + k + 8);
          const float2 blo = *reinterpret_cast<const float2*>(vec + kBK + k);
          const float2 bhi =
              *reinterpret_cast<const float2*>(vec + kBK + k + 8);
          af[i][0] = prologue2<RELU>(af[i][0], alo.x, alo.y, blo.x, blo.y);
          af[i][1] = prologue2<RELU>(af[i][1], alo.x, alo.y, blo.x, blo.y);
          af[i][2] = prologue2<RELU>(af[i][2], ahi.x, ahi.y, bhi.x, bhi.y);
          af[i][3] = prologue2<RELU>(af[i][3], ahi.x, ahi.y, bhi.x, bhi.y);
        }
      }
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t r[4];
        ldsm_x4(r, Bs + (b_base ^ (kk << 4)) + jj * 16 * kBK);
#pragma unroll
        for (int i = 0; i < kMI; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], r[0], r[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], r[2], r[3]);
        }
      }
    }
    if (ks != ksteps - 1) continue;

    // Epilogue of the tile: column sums of the warp's rows per thread, over
    // the row groups by shuffles, then over the 4 warp rows through `red`.
    const int tile = blockIdx.x + (step / ksteps) * gridDim.x;
    const int tm = tile / tiles_n, m0 = tm * BM, n0 = tile % tiles_n * BN;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = 0.0f, q = 0.0f;
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (m0 + wm * kWarpRows + 16 * i + 8 * h + g < M) {
              const float v = acc[i][j][2 * h + e];
              s += v;
              q = fmaf(v, v, q);
            }
        s = sum_over_rows(s);
        q = sum_over_rows(q);
        if (g == 0) {
          const int col = wn * WTN + 8 * j + 2 * t + e;
          red[wm * BN + col] = s;
          red[(kWarpsM + wm) * BN + col] = q;
        }
      }
    store_warp_tile<WTN>(acc, out_stage, y, m0 + wm * kWarpRows, n0 + wn * WTN,
                         M, N);
    __syncthreads();
    const float sum = reduce_warp_rows<BN, 2>(red);
    if (tid < 2 * BN && n0 + tid % BN < N)
      (tid < BN ? psum : psumsq)[(size_t)(n0 + tid % BN) * tiles_m + tm] = sum;
  }
  cp_async_wait<0>();
}

template <int BN, bool NORMALIZE, bool RELU>
int launch_bf16(const void* x, const void* wt, const void* a, const void* b,
                void* y, void* psum, void* psumsq, int M, int K, int N,
                int grid, cudaStream_t stream) {
  auto kernel = matmul_stats_kernel<BN, NORMALIZE, RELU>;
  constexpr int bytes = FwdSmem<BN>::BYTES;
  static bool smem_set[kMaxDevices] = {};
  const int err = allow_dynamic_smem(kernel, bytes, smem_set);
  if (err != 0) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<bf16*>(y), static_cast<float*>(psum),
      static_cast<float*>(psumsq), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bf16_modes(const void* x, const void* wt, const void* a,
                      const void* b, void* y, void* psum, void* psumsq, int M,
                      int K, int N, int normalize, int relu, int grid,
                      cudaStream_t s) {
#define RT_ARGS x, wt, a, b, y, psum, psumsq, M, K, N, grid, s
  if (!normalize) return launch_bf16<BN, false, false>(RT_ARGS);
  if (relu) return launch_bf16<BN, true, true>(RT_ARGS);
  return launch_bf16<BN, true, false>(RT_ARGS);
#undef RT_ARGS
}

// ---------------------------------------------------------------------------
// float32: the plain tile loop
// ---------------------------------------------------------------------------

constexpr int F_BN = 64, F_BK = 32;

template <bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kThreads)
matmul_stats_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ wt,
                        const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ y,
                        float* __restrict__ psum, float* __restrict__ psumsq,
                        int M, int K, int N) {
  using T = float;
  constexpr int VEC = Chunk<T>::N;
  constexpr int LDT = F_BK + VEC;  // padded tile rows, still 16-byte multiples
  constexpr int LDC = F_BN + 4;
  constexpr int CPR = F_BK / VEC;  // chunks per tile row
  constexpr int A_ITERS = BM * CPR / kThreads;
  constexpr int B_ITERS = F_BN * CPR / kThreads;
  constexpr int TILE_BYTES = (BM + F_BN) * LDT * sizeof(T);
  constexpr int C_BYTES = BM * LDC * sizeof(float);
  constexpr int SMEM = TILE_BYTES > C_BYTES ? TILE_BYTES : C_BYTES;
  // the input tiles and the accumulator staging tile share one buffer
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * LDT;
  float* C = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * F_BN;
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
          v = pack<T>(xv);
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
  TileMma<T, BM, F_BN, F_BK, false, true, LDT, LDT> mma;
  mma.init();

  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    const bool more = k0 + F_BK < K;
    if (more) load_tiles(k0 + F_BK);
    mma.step(As, Bs);
    __syncthreads();
    if (more) {
      store_tiles(k0 + F_BK);
      __syncthreads();
    }
  }

  // Epilogue. Every thread takes 16-byte chunks of y in store order and keeps
  // the column sums of its chunks' columns, from the float32 accumulator.
  mma.store(C, LDC);
  __syncthreads();
  constexpr int CPRO = F_BN / VEC;
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
  const float total = block_column_sums<VEC, F_BN, 2>(part, C);
  if (tid < 2 * F_BN && n0 + tid % F_BN < N)
    (tid < F_BN ? psum : psumsq)[(size_t)(n0 + tid % F_BN) * gridDim.y +
                                 blockIdx.y] = total;
}

int launch_f32(const void* x, const void* wt, const void* a, const void* b,
               void* y, void* psum, void* psumsq, int M, int K, int N,
               int normalize, int relu, cudaStream_t stream) {
  const dim3 grid((N + F_BN - 1) / F_BN, (M + BM - 1) / BM);
#define RT_LAUNCH(NORM, RL)                                                  \
  matmul_stats_f32_kernel<NORM, RL><<<grid, kThreads, 0, stream>>>(          \
      static_cast<const float*>(x), static_cast<const float*>(wt),           \
      static_cast<const float*>(a), static_cast<const float*>(b),            \
      static_cast<float*>(y), static_cast<float*>(psum),                     \
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

// dtype: 0 = bf16, 1 = float32. psum, psumsq: (N, ceil(M/128)) float32.
// bf16 only: tile_n (64 or 128) is the output tile's width and grid the
// number of persistent blocks. Returns the first non-zero CUDA error of the
// launch (0 = launched), or -1 for an argument it does not take.
extern "C" int matmul_stats_launch(const void* x, const void* wt,
                                   const void* a, const void* b, void* y,
                                   void* psum, void* psumsq, int M, int K,
                                   int N, int dtype, int normalize, int relu,
                                   int tile_n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && grid >= 1) {
    if (tile_n == 128)
      return launch_bf16_modes<128>(x, wt, a, b, y, psum, psumsq, M, K, N,
                                    normalize, relu, grid, s);
    if (tile_n == 64)
      return launch_bf16_modes<64>(x, wt, a, b, y, psum, psumsq, M, K, N,
                                   normalize, relu, grid, s);
    return -1;
  }
  if (dtype == 1)
    return launch_f32(x, wt, a, b, y, psum, psumsq, M, K, N, normalize, relu,
                      s);
  return -1;
}
