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
// shapes. What the design does about it (bf16, matmul_stats_kernel, on the
// Hopper mainloop of wgmma_pipeline.cuh):
//
//   - A persistent grid (one block an SM) walks its output tiles of 128
//     rows by 64, 128 or 256 columns (ops/matmul_stats_cuda.py picks the
//     width), and a ring of shared-memory stages (5; 3 at width 256) runs
//     over the block's whole sequence of (tile, 64-deep k step): one
//     producer thread keeps TMA copies of the x and Wt boxes in flight,
//     so the next tile's operands load during this tile's product and
//     epilogue. At K = 64 a tile is one stage, and the ring is what keeps
//     memory busy. A 64-deep stage of a 128-wide tile carries 65
//     operations for each byte it brings from L2, a 256-wide one 87: at
//     the wide shapes the rate at which L2 feeds the SMs, not the tensor
//     cores, is what the tiles run into (PERF.md), which is why the wider
//     tile is taken where it measured faster.
//   - Two consumer warpgroups, 64 rows of the tile each, run wgmma m64nNk16
//     with both operands read from the swizzled stages through descriptors
//     (N = the tile's width), so no thread spends registers or
//     instructions on moving operands, and one group of products stays in
//     flight while the warpgroup waits for and prepares the next stage.
//     With the prologue, x cannot be read as it lies: the producer
//     warpgroup's three transform warps rewrite each stage's x in place
//     as [relu](x*a + b) (float32, rounded to bf16), fence it for the
//     asynchronous proxy and hand the stage on through a `ready` barrier,
//     so the consumers only run products and epilogues.
//   - The epilogue takes the column sums from the float32 accumulators
//     (rows past M are left out) by warp shuffles, then across the 8 warps
//     in a fixed order; y leaves through swizzled staging boxes by TMA
//     stores that run on while the next tile is computed. The statistics
//     leave as (N, ceil(M/128)) float32 partials that the wrapper sums
//     along their rows: no atomics, the same bits every run.
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
// row-major, the layout of a 1x1 conv's OIHW weight. TMA fills boxes past
// M, K or N with zeros, so any M and any K, N that are multiples of 8 (16-
// byte row pitches) are taken.

#include "wgmma_pipeline.cuh"

namespace {

using namespace rt;

// BM is also ops/matmul_stats_cuda.py's BLOCK_ROWS: the rows of one partial
constexpr int BM = 128;

// ---------------------------------------------------------------------------
// bf16: the Hopper kernel
// ---------------------------------------------------------------------------

// ops/matmul_stats_cuda.py::smem_bytes mirrors this budget: 5 stages, 3
// at the 256-wide tile, whose stages are half as large again.
template <int BN>
struct FwdSmem {
  static constexpr int STAGES = BN == 256 ? 3 : 5;
  static constexpr int SW = BN < 128 ? BN : 128;  // columns a store pass
  static constexpr int A = BM * kBK * 2, B = BN * kBK * 2;  // bytes
  static constexpr int STAGE = A + B;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int OUT = BM * SW * 2;  // y's swizzled staging boxes
  static constexpr int RED = 2 * kConsumerWarps * BN * 4;  // (sum, sumsq)
  static constexpr int BARS = 3 * STAGES * 8;  // full, empty, ready
  static constexpr int BYTES = kAtomBytes + RING + OUT + RED + BARS;
  static_assert(STAGE % kAtomBytes == 0, "stages stay atom-aligned");
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

template <int BN, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kBlockThreads, 1)
matmul_stats_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap wt_map,
                    const __grid_constant__ CUtensorMap y_map,
                    const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ psum, float* __restrict__ psumsq,
                    int M, int K, int N) {
  using S = FwdSmem<BN>;
  constexpr int R = BN / 2;  // accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_atoms(smem_raw);
  float* red = reinterpret_cast<float*>(smem + S::RING + S::OUT);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::RING + S::OUT + S::RED);
  constexpr int STAGES = S::STAGES;
  uint64_t* empty = full + STAGES;
  uint64_t* ready = empty + STAGES;  // transformed (with the prologue)

  const int tiles_n = cdiv(N, BN), tiles_m = cdiv(M, BM);
  const int tiles = tiles_m * tiles_n;
  const int ksteps = cdiv(K, kBK);
  const int my_tiles = (int)blockIdx.x < tiles
                           ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                           : 0;
  const int steps = my_tiles * ksteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
      mbar_init(&ready[s], kTransformWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int p = 0; p < steps; ++p) {
        const int s = p % STAGES;
        mbar_wait(&empty[s], ((p / STAGES) & 1) ^ 1);
        const int tile = blockIdx.x + (p / ksteps) * gridDim.x;
        const int k0 = (p % ksteps) * kBK;
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        unsigned char* st = smem + s * S::STAGE;
        mbar_expect_tx(&full[s], S::STAGE);
        tma_box(st, &x_map, &full[s], k0, m0);
        tma_box(st + kBoxBytes, &x_map, &full[s], k0, m0 + 64);
#pragma unroll
        for (int i = 0; i < BN / 64; ++i)
          tma_box(st + S::A + i * kBoxBytes, &wt_map, &full[s], k0,
                  n0 + 64 * i);
      }
    } else if (NORMALIZE && threadIdx.x >= 32) {
      // act = [relu](x*a + b), rounded to bf16, in place of each stage's x
      // (both 64-row boxes); a thread keeps one 8-column chunk, so a, b of
      // its columns are read once a stage (zeros past K, where x is
      // zero-filled, so act = 0 there)
      const int tt = threadIdx.x - 32;
      for (int p = 0; p < steps; ++p) {
        const int s = p % STAGES;
        const int k = (p % ksteps) * kBK + 8 * (tt & 7);
        float av[8], bv[8];
        load8(av, a, k, k < K);  // K % 8 == 0: the chunk is in or out
        load8(bv, b, k, k < K);
        unsigned char* st = smem + s * S::STAGE;
        mbar_wait(&full[s], (p / STAGES) & 1);
        for (int c = tt; c < 2 * kBoxChunks; c += kTransformThreads)
          prologue_chunk<RELU>(reinterpret_cast<uint4*>(st + box_chunk(c)),
                               av, bv);
        transformed(&ready[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x - kWgThreads;  // consumer thread, 0..255
  const int cw = ct >> 5, cg = cw >> 2;     // consumer warp, warpgroup
  const int wt = ct & (kWgThreads - 1);     // thread of the warpgroup
  const int lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int wrow = 64 * cg + 16 * (cw & 3);  // the warp's first tile row
  unsigned char* staging = smem + S::RING + cg * (S::OUT / 2);
  float acc[R];

  // The block's tiles, each a uniform loop over its k steps that keeps one
  // group of products in flight (the previous step's stage is released
  // once its group is done), then a full wait and the epilogue: ptxas
  // follows that shape and adds no waits of its own.
  int p = 0;  // the block's step, and so its stage in the ring
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int ks = 0; ks < ksteps; ++ks, ++p) {
      const int s = p % STAGES;
      unsigned char* st = smem + s * S::STAGE;
      // the stage as TMA left it, or as the transform warps left it
      mbar_wait(NORMALIZE ? &ready[s] : &full[s], (p / STAGES) & 1);
      // A = the warpgroup's box of x (or act), B = the Wt boxes: K-major
      const uint64_t da = sw128_desc(st + cg * kBoxBytes, 0, kAtomBytes);
      const uint64_t db = sw128_desc(st + S::A, 0, kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 0>(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (lane == 0 && ks > 0) mbar_arrive(&empty[(p - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(p - 1) % STAGES]);

    // Epilogue of the tile: column sums of the warp's 16 rows, over the row
    // groups by shuffles, then over the 8 warps through `red`; y through
    // the warpgroup's staging boxes and TMA stores.
    const int tm = tile / tiles_n, m0 = tm * BM, n0 = tile % tiles_n * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sv = 0.0f, q = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (m0 + wrow + 8 * h + g < M) {
            const float v = acc[4 * j + 2 * h + e];
            sv += v;
            q = fmaf(v, v, q);
          }
        sv = sum_over_rows(sv);
        q = sum_over_rows(q);
        if (g == 0) {
          const int col = 8 * j + 2 * t + e;
          red[cw * BN + col] = sv;
          red[(kConsumerWarps + cw) * BN + col] = q;
        }
      }
    store_rows<BN, S::SW>(acc, [](int, float(&)[2][2]) {}, &y_map, staging,
                          wt, cg, 16 * (cw & 3), n0, m0 + 64 * cg);
    consumer_sync();  // every warp's partials are in `red`
    for (int c = ct; c < 2 * BN; c += 2 * kWgThreads) {
      const int qn = c / BN, col = c % BN;
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w)
        total += red[(qn * kConsumerWarps + w) * BN + col];
      if (n0 + col < N)
        (qn ? psumsq : psum)[(size_t)(n0 + col) * tiles_m + tm] = total;
    }
    consumer_sync();  // `red` is read before the next tile writes it
  }
  if (wt == 0) bulk_wait();
}

template <int BN, bool NORMALIZE, bool RELU>
int launch_bf16(const void* x, const void* wt, const void* a, const void* b,
                void* y, void* psum, void* psumsq, int M, int K, int N,
                int grid, cudaStream_t stream) {
  auto kernel = matmul_stats_kernel<BN, NORMALIZE, RELU>;
  constexpr int bytes = FwdSmem<BN>::BYTES;
  static bool smem_set[kMaxDevices] = {};
  int err = allow_dynamic_smem(kernel, bytes, smem_set);
  if (err != 0) return err;
  CUtensorMap x_map, wt_map, y_map;
  if ((err = encode_box_map(&x_map, x, M, K)) != 0) return err;
  if ((err = encode_box_map(&wt_map, wt, N, K)) != 0) return err;
  if ((err = encode_box_map(&y_map, y, M, N)) != 0) return err;
  kernel<<<grid, kBlockThreads, bytes, stream>>>(
      x_map, wt_map, y_map, static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(psum),
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
// bf16 only: tile_n (64, 128 or 256) is the output tile's width and grid the
// number of persistent blocks; x and wt 16-byte aligned. Returns the first
// non-zero CUDA error of the launch (0 = launched), or a negative code of
// wgmma_pipeline.cuh (kBadArgument for an argument it does not take).
extern "C" int matmul_stats_launch(const void* x, const void* wt,
                                   const void* a, const void* b, void* y,
                                   void* psum, void* psumsq, int M, int K,
                                   int N, int dtype, int normalize, int relu,
                                   int tile_n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || K % 8 || N % 8) return kBadArgument;
  if (dtype == 0 && grid >= 1) {
    if (tile_n == 256)
      return launch_bf16_modes<256>(x, wt, a, b, y, psum, psumsq, M, K, N,
                                    normalize, relu, grid, s);
    if (tile_n == 128)
      return launch_bf16_modes<128>(x, wt, a, b, y, psum, psumsq, M, K, N,
                                    normalize, relu, grid, s);
    if (tile_n == 64)
      return launch_bf16_modes<64>(x, wt, a, b, y, psum, psumsq, M, K, N,
                                   normalize, relu, grid, s);
    return kBadArgument;
  }
  if (dtype == 1)
    return launch_f32(x, wt, a, b, y, psum, psumsq, M, K, N, normalize, relu,
                      s);
  return kBadArgument;
}
