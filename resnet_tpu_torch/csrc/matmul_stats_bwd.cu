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
// g from tiles of (gy, y), and every shape is taken:
//
//   bwd_dx_kernel  a block owns 128-row tiles of dx, 64, 128 or 256 wide, and
//                  walks N in steps of 64 (A = g, B = Wt as it lies); its
//                  epilogue reads the x tile once for the mask, the `a`
//                  fold and the dgamma/dbeta partials, written as
//                  (K, ceil(M/128)) float32 that the wrapper sums along
//                  their rows: no separate sweep over the activations.
//   bwd_dw_kernel  a block owns work items of a 128-row tile of dW^T (N, K),
//                  64, 128 or 256 wide, and one split of the M rows, walks
//                  the split in steps of 64 rows (A = g read as g^T, B =
//                  act), and writes its float32 partial to (splits, N, K)
//                  scratch that the wrapper sums in a fixed order. The
//                  wrapper picks the splits so that the items fill the
//                  card's waves, at most about one wave of them, so the
//                  partials stay near one wave of tiles.
//
// What bounds it on an H100: memory at most ResNet-50 shapes (it must read
// gy, y, x, W and write dx and dW); the 512x2048 and 1024x2048 shapes are
// bound by the two products. Both kernels read (gy, y), so those cross device
// memory (or L2) twice: that is the price of forming g without storing it.
// What the design does about it (bf16), on the Hopper mainloop of
// wgmma_pipeline.cuh, as in matmul_stats.cu: persistent blocks (one an SM)
// walk their tiles or work items; a ring of shared-memory stages, fed by
// TMA copies that one producer thread keeps in flight, runs over the
// block's whole sequence of (item, step), so the next item's operands load
// during this one's product and epilogue; two consumer warpgroups, 64 rows
// of the output tile each, run wgmma m64nNk16 from shared memory with one
// group in flight. g is formed in place: each warpgroup folds gy, y, gs
// and gss into its own 64 x 64 box of gy (dx: its 64 rows; dW: its 64
// columns n), fences it for the asynchronous proxy and meets at its
// barrier, and the product reads g there: K-major in dx, MN-major (as g^T)
// in dW. B is read MN-major with the transpose bit: Wt (N, K) as it lies
// in dx, x (M, K) in dW; where dW needs act = [relu](x*a + b), both
// warpgroups rewrite the stage's x in place first and meet at one
// barrier. dx leaves by TMA stores from swizzled staging boxes, the dW
// partials straight from the accumulators. No atomics: results are the
// same from run to run. Forming g this way costs both kernels a read of
// gy and y: a 64-deep stage of a 128 x 128 tile carries 44 operations for
// each byte it brings from L2 (gy, y and the other operand), a 128 x 256
// one 65, so the wider tile is taken where it measured faster, and the
// L2-to-SM rate is what the tiles run into (PERF.md).
//
// The float32 kernels (bwd_dx_f32_kernel, bwd_dw_f32_kernel; run only in
// the parity checks) keep a plain loop: 128 x 64 and 64 x 64 tiles, one
// buffer, FMAs through a float32 staging tile.
//
// dW leaves in the weight's own layout, dW^T (N, K). Rows past M (or past a
// split's end) count as g = 0; TMA fills boxes past M, K or N with zeros,
// so any M and any K, N that are multiples of 8 are taken.

#include "wgmma_pipeline.cuh"

namespace {

using namespace rt;

// BM is also ops/matmul_stats_cuda.py's BLOCK_ROWS; kBK its DW_ROW_STEP
// (the rows of a dW stage) and the N depth of a dx stage.
constexpr int BM = 128;
// ring stages of each kernel (ops/matmul_stats_cuda.py::smem_bytes
// mirrors these budgets): dx 3; dW 4, 3 at the 256-wide tile
constexpr int kDxStages = 3;

// gs and 2*gss (see fold2) of 8 columns from n on; zeros past N, where gy
// and y are zero-filled, so g = 0 there (N % 8 == 0: a chunk is in or out)
__device__ __forceinline__ void load_fold_consts(const float* gs,
                                                 const float* gss, int n,
                                                 int N, float (&s2)[8],
                                                 float (&q2)[8]) {
  load8(s2, gs, n, n < N);
  load8(q2, gss, n, n < N);
#pragma unroll
  for (int e = 0; e < 8; ++e) q2[e] *= 2.0f;
}

// ---------------------------------------------------------------------------
// bf16 dx: dx (M, K) = g (M, N) @ Wt (N, K), with the BatchNorm epilogue
// ---------------------------------------------------------------------------

template <int BKO, bool NORMALIZE>
struct DxSmem {
  // columns a store pass: a quarter of the 256-wide tile, for room
  static constexpr int SW = BKO == 256 ? 64 : BKO;
  static constexpr int G = BM * kBK * 2, W = kBK * BKO * 2;  // bytes
  static constexpr int STAGE = 2 * G + W;                    // gy, y, Wt
  static constexpr int RING = kDxStages * STAGE;
  static constexpr int OUT = BM * SW * 2;  // dx's swizzled staging boxes
  static constexpr int RED = 2 * kConsumerWarps * BKO * 4;  // dgamma, dbeta
  // the tile's x and its columns' a, b, inv, minv for the BatchNorm
  // epilogue, copied by TMA (there is no room for them beside the
  // 256-wide ring: the prologue takes 128 at most)
  static constexpr int XT = NORMALIZE ? BM * BKO * 2 + 4 * BKO * 4 : 0;
  static constexpr int BARS = 2 * kDxStages * 8 + (NORMALIZE ? 16 : 0);
  static constexpr int BYTES = kAtomBytes + RING + OUT + RED + XT + BARS;
  static_assert(STAGE % kAtomBytes == 0, "stages stay atom-aligned");
  static_assert(!NORMALIZE || BKO <= 128, "no room for x's tile");
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

template <int BKO, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kBlockThreads, 1)
bwd_dx_kernel(const __grid_constant__ CUtensorMap gy_map,
              const __grid_constant__ CUtensorMap y_map,
              const __grid_constant__ CUtensorMap wt_map,
              const __grid_constant__ CUtensorMap dx_map,
              const __grid_constant__ CUtensorMap x_map,
              const float* __restrict__ gs,
              const float* __restrict__ gss, const float* __restrict__ a,
              const float* __restrict__ b, const float* __restrict__ inv,
              const float* __restrict__ minv, float* __restrict__ pdgamma,
              float* __restrict__ pdbeta, int M, int K, int N) {
  using S = DxSmem<BKO, NORMALIZE>;
  constexpr int R = BKO / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_atoms(smem_raw);
  float* red = reinterpret_cast<float*>(smem + S::RING + S::OUT);
  unsigned char* xtile = smem + S::RING + S::OUT + S::RED;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + S::RING + S::OUT + S::RED + S::XT);
  uint64_t* empty = full + kDxStages;
  uint64_t* xfull = empty + kDxStages;  // x's tile, with the prologue
  uint64_t* xempty = xfull + 1;

  const int tiles_k = cdiv(K, BKO), tiles_m = cdiv(M, BM);
  const int tiles = tiles_m * tiles_k;
  const int nsteps = cdiv(N, kBK);
  const int my_tiles = (int)blockIdx.x < tiles
                           ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                           : 0;
  const int steps = my_tiles * nsteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    if (NORMALIZE) {
      mbar_init(xfull, 1);
      mbar_init(xempty, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int p = 0; p < steps; ++p) {
        const int s = p % kDxStages;
        mbar_wait(&empty[s], ((p / kDxStages) & 1) ^ 1);
        const int tile = blockIdx.x + (p / nsteps) * gridDim.x;
        const int n0 = (p % nsteps) * kBK;
        const int m0 = tile / tiles_k * BM, k0 = tile % tiles_k * BKO;
        unsigned char* st = smem + s * S::STAGE;
        mbar_expect_tx(&full[s], S::STAGE);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tma_box(st + i * kBoxBytes, &gy_map, &full[s], n0, m0 + 64 * i);
          tma_box(st + S::G + i * kBoxBytes, &y_map, &full[s], n0,
                  m0 + 64 * i);
        }
#pragma unroll
        for (int i = 0; i < BKO / 64; ++i)
          tma_box(st + 2 * S::G + i * kBoxBytes, &wt_map, &full[s],
                  k0 + 64 * i, n0);
        if (NORMALIZE && p % nsteps == min(kDxStages, nsteps - 1)) {
          // the tile's x and constants, once the last tile's epilogue has
          // read its own: from this step on the consumers are into this
          // tile, and the copies have the rest of its steps to land
          const int it = p / nsteps;
          const int cols = min(BKO, K - k0);  // K % 8 == 0: 32-byte runs
          mbar_wait(xempty, (it & 1) ^ 1);
          mbar_expect_tx(xfull, BM * BKO * 2 + 4 * cols * 4);
#pragma unroll
          for (int rb = 0; rb < 2; ++rb)
#pragma unroll
            for (int cb = 0; cb < BKO / 64; ++cb)
              tma_box(xtile + (rb * (BKO / 64) + cb) * kBoxBytes, &x_map,
                      xfull, k0 + 64 * cb, m0 + 64 * rb);
          const float* vecs[4] = {a, b, inv, minv};
#pragma unroll
          for (int v = 0; v < 4; ++v)
            bulk_copy(xtile + BM * BKO * 2 + v * BKO * 4, vecs[v] + k0,
                      cols * 4, xfull);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x - kWgThreads;
  const int cw = ct >> 5, cg = cw >> 2;
  const int wt = ct & (kWgThreads - 1);
  const int lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int wrow = 64 * cg + 16 * (cw & 3);
  unsigned char* staging = smem + S::RING + cg * (S::OUT / 2);
  float acc[R];

  // tiles outside, a uniform loop over the N steps inside, as in
  // matmul_stats.cu
  int p = 0, it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    for (int ns = 0; ns < nsteps; ++ns, ++p) {
      const int s = p % kDxStages;
      // gs and 2*gss of the thread's 8 columns, read before the stage
      // arrives
      float s2[8], q2[8];
      load_fold_consts(gs, gss, ns * kBK + 8 * (wt & 7), N, s2, q2);
      unsigned char* st = smem + s * S::STAGE;
      mbar_wait(&full[s], (p / kDxStages) & 1);
      // g in place of gy in the warpgroup's box (its 64 rows); rows past M
      // hold g = gs: the epilogue masks them out and does not store them
      unsigned char* gy_box = st + cg * kBoxBytes;
#pragma unroll
      for (int c = wt; c < kBoxChunks; c += kWgThreads)
        fold_chunk(reinterpret_cast<uint4*>(gy_box + box_chunk(c)),
                   reinterpret_cast<const uint4*>(gy_box + S::G + box_chunk(c)),
                   s2, q2, true);
      fence_async_smem();
      wg_sync(cg);
      // A = g (K-major); B = Wt (n rows, k columns): MN-major, 64-column
      // boxes 8 KB apart, a 16-deep step 16 rows (2048 bytes) further
      const uint64_t da = sw128_desc(st + cg * kBoxBytes, 0, kAtomBytes);
      const uint64_t db = sw128_desc(st + 2 * S::G, kBoxBytes, kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 1>(acc, da + 2 * kk, db + 128 * kk, ns > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (lane == 0 && ns > 0) mbar_arrive(&empty[(p - 1) % kDxStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(p - 1) % kDxStages]);

    // Epilogue of the tile: the mask, the `a` fold and the dgamma/dbeta
    // partials from one read of x, on each column block's values on their
    // way to the staging boxes; dx leaves by TMA stores.
    const int tm = tile / tiles_k, m0 = tm * BM, k0 = tile % tiles_k * BKO;
    auto epilogue = [&](int j, float(&v)[2][2]) {
      if constexpr (NORMALIZE) {
        const int kt = 8 * j + 2 * t;  // within the tile
        const bool col_ok = k0 + kt < K;  // K % 8 == 0: kt + 1 too
        // a, b, inv, minv of the column pair, copied beside x's tile
        const float* cv = reinterpret_cast<const float*>(xtile + BM * BKO * 2);
        float2 av = make_float2(0.f, 0.f), bv = av, iv = av, mv = av;
        if (col_ok) {
          av = *reinterpret_cast<const float2*>(cv + kt);
          bv = *reinterpret_cast<const float2*>(cv + BKO + kt);
          iv = *reinterpret_cast<const float2*>(cv + 2 * BKO + kt);
          mv = *reinterpret_cast<const float2*>(cv + 3 * BKO + kt);
        }
        float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // dgamma, dbeta
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // rows past M hold g = gs, not 0: masked out here, not stored
          const int row = wrow + 8 * h + g;  // within the tile
          const bool ok = (m0 + row < M) && col_ok;
          // x (row, 8j + 2t, +1) in the tile's swizzled boxes; zeros
          // outside the matrix
          const float2 xv = bf2_to_f2(*reinterpret_cast<const uint32_t*>(
              xtile + ((row >> 6) * (BKO / 64) + (j >> 3)) * kBoxBytes +
              (row & 63) * 128 + ((((j & 7) ^ g) & 7) << 4) + 4 * t));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xe = e ? xv.y : xv.x, ae = e ? av.y : av.x;
            const float xh = mul_add(xe, ae, e ? bv.y : bv.x);
            float gxh = v[h][e];
            if (!ok || (RELU && !(xh > 0.0f))) gxh = 0.0f;
            const float xhat = mul_add(xe, e ? iv.y : iv.x, e ? mv.y : mv.x);
            part[0][e] = fmaf(gxh, xhat, part[0][e]);
            part[1][e] += gxh;
            v[h][e] = __fmul_rn(gxh, ae);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dg = sum_over_rows(part[0][e]);
          const float db_ = sum_over_rows(part[1][e]);
          if (g == 0) {
            const int col = 8 * j + 2 * t + e;
            red[cw * BKO + col] = dg;
            red[(kConsumerWarps + cw) * BKO + col] = db_;
          }
        }
      }
    };
    if (NORMALIZE) mbar_wait(xfull, it & 1);
    store_rows<BKO, S::SW>(acc, epilogue, &dx_map, staging, wt, cg,
                           16 * (cw & 3), k0, m0 + 64 * cg);
    if (NORMALIZE && lane == 0) mbar_arrive(xempty);  // x's tile is read
    if constexpr (NORMALIZE) {
      consumer_sync();  // every warp's partials are in `red`
      for (int c = ct; c < 2 * BKO; c += 2 * kWgThreads) {
        const int qn = c / BKO, col = c % BKO;
        float total = 0.0f;
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w)
          total += red[(qn * kConsumerWarps + w) * BKO + col];
        if (k0 + col < K)
          (qn ? pdbeta : pdgamma)[(size_t)(k0 + col) * tiles_m + tm] = total;
      }
      consumer_sync();  // `red` is read before the next tile writes it
    }
  }
  if (wt == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// bf16 dW: dW^T (N, K) = g^T (N, M) @ act (M, K), per split of M
// ---------------------------------------------------------------------------

constexpr int kDwBN = 128;  // rows of a dW^T tile (N)

template <int BKO>
struct DwSmem {
  static constexpr int STAGES = BKO == 256 ? 3 : 4;
  static constexpr int G = kBK * kDwBN * 2, X = kBK * BKO * 2;  // bytes
  static constexpr int STAGE = 2 * G + X;                       // gy, y, x
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BARS = 2 * STAGES * 8;
  static constexpr int BYTES = kAtomBytes + RING + BARS;
  static_assert(STAGE % kAtomBytes == 0, "stages stay atom-aligned");
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

template <int BKO, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kBlockThreads, 1)
bwd_dw_kernel(const __grid_constant__ CUtensorMap gy_map,
              const __grid_constant__ CUtensorMap y_map,
              const __grid_constant__ CUtensorMap x_map,
              const float* __restrict__ gs, const float* __restrict__ gss,
              const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ dwt_part, int M, int K, int N, int splits,
              int rows_per_split) {
  using S = DwSmem<BKO>;
  constexpr int R = BKO / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_atoms(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::RING);
  uint64_t* empty = full + S::STAGES;

  const int tiles_k = cdiv(K, BKO);
  const int tiles = cdiv(N, kDwBN) * tiles_k;
  const int items = tiles * splits;
  const int msteps = rows_per_split / kBK;
  const int my_items = (int)blockIdx.x < items
                           ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                           : 0;
  const int steps = my_items * msteps;
  // item -> (tile, split): consecutive items share rows, so blocks that run
  // together read the same rows of gy, y and x. A step wholly past M (in
  // the last split) is skipped by producer and consumers alike and takes no
  // stage.
  auto item_of = [&](int p) { return blockIdx.x + (p / msteps) * gridDim.x; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int q = 0;  // stages used
      for (int p = 0; p < steps; ++p) {
        const int item = item_of(p), tile = item % tiles;
        const int m0 = item / tiles * rows_per_split + (p % msteps) * kBK;
        if (m0 >= M) continue;
        const int s = q % S::STAGES;
        mbar_wait(&empty[s], ((q / S::STAGES) & 1) ^ 1);
        ++q;
        const int n0 = tile / tiles_k * kDwBN, k0 = tile % tiles_k * BKO;
        unsigned char* st = smem + s * S::STAGE;
        mbar_expect_tx(&full[s], S::STAGE);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tma_box(st + i * kBoxBytes, &gy_map, &full[s], n0 + 64 * i, m0);
          tma_box(st + S::G + i * kBoxBytes, &y_map, &full[s], n0 + 64 * i,
                  m0);
        }
#pragma unroll
        for (int i = 0; i < BKO / 64; ++i)
          tma_box(st + 2 * S::G + i * kBoxBytes, &x_map, &full[s],
                  k0 + 64 * i, m0);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x - kWgThreads;
  const int cw = ct >> 5, cg = cw >> 2;
  const int wt = ct & (kWgThreads - 1);
  const int lane = ct & 31, g = lane >> 2, t = lane & 3;
  // the warp's 16 rows of dW^T (n) within the tile
  const int nrow = 64 * cg + 16 * (cw & 3);
  // act: the thread's one 8-column chunk of x, across both warpgroups
  constexpr int CH = BKO / 8;
  const int kchunk = ct % CH;
  float acc[R];
  float s2[8], q2[8];  // gs, 2*gss of the thread's 8 columns n of its box
  float ak[8], bk[8];  // a, b of its chunk of x
  int q = 0;  // stages used

  // items outside, a uniform loop over the split's steps inside, as in
  // matmul_stats.cu; a step wholly past M ends the item
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item % tiles, split = item / tiles;
    const int n0 = tile / tiles_k * kDwBN, k0 = tile % tiles_k * BKO;
    const int m_end = min(M, (split + 1) * rows_per_split);
    load_fold_consts(gs, gss, n0 + 64 * cg + 8 * (wt & 7), N, s2, q2);
    if constexpr (NORMALIZE) {
      const int k = k0 + 8 * kchunk;
      load8(ak, a, k, k < K);  // K % 8 == 0: the chunk is in or out
      load8(bk, b, k, k < K);
    }
    for (int ms = 0; ms < msteps; ++ms, ++q) {
      const int m0 = split * rows_per_split + ms * kBK;
      if (m0 >= m_end) break;
      const int s = q % S::STAGES;
      unsigned char* st = smem + s * S::STAGE;
      mbar_wait(&full[s], (q / S::STAGES) & 1);
      // g in place of gy in the warpgroup's box (its 64 columns n, the
      // stage's 64 rows m); rows past the split's end: g = 0, not gs
      unsigned char* gy_box = st + cg * kBoxBytes;
#pragma unroll
      for (int c = wt; c < kBoxChunks; c += kWgThreads)
        fold_chunk(reinterpret_cast<uint4*>(gy_box + box_chunk(c)),
                   reinterpret_cast<const uint4*>(gy_box + S::G + box_chunk(c)),
                   s2, q2, m0 + (c >> 3) < m_end);
      unsigned char* xs = st + 2 * S::G;
      if constexpr (NORMALIZE) {
        // act = [relu](x*a + b) in place of x, which both warpgroups read:
        // the thread's chunk kchunk of its rows
#pragma unroll
        for (int i = 0; i < 64 * CH / (2 * kWgThreads); ++i)
          prologue_chunk<RELU>(
              reinterpret_cast<uint4*>(
                  xs + box_chunk((kchunk >> 3) * kBoxChunks +
                                 (ct / CH + i * (2 * kWgThreads / CH)) * 8 +
                                 (kchunk & 7))),
              ak, bk);
        fence_async_smem();
        consumer_sync();
      } else {
        fence_async_smem();
        wg_sync(cg);
      }
      // A = g^T: the warpgroup's box read MN-major (n along its rows, m
      // down them); B = x (or act): MN-major, 64-column boxes 8 KB apart.
      // A 16-deep step (16 rows m) is 2048 bytes further in both.
      const uint64_t da = sw128_desc(st + cg * kBoxBytes, 0, kAtomBytes);
      const uint64_t db = sw128_desc(xs, kBoxBytes, kAtomBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(acc, da + 128 * kk, db + 128 * kk, ms > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (lane == 0 && ms > 0) mbar_arrive(&empty[(q - 1) % S::STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(q - 1) % S::STAGES]);

    // Epilogue of the item: its float32 partial, straight from registers
    float* out = dwt_part + (size_t)split * N * K;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + nrow + 8 * h + g;
#pragma unroll
      for (int j = 0; j < BKO / 8; ++j) {
        const int k = k0 + 8 * j + 2 * t;
        if (n < N && k < K)
          *reinterpret_cast<float2*>(out + (size_t)n * K + k) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: the plain tile loops
// ---------------------------------------------------------------------------

constexpr int F_DX_BM = 128, F_DX_BK = 64, F_DX_BN = 32;  // dx tile; N step
constexpr int F_DW_BN = 64, F_DW_BK = 64, F_DW_BM = 32;   // dW^T tile; M step

template <typename T, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_dx_f32_kernel(const T* __restrict__ gy, const T* __restrict__ y,
              const T* __restrict__ x, const T* __restrict__ wt,
              const float* __restrict__ gs, const float* __restrict__ gss,
              const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ inv, const float* __restrict__ minv,
              T* __restrict__ dx, float* __restrict__ pdgamma,
              float* __restrict__ pdbeta, int M, int K, int N) {
  constexpr int VEC = Chunk<T>::N;
  constexpr int LDA = F_DX_BN + VEC, LDB = F_DX_BK + VEC, LDC = F_DX_BK + 4;
  constexpr int A_CPR = F_DX_BN / VEC, B_CPR = F_DX_BK / VEC;
  constexpr int A_ITERS = F_DX_BM * A_CPR / kThreads;
  constexpr int B_ITERS = F_DX_BN * B_CPR / kThreads;
  constexpr int TILE_BYTES = (F_DX_BM * LDA + F_DX_BN * LDB) * sizeof(T);
  constexpr int C_BYTES = F_DX_BM * LDC * sizeof(float);
  constexpr int SMEM = TILE_BYTES > C_BYTES ? TILE_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + F_DX_BM * LDA;
  float* C = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * F_DX_BK;
  const int m0 = blockIdx.y * F_DX_BM;

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
  TileMma<T, F_DX_BM, F_DX_BK, F_DX_BN, false, false, LDA, LDB> mma;
  mma.init();

  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int n0 = 0; n0 < N; n0 += F_DX_BN) {
    const bool more = n0 + F_DX_BN < N;
    if (more) load_tiles(n0 + F_DX_BN);
    mma.step(As, Bs);
    __syncthreads();
    if (more) {
      store_tiles(n0 + F_DX_BN);
      __syncthreads();
    }
  }

  mma.store(C, LDC);
  __syncthreads();
  constexpr int CPRO = F_DX_BK / VEC;
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
  for (int it = 0; it < F_DX_BM / RSTEP; ++it) {
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
    const float total = block_column_sums<VEC, F_DX_BK, 2>(part, C);
    if (tid < 2 * F_DX_BK && k0 + tid % F_DX_BK < K)
      (tid < F_DX_BK ? pdgamma : pdbeta)
          [(size_t)(k0 + tid % F_DX_BK) * gridDim.y + blockIdx.y] = total;
  }
}

template <typename T, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_dw_f32_kernel(const T* __restrict__ gy, const T* __restrict__ y,
              const T* __restrict__ x, const float* __restrict__ gs,
              const float* __restrict__ gss, const float* __restrict__ a,
              const float* __restrict__ b, float* __restrict__ dwt_part,
              int M, int K, int N, int rows_per_split) {
  constexpr int VEC = Chunk<T>::N;
  constexpr int LDA = F_DW_BN + VEC, LDB = F_DW_BK + VEC, LDC = F_DW_BK + 4;
  constexpr int A_CPR = F_DW_BN / VEC, B_CPR = F_DW_BK / VEC;
  constexpr int A_ITERS = F_DW_BM * A_CPR / kThreads;
  constexpr int B_ITERS = F_DW_BM * B_CPR / kThreads;
  constexpr int TILE_BYTES = F_DW_BM * (LDA + LDB) * sizeof(T);
  constexpr int C_BYTES = F_DW_BN * LDC * sizeof(float);
  constexpr int SMEM = TILE_BYTES > C_BYTES ? TILE_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);  // g tile, [m][n]
  T* Bs = As + F_DW_BM * LDA;            // act tile, [m][k]
  float* C = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * F_DW_BK;
  const int n0 = blockIdx.y * F_DW_BN;
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
  TileMma<T, F_DW_BN, F_DW_BK, F_DW_BM, true, false, LDA, LDB> mma;
  mma.init();

  if (m_begin < m_end) {
    load_tiles(m_begin);
    store_tiles(m_begin);
  }
  __syncthreads();
  for (int m0 = m_begin; m0 < m_end; m0 += F_DW_BM) {
    const bool more = m0 + F_DW_BM < m_end;
    if (more) load_tiles(m0 + F_DW_BM);
    mma.step(As, Bs);
    __syncthreads();
    if (more) {
      store_tiles(m0 + F_DW_BM);
      __syncthreads();
    }
  }

  mma.store(C, LDC);
  __syncthreads();
  constexpr int CPRO = F_DW_BK / 4;  // float4 chunks per row of the partial
  float* out = dwt_part + (size_t)blockIdx.z * N * K;
#pragma unroll
  for (int it = 0; it < F_DW_BN * CPRO / kThreads; ++it) {
    const int c = tid + it * kThreads;
    const int r = c / CPRO, cc = (c % CPRO) * 4;
    if ((n0 + r < N) && (k0 + cc < K))
      *reinterpret_cast<float4*>(out + (size_t)(n0 + r) * K + k0 + cc) =
          *reinterpret_cast<const float4*>(C + r * LDC + cc);
  }
}

struct BwdArgs {
  const void *gy, *y, *x, *wt;
  const float *gs, *gss, *a, *b, *inv, *minv;
  void* dx;
  float *pdgamma, *pdbeta, *dwt_part;
  int M, K, N, splits, rows_per_split;
  int dx_tile, dx_grid, dw_tile, dw_grid;
  cudaStream_t stream;
};

// The bf16 kernels' tensor maps: gy and y (M, N), Wt (N, K), x and dx
// (M, K).
struct Maps {
  CUtensorMap gy, y, wt, x, dx;
};

template <int BKO, bool NORMALIZE, bool RELU>
int launch_dx_bf16(const BwdArgs& p, const Maps& m) {
  auto kernel = bwd_dx_kernel<BKO, NORMALIZE, RELU>;
  constexpr int bytes = DxSmem<BKO, NORMALIZE>::BYTES;
  static bool smem_set[kMaxDevices] = {};
  const int err = allow_dynamic_smem(kernel, bytes, smem_set);
  if (err != 0) return err;
  kernel<<<p.dx_grid, kBlockThreads, bytes, p.stream>>>(
      m.gy, m.y, m.wt, m.dx, m.x, p.gs, p.gss, p.a, p.b, p.inv, p.minv,
      p.pdgamma, p.pdbeta, p.M, p.K, p.N);
  return static_cast<int>(cudaGetLastError());
}

template <int BKO, bool NORMALIZE, bool RELU>
int launch_dw_bf16(const BwdArgs& p, const Maps& m) {
  auto kernel = bwd_dw_kernel<BKO, NORMALIZE, RELU>;
  constexpr int bytes = DwSmem<BKO>::BYTES;
  static bool smem_set[kMaxDevices] = {};
  const int err = allow_dynamic_smem(kernel, bytes, smem_set);
  if (err != 0) return err;
  kernel<<<p.dw_grid, kBlockThreads, bytes, p.stream>>>(
      m.gy, m.y, m.x, p.gs, p.gss, p.a, p.b, p.dwt_part, p.M, p.K, p.N,
      p.splits, p.rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <bool NORMALIZE, bool RELU>
int launch_bf16(const BwdArgs& p) {
  Maps m;
  int err;
  if ((err = encode_box_map(&m.gy, p.gy, p.M, p.N)) != 0) return err;
  if ((err = encode_box_map(&m.y, p.y, p.M, p.N)) != 0) return err;
  if ((err = encode_box_map(&m.wt, p.wt, p.N, p.K)) != 0) return err;
  if ((err = encode_box_map(&m.x, p.x, p.M, p.K)) != 0) return err;
  if ((err = encode_box_map(&m.dx, p.dx, p.M, p.K)) != 0) return err;
  if constexpr (NORMALIZE) {  // x's tile takes the room of a wider one
    if (p.dx_tile == 256) return kBadArgument;
    err = p.dx_tile == 128 ? launch_dx_bf16<128, true, RELU>(p, m)
                           : launch_dx_bf16<64, true, RELU>(p, m);
  } else {
    err = p.dx_tile == 256   ? launch_dx_bf16<256, false, false>(p, m)
          : p.dx_tile == 128 ? launch_dx_bf16<128, false, false>(p, m)
                             : launch_dx_bf16<64, false, false>(p, m);
  }
  if (err != 0) return err;
  return p.dw_tile == 256   ? launch_dw_bf16<256, NORMALIZE, RELU>(p, m)
         : p.dw_tile == 128 ? launch_dw_bf16<128, NORMALIZE, RELU>(p, m)
                            : launch_dw_bf16<64, NORMALIZE, RELU>(p, m);
}

template <bool NORMALIZE, bool RELU>
int launch_f32(const BwdArgs& p) {
  using T = float;
  const dim3 dx_grid((p.K + F_DX_BK - 1) / F_DX_BK,
                     (p.M + F_DX_BM - 1) / F_DX_BM);
  bwd_dx_f32_kernel<T, NORMALIZE, RELU><<<dx_grid, kThreads, 0, p.stream>>>(
      static_cast<const T*>(p.gy), static_cast<const T*>(p.y),
      static_cast<const T*>(p.x), static_cast<const T*>(p.wt), p.gs, p.gss,
      p.a, p.b, p.inv, p.minv, static_cast<T*>(p.dx), p.pdgamma, p.pdbeta,
      p.M, p.K, p.N);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 dw_grid((p.K + F_DW_BK - 1) / F_DW_BK,
                     (p.N + F_DW_BN - 1) / F_DW_BN, p.splits);
  bwd_dw_f32_kernel<T, NORMALIZE, RELU><<<dw_grid, kThreads, 0, p.stream>>>(
      static_cast<const T*>(p.gy), static_cast<const T*>(p.y),
      static_cast<const T*>(p.x), p.gs, p.gss, p.a, p.b, p.dwt_part, p.M,
      p.K, p.N, p.rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <template <bool, bool> class L>
int by_mode(const BwdArgs& p, int normalize, int relu) {
  if (!normalize) return L<false, false>::run(p);
  if (relu) return L<true, true>::run(p);
  return L<true, false>::run(p);
}

template <bool NORMALIZE, bool RELU>
struct Bf16 {
  static int run(const BwdArgs& p) { return launch_bf16<NORMALIZE, RELU>(p); }
};
template <bool NORMALIZE, bool RELU>
struct F32 {
  static int run(const BwdArgs& p) { return launch_f32<NORMALIZE, RELU>(p); }
};

bool is_tile(int t) { return t == 64 || t == 128 || t == 256; }

}  // namespace

// dtype: 0 = bf16, 1 = float32. gs, gss: (N,) float32; a, b, inv, minv: (K,)
// float32, read only with normalize. pdgamma, pdbeta: (K, ceil(M/128))
// float32, written only with normalize. dwt_part: (splits, N, K) float32 with
// splits * rows_per_split >= M > (splits - 1) * rows_per_split and
// rows_per_split a multiple of 64. bf16 only: dx_tile and dw_tile (64, 128
// or 256) are the K-width of the dx and dW^T tiles, dx_grid and dw_grid the
// number of persistent blocks of each kernel; gy, y, x, wt and dx 16-byte
// aligned. Starts both kernels on `stream`; returns the first non-zero CUDA
// error, 0 if both launched, or a negative code of wgmma_pipeline.cuh
// (kBadArgument for an argument it does not take).
extern "C" int matmul_stats_bwd_launch(
    const void* gy, const void* y, const void* x, const void* wt,
    const void* gs, const void* gss, const void* a, const void* b,
    const void* inv, const void* minv, void* dx, void* pdgamma, void* pdbeta,
    void* dwt_part, int M, int K, int N, int splits, int rows_per_split,
    int dtype, int normalize, int relu, int dx_tile, int dx_grid, int dw_tile,
    int dw_grid, void* stream) {
  if (M < 1 || K < 1 || N < 1 || K % 8 || N % 8 || splits < 1 ||
      rows_per_split % kBK != 0 || (long long)splits * rows_per_split < M ||
      (long long)(splits - 1) * rows_per_split >= M)
    return kBadArgument;
  const BwdArgs p{gy,
                  y,
                  x,
                  wt,
                  static_cast<const float*>(gs),
                  static_cast<const float*>(gss),
                  static_cast<const float*>(a),
                  static_cast<const float*>(b),
                  static_cast<const float*>(inv),
                  static_cast<const float*>(minv),
                  dx,
                  static_cast<float*>(pdgamma),
                  static_cast<float*>(pdbeta),
                  static_cast<float*>(dwt_part),
                  M,
                  K,
                  N,
                  splits,
                  rows_per_split,
                  dx_tile,
                  dx_grid,
                  dw_tile,
                  dw_grid,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    if (!is_tile(dx_tile) || !is_tile(dw_tile) || dx_grid < 1 || dw_grid < 1)
      return kBadArgument;
    return by_mode<Bf16>(p, normalize, relu);
  }
  if (dtype == 1) return by_mode<F32>(p, normalize, relu);
  return kBadArgument;
}
