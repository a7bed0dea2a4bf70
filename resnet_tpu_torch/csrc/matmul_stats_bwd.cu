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
//   bwd_dx_kernel  a block owns 128 x 128 (or 128 x 64) tiles of dx and
//                  walks N in steps of 64 (A = g, B = Wt as it lies); its
//                  epilogue reads the x tile once for the mask, the `a`
//                  fold and the dgamma/dbeta partials, written as
//                  (K, ceil(M/128)) float32 that the wrapper sums along
//                  their rows: no separate sweep over the activations.
//   bwd_dw_kernel  a block owns work items of a 128 x 128 (or 128 x 64)
//                  tile of dW^T (N, K) and one split of the M rows, walks
//                  the split in steps of 64 rows (A = g read as g^T, B = act
//                  recomputed from x), and writes its float32 partial to
//                  (splits, N, K) scratch that the wrapper sums in a fixed
//                  order. The wrapper picks the splits so that the items
//                  fill the card's waves, at most about one wave of them,
//                  so the partials stay near one wave of tiles.
//
// What bounds it on an H100: memory at most ResNet-50 shapes (it must read
// gy, y, x, W and write dx and dW); the 512x2048 and 1024x2048 shapes are
// bound by the two products. Both kernels read (gy, y), so those cross device
// memory (or L2) twice: that is the price of forming g without storing it.
// What the design does about it (bf16), as in matmul_stats.cu: persistent
// blocks (one an SM) walk their tiles or work items, a ring of 3
// shared-memory stages fed by 16-byte cp.async copies runs over the block's
// whole sequence of (item, step), so the next item's operands load during
// this one's product and epilogue; XOR-swizzled stages read with ldmatrix
// (.trans where the operand lies the other way: W in dx, g and act in dW)
// feed mma.sync m16n8k16 from registers, 8 warps as 4 x 2. The fold of g
// and the prologue of act run on the fragments in registers, with gs, gss,
// a and b staged beside each stage; the accumulators stay in registers into
// the epilogues. No atomics: results are the same from run to run.
//
// The float32 kernels (bwd_dx_f32_kernel, bwd_dw_f32_kernel; run only in
// the parity checks) keep a plain loop: 128 x 64 and 64 x 64 tiles, one
// buffer, FMAs through a float32 staging tile.
//
// dW leaves in the weight's own layout, dW^T (N, K). Rows past M (or past a
// split's end) count as g = 0; chunks past K or N are zero-filled, so any M
// and any K, N that are multiples of 8 are taken.

#include "mma_pipeline.cuh"

namespace {

using namespace rt;

// BM is also ops/matmul_stats_cuda.py's BLOCK_ROWS; kRedStep its DW_ROW_STEP
constexpr int BM = 128;
constexpr int kRedStep = 64;  // depth of a stage: N for dx, M rows for dW
constexpr int kDxStages = 3, kDwStages = 3;  // ring stages of each kernel

// zero the halves of a bf16x2 register whose element is not kept
__device__ __forceinline__ uint32_t keep2(uint32_t v, bool lo, bool hi) {
  return v & ((lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u));
}

// ---------------------------------------------------------------------------
// bf16 dx: dx (M, K) = g (M, N) @ Wt (N, K), with the BatchNorm epilogue
// ---------------------------------------------------------------------------

template <int BKO>
struct DxSmem {
  static constexpr int WTN = BKO / kWarpsN;
  static constexpr int CPR_G = kRedStep / 8, CPR_W = BKO / 8;
  static constexpr int G = BM * kRedStep, W = kRedStep * BKO;  // elements
  static constexpr int STAGE = (2 * G + W) * 2 + 2 * kRedStep * 4;  // +gs,gss
  static constexpr int RING = kDxStages * STAGE;
  static constexpr int OUT = kThreads / 32 * warp_stage_bytes<WTN>();
  static constexpr int RED = 2 * kWarpsM * BKO * 4;
  static constexpr int BYTES = RING + OUT + RED;
};

// __launch_bounds__(256, 2) caps a thread at 128 registers; shared memory
// keeps one block on an SM.
template <int BKO, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dx_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
              const bf16* __restrict__ x, const bf16* __restrict__ wt,
              const float* __restrict__ gs, const float* __restrict__ gss,
              const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ inv, const float* __restrict__ minv,
              bf16* __restrict__ dx, float* __restrict__ pdgamma,
              float* __restrict__ pdbeta, int M, int K, int N) {
  using S = DxSmem<BKO>;
  constexpr int WTN = S::WTN, NJ = WTN / 8;
  constexpr int CPR_G = S::CPR_G, CPR_W = S::CPR_W;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
  bf16* out_stage = reinterpret_cast<bf16*>(
      smem + S::RING + warp * warp_stage_bytes<WTN>());
  float* red = reinterpret_cast<float*>(smem + S::RING + S::OUT);

  const int tiles_k = (K + BKO - 1) / BKO, tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_m * tiles_k;
  const int nsteps = (N + kRedStep - 1) / kRedStep;
  const int my_tiles = (int)blockIdx.x < tiles
                           ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                           : 0;
  const int steps = my_tiles * nsteps;

  auto load_stage = [&](int p) {
    if (p < steps) {
      // this thread's chunk coordinates, recomputed each step rather than
      // held in registers across the loop: the empty asm hides tid's value,
      // so the compiler cannot hoist them (with them hoisted, the 128
      // registers a thread has spill)
      int tid = threadIdx.x;
      asm volatile("" : "+r"(tid));
      const int tile = blockIdx.x + (p / nsteps) * gridDim.x;
      const int n0 = (p % nsteps) * kRedStep;
      const int m0 = tile / tiles_k * BM, k0 = tile % tiles_k * BKO;
      bf16* Gys = reinterpret_cast<bf16*>(smem + p % kDxStages * S::STAGE);
      bf16* Ys = Gys + S::G;
      bf16* Ws = Ys + S::G;
      float* vec = reinterpret_cast<float*>(Ws + S::W);
#pragma unroll
      for (int it = 0; it < BM * CPR_G / kThreads; ++it) {
        const int c = tid + it * kThreads, r = c / CPR_G, nc = c % CPR_G;
        const bool ok = (m0 + r < M) && (n0 + nc * 8 < N);
        const size_t at = (size_t)(m0 + r) * N + n0 + nc * 8;
        cp_async16(Gys + swz<CPR_G>(r, nc), gy + at, ok, gy);
        cp_async16(Ys + swz<CPR_G>(r, nc), y + at, ok, y);
      }
#pragma unroll
      for (int it = 0; it < kRedStep * CPR_W / kThreads; ++it) {
        const int c = tid + it * kThreads, r = c / CPR_W, kc = c % CPR_W;
        const bool ok = (n0 + r < N) && (k0 + kc * 8 < K);
        cp_async16(Ws + swz<CPR_W>(r, kc),
                   wt + (size_t)(n0 + r) * K + k0 + kc * 8, ok, wt);
      }
      if (tid < 2 * kRedStep / 4) {  // gs then gss, 4 floats a chunk
        const int q = tid / (kRedStep / 4), nc = (tid % (kRedStep / 4)) * 4;
        cp_async16(vec + q * kRedStep + nc, (q ? gss : gs) + n0 + nc,
                   n0 + nc < N, gs);
      }
    }
    cp_async_commit();
  };

  const int a_base = a_frag_base<CPR_G>(wm * kWarpRows, lane);
  const int bt_base = bt_frag_base<CPR_W>(wn * WTN / 8, lane);
  float acc[kMI][NJ][4];
#pragma unroll
  for (int p = 0; p < kDxStages - 1; ++p) load_stage(p);

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kDxStages - 2>();
    __syncthreads();
    load_stage(step + kDxStages - 1);
    const int ns = step % nsteps;
    if (ns == 0) zero(acc);
    const bf16* Gys =
        reinterpret_cast<const bf16*>(smem + step % kDxStages * S::STAGE);
    const bf16* Ys = Gys + S::G;
    const bf16* Ws = Ys + S::G;
    const float* vec = reinterpret_cast<const float*>(Ws + S::W);
#pragma unroll
    for (int kk = 0; kk < kRedStep / 16; ++kk) {
      // both g fragments first, then the W fragments a pair of 8-column
      // blocks at a time: few registers live at once
      const int n = kk * 16 + 2 * t;
      const float2 slo = *reinterpret_cast<const float2*>(vec + n);
      const float2 shi = *reinterpret_cast<const float2*>(vec + n + 8);
      float2 qlo = *reinterpret_cast<const float2*>(vec + kRedStep + n);
      float2 qhi = *reinterpret_cast<const float2*>(vec + kRedStep + n + 8);
      qlo.x *= 2.0f;  // 2*gss: see fold2
      qlo.y *= 2.0f;
      qhi.x *= 2.0f;
      qhi.y *= 2.0f;
      uint32_t af[kMI][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int off = (a_base ^ (kk << 4)) + i * 16 * kRedStep;
        uint32_t yf[4];
        ldsm_x4(af[i], Gys + off);
        ldsm_x4(yf, Ys + off);
        af[i][0] = fold2(af[i][0], yf[0], slo.x, slo.y, qlo.x, qlo.y);
        af[i][1] = fold2(af[i][1], yf[1], slo.x, slo.y, qlo.x, qlo.y);
        af[i][2] = fold2(af[i][2], yf[2], shi.x, shi.y, qhi.x, qhi.y);
        af[i][3] = fold2(af[i][3], yf[3], shi.x, shi.y, qhi.x, qhi.y);
      }
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t r[4];
        ldsm_x4_trans(r, Ws + (bt_base ^ (jj << 4)) + kk * 16 * BKO);
#pragma unroll
        for (int i = 0; i < kMI; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], r[0], r[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], r[2], r[3]);
        }
      }
    }
    if (ns != nsteps - 1) continue;

    // Epilogue of the tile. Rows past M hold g = gs, not 0: they are masked
    // out of the dgamma/dbeta sums and not stored.
    const int tile = blockIdx.x + (step / nsteps) * gridDim.x;
    const int tm = tile / tiles_k, m0 = tm * BM, k0 = tile % tiles_k * BKO;
    if constexpr (NORMALIZE) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k = k0 + wn * WTN + 8 * j + 2 * t;
        const bool col_ok = k < K;  // K % 8 == 0: k + 1 < K too
        float2 av = make_float2(0.f, 0.f), bv = av, iv = av, mv = av;
        if (col_ok) {
          av = __ldg(reinterpret_cast<const float2*>(a + k));
          bv = __ldg(reinterpret_cast<const float2*>(b + k));
          iv = __ldg(reinterpret_cast<const float2*>(inv + k));
          mv = __ldg(reinterpret_cast<const float2*>(minv + k));
        }
        float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // dgamma, dbeta
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm * kWarpRows + 16 * i + 8 * h + g;
            const bool ok = (row < M) && col_ok;
            uint32_t xr = 0u;
            if (ok) xr = __ldg(reinterpret_cast<const unsigned int*>(
                        x + (size_t)row * K + k));
            const float2 xv = bf2_to_f2(xr);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float xe = e ? xv.y : xv.x, ae = e ? av.y : av.x;
              const float xh = mul_add(xe, ae, e ? bv.y : bv.x);
              float gxh = acc[i][j][2 * h + e];
              if (!ok || (RELU && !(xh > 0.0f))) gxh = 0.0f;
              const float xhat = mul_add(xe, e ? iv.y : iv.x, e ? mv.y : mv.x);
              part[0][e] = fmaf(gxh, xhat, part[0][e]);
              part[1][e] += gxh;
              acc[i][j][2 * h + e] = __fmul_rn(gxh, ae);
            }
          }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dg = sum_over_rows(part[0][e]);
          const float db = sum_over_rows(part[1][e]);
          if (g == 0) {
            const int col = wn * WTN + 8 * j + 2 * t + e;
            red[wm * BKO + col] = dg;
            red[(kWarpsM + wm) * BKO + col] = db;
          }
        }
      }
    }
    store_warp_tile<WTN>(acc, out_stage, dx, m0 + wm * kWarpRows,
                         k0 + wn * WTN, M, K);
    if constexpr (NORMALIZE) {
      __syncthreads();
      const float sum = reduce_warp_rows<BKO, 2>(red);
      if (tid < 2 * BKO && k0 + tid % BKO < K)
        (tid < BKO ? pdgamma : pdbeta)[(size_t)(k0 + tid % BKO) * tiles_m +
                                       tm] = sum;
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// bf16 dW: dW^T (N, K) = g^T (N, M) @ act (M, K), per split of M
// ---------------------------------------------------------------------------

constexpr int kDwBN = 128;  // rows of a dW^T tile (N)

template <int BKO>
struct DwSmem {
  static constexpr int WTN = BKO / kWarpsN;
  static constexpr int CPR_G = kDwBN / 8, CPR_X = BKO / 8;
  static constexpr int G = kRedStep * kDwBN, X = kRedStep * BKO;  // elements
  // + gs, gss (kDwBN each), a, b (BKO each)
  static constexpr int STAGE = (2 * G + X) * 2 + (2 * kDwBN + 2 * BKO) * 4;
  static constexpr int BYTES = kDwStages * STAGE;
};

template <int BKO, bool NORMALIZE, bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dw_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
              const bf16* __restrict__ x, const float* __restrict__ gs,
              const float* __restrict__ gss, const float* __restrict__ a,
              const float* __restrict__ b, float* __restrict__ dwt_part,
              int M, int K, int N, int splits, int rows_per_split) {
  using S = DwSmem<BKO>;
  constexpr int WTN = S::WTN, NJ = WTN / 8;
  constexpr int CPR_G = S::CPR_G, CPR_X = S::CPR_X;
  constexpr int NVEC = (2 * kDwBN + 2 * BKO) / 4;  // vector chunks a stage
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;

  const int tiles_k = (K + BKO - 1) / BKO;
  const int tiles = (N + kDwBN - 1) / kDwBN * tiles_k;
  const int items = tiles * splits;
  const int msteps = rows_per_split / kRedStep;
  const int my_items = (int)blockIdx.x < items
                           ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                           : 0;
  const int steps = my_items * msteps;
  // item -> (tile, split): consecutive items share rows, so blocks that run
  // together read the same rows of gy, y and x
  auto item_of = [&](int p) { return blockIdx.x + (p / msteps) * gridDim.x; };

  auto load_stage = [&](int p) {
    if (p < steps) {
      // this thread's chunk coordinates, recomputed each step rather than
      // held in registers across the loop: the empty asm hides tid's value,
      // so the compiler cannot hoist them (with them hoisted, the 128
      // registers a thread has spill)
      int tid = threadIdx.x;
      asm volatile("" : "+r"(tid));
      const int item = item_of(p), tile = item % tiles, split = item / tiles;
      const int n0 = tile / tiles_k * kDwBN, k0 = tile % tiles_k * BKO;
      const int m_end = min(M, (split + 1) * rows_per_split);
      const int m0 = split * rows_per_split + (p % msteps) * kRedStep;
      if (m0 < m_end) {  // a step wholly past the split's end loads nothing
        bf16* Gys = reinterpret_cast<bf16*>(smem + p % kDwStages * S::STAGE);
        bf16* Ys = Gys + S::G;
        bf16* Xs = Ys + S::G;
        float* vec = reinterpret_cast<float*>(Xs + S::X);
#pragma unroll
        for (int it = 0; it < kRedStep * CPR_G / kThreads; ++it) {
          const int c = tid + it * kThreads, r = c / CPR_G, nc = c % CPR_G;
          const bool ok = (m0 + r < m_end) && (n0 + nc * 8 < N);
          const size_t at = (size_t)(m0 + r) * N + n0 + nc * 8;
          cp_async16(Gys + swz<CPR_G>(r, nc), gy + at, ok, gy);
          cp_async16(Ys + swz<CPR_G>(r, nc), y + at, ok, y);
        }
#pragma unroll
        for (int it = 0; it < kRedStep * CPR_X / kThreads; ++it) {
          const int c = tid + it * kThreads, r = c / CPR_X, kc = c % CPR_X;
          const bool ok = (m0 + r < m_end) && (k0 + kc * 8 < K);
          cp_async16(Xs + swz<CPR_X>(r, kc),
                     x + (size_t)(m0 + r) * K + k0 + kc * 8, ok, x);
        }
        // vec: gs (kDwBN), gss (kDwBN), then a (BKO), b (BKO)
        if (tid < NVEC) {
          const int f = tid * 4;
          const float* src;
          int at, lim;
          if (f < 2 * kDwBN) {
            src = f < kDwBN ? gs : gss;
            at = n0 + f % kDwBN;
            lim = N;
          } else {
            const int fk = f - 2 * kDwBN;
            src = fk < BKO ? a : b;
            at = k0 + fk % BKO;
            lim = K;
          }
          if (NORMALIZE || f < 2 * kDwBN)
            cp_async16(vec + f, src + at, at < lim, gs);
        }
      }
    }
    cp_async_commit();
  };

  const int at_base = at_frag_base<CPR_G>(wm * kWarpRows / 8, lane);
  const int bt_base = bt_frag_base<CPR_X>(wn * WTN / 8, lane);
  float acc[kMI][NJ][4];
#pragma unroll
  for (int p = 0; p < kDwStages - 1; ++p) load_stage(p);

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    load_stage(step + kDwStages - 1);
    const int ms = step % msteps;
    if (ms == 0) zero(acc);
    const int item = item_of(step), tile = item % tiles, split = item / tiles;
    const int m_end = min(M, (split + 1) * rows_per_split);
    const int m0 = split * rows_per_split + ms * kRedStep;
    if (m0 < m_end) {
      const bf16* Gys =
          reinterpret_cast<const bf16*>(smem + step % kDwStages * S::STAGE);
      const bf16* Ys = Gys + S::G;
      const bf16* Xs = Ys + S::G;
      const float* vec = reinterpret_cast<const float*>(Xs + S::X);
      const bool partial = m0 + kRedStep > m_end;
      // unrolled by 2, not 4: fully unrolled, its hoisted loads spill
#pragma unroll 2
      for (int kk = 0; kk < kRedStep / 16; ++kk) {
        // A = g^T first: rows n (gs, gss per row), columns m
        const int mr = m0 + kk * 16 + 2 * t;  // m of regs 0, 1; +8 of 2, 3
        uint32_t af[kMI][4];
#pragma unroll
        for (int i = 0; i < kMI; ++i) {
          const int nlo = wm * kWarpRows + 16 * i + g, nhi = nlo + 8;
          const float slo = vec[nlo], shi = vec[nhi];
          const float qlo = 2.0f * vec[kDwBN + nlo];  // 2*gss: see fold2
          const float qhi = 2.0f * vec[kDwBN + nhi];
          const int off = (at_base ^ (i << 4)) + kk * 16 * kDwBN;
          uint32_t yf[4];
          ldsm_x4_trans(af[i], Gys + off);
          ldsm_x4_trans(yf, Ys + off);
          af[i][0] = fold2(af[i][0], yf[0], slo, slo, qlo, qlo);
          af[i][1] = fold2(af[i][1], yf[1], shi, shi, qhi, qhi);
          af[i][2] = fold2(af[i][2], yf[2], slo, slo, qlo, qlo);
          af[i][3] = fold2(af[i][3], yf[3], shi, shi, qhi, qhi);
          if (partial) {  // rows past the split's end: g = 0, not gs
            af[i][0] = keep2(af[i][0], mr < m_end, mr + 1 < m_end);
            af[i][1] = keep2(af[i][1], mr < m_end, mr + 1 < m_end);
            af[i][2] = keep2(af[i][2], mr + 8 < m_end, mr + 9 < m_end);
            af[i][3] = keep2(af[i][3], mr + 8 < m_end, mr + 9 < m_end);
          }
        }
        // then B = act, [m][k] read with .trans, a pair of 8-column blocks
        // at a time; the prologue's a, b belong to the fragment's column
        // k = g of each block
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          uint32_t r[4];
          ldsm_x4_trans(r, Xs + (bt_base ^ (jj << 4)) + kk * 16 * BKO);
          if constexpr (NORMALIZE) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = wn * WTN + 16 * jj + 8 * h + g;
              const float ak = vec[2 * kDwBN + k];
              const float bk = vec[2 * kDwBN + BKO + k];
              r[2 * h] = prologue2<RELU>(r[2 * h], ak, ak, bk, bk);
              r[2 * h + 1] = prologue2<RELU>(r[2 * h + 1], ak, ak, bk, bk);
            }
          }
#pragma unroll
          for (int i = 0; i < kMI; ++i) {
            mma_bf16(acc[i][2 * jj], af[i], r[0], r[1]);
            mma_bf16(acc[i][2 * jj + 1], af[i], r[2], r[3]);
          }
        }
      }
    }
    if (ms != msteps - 1) continue;

    // Epilogue of the item: its float32 partial, straight from registers
    const int n0 = tile / tiles_k * kDwBN, k0 = tile % tiles_k * BKO;
    float* out = dwt_part + (size_t)split * N * K;
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wm * kWarpRows + 16 * i + 8 * h + g;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int k = k0 + wn * WTN + 8 * j + 2 * t;
          if (n < N && k < K)
            *reinterpret_cast<float2*>(out + (size_t)n * K + k) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
  }
  cp_async_wait<0>();
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

template <int BKO, bool NORMALIZE, bool RELU>
int launch_dx_bf16(const BwdArgs& p) {
  auto kernel = bwd_dx_kernel<BKO, NORMALIZE, RELU>;
  constexpr int bytes = DxSmem<BKO>::BYTES;
  static bool smem_set[kMaxDevices] = {};
  const int err = allow_dynamic_smem(kernel, bytes, smem_set);
  if (err != 0) return err;
  kernel<<<p.dx_grid, kThreads, bytes, p.stream>>>(
      static_cast<const bf16*>(p.gy), static_cast<const bf16*>(p.y),
      static_cast<const bf16*>(p.x), static_cast<const bf16*>(p.wt), p.gs,
      p.gss, p.a, p.b, p.inv, p.minv, static_cast<bf16*>(p.dx), p.pdgamma,
      p.pdbeta, p.M, p.K, p.N);
  return static_cast<int>(cudaGetLastError());
}

template <int BKO, bool NORMALIZE, bool RELU>
int launch_dw_bf16(const BwdArgs& p) {
  auto kernel = bwd_dw_kernel<BKO, NORMALIZE, RELU>;
  constexpr int bytes = DwSmem<BKO>::BYTES;
  static bool smem_set[kMaxDevices] = {};
  const int err = allow_dynamic_smem(kernel, bytes, smem_set);
  if (err != 0) return err;
  kernel<<<p.dw_grid, kThreads, bytes, p.stream>>>(
      static_cast<const bf16*>(p.gy), static_cast<const bf16*>(p.y),
      static_cast<const bf16*>(p.x), p.gs, p.gss, p.a, p.b, p.dwt_part, p.M,
      p.K, p.N, p.splits, p.rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <bool NORMALIZE, bool RELU>
int launch_bf16(const BwdArgs& p) {
  int err = p.dx_tile == 128 ? launch_dx_bf16<128, NORMALIZE, RELU>(p)
                             : launch_dx_bf16<64, NORMALIZE, RELU>(p);
  if (err != 0) return err;
  return p.dw_tile == 128 ? launch_dw_bf16<128, NORMALIZE, RELU>(p)
                          : launch_dw_bf16<64, NORMALIZE, RELU>(p);
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

bool is_tile(int t) { return t == 64 || t == 128; }

}  // namespace

// dtype: 0 = bf16, 1 = float32. gs, gss: (N,) float32; a, b, inv, minv: (K,)
// float32, read only with normalize. pdgamma, pdbeta: (K, ceil(M/128))
// float32, written only with normalize. dwt_part: (splits, N, K) float32 with
// splits * rows_per_split >= M > (splits - 1) * rows_per_split and
// rows_per_split a multiple of 64. bf16 only: dx_tile and dw_tile (64 or
// 128) are the K-width of the dx and dW^T tiles, dx_grid and dw_grid the
// number of persistent blocks of each kernel. Starts both kernels on
// `stream`; returns the first non-zero CUDA error, 0 if both launched, -1
// for an argument it does not take.
extern "C" int matmul_stats_bwd_launch(
    const void* gy, const void* y, const void* x, const void* wt,
    const void* gs, const void* gss, const void* a, const void* b,
    const void* inv, const void* minv, void* dx, void* pdgamma, void* pdbeta,
    void* dwt_part, int M, int K, int N, int splits, int rows_per_split,
    int dtype, int normalize, int relu, int dx_tile, int dx_grid, int dw_tile,
    int dw_grid, void* stream) {
  if (splits < 1 || rows_per_split % kRedStep != 0 ||
      (long long)splits * rows_per_split < M ||
      (long long)(splits - 1) * rows_per_split >= M)
    return -1;
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
      return -1;
    return by_mode<Bf16>(p, normalize, relu);
  }
  if (dtype == 1) return by_mode<F32>(p, normalize, relu);
  return -1;
}
