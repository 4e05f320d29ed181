// Fused tiny-MLP backwards for Hopper (sm_90a), bound with ctypes: the
// Instant-NGP density net (one hidden layer) and colour net (two).
//
// Replaces the TPU kernels of xrnerf_tpu/ops/pallas/fused_mlp.py:
//   xr_fused_mlp2_bwd  <-  _bwd2_kernel (:77), launched by _fused2_bwd
//                          (pallas_call at :149), the VJP of fused_mlp2
//   xr_fused_mlp3_bwd  <-  _bwd3_kernel (:202), launched by _fused3_bwd
//                          (pallas_call at :284), the VJP of fused_mlp3
//
// What they compute, for x [n, din], the upstream gradient g [n, dout] and
// the forward's weights (all f32 in global memory, weights [in, out]):
//   pre_i recomputed as in the forward (bf16 x, weights and hidden
//   activations, f32 accumulation, f32 bias);
//   dh_last = bf16(g) @ w_last^T;   dpre_i = dh_i where pre_i > 0, else 0;
//   dh_{i-1} = bf16(dpre_i) @ w_i^T;   dx = bf16(dpre_1) @ w_1^T;
//   dw_i = bf16(input of layer i)^T @ bf16(dpre_i)   (dw_last with bf16(g));
//   db_i = column sums of the f32 dpre_i             (db_last of the f32 g).
// Every product accumulates in f32 and every output is f32. These are the
// TPU bodies' rounding points.
//
// What bounds them: bytes. A row moves 320 B (32 in, 16 out: x, g and dx)
// for about 16 kFLOP, or 260 B (31 in, 3 out) for about 37 kFLOP, under the
// H100's ~295 FLOP/B ridge, so nothing but x, g and dx touches device
// memory per row. Inside the tile the work is latency: a short chain of
// small products per 16 rows. The design overlaps what it can:
//   - a persistent grid (one CTA per SM, 128-row tiles walked grid-stride)
//     with a producer warpgroup (registers 40 a thread with setmaxnreg, so
//     the consumers get 232; wgmma kernels are allocated by warpgroup) whose
//     first warp, for each tile, brings x (128 x din f32) and g
//     (128 x dout f32) with cp.async.bulk into a two-stage ring, completing
//     on an mbarrier, so tile t + 1 is in flight while tile t is worked on.
//     A ragged last tile is copied by that warp's lanes, padded
//     with zero rows. The consumers round to bf16 and pad 31 -> 32 from the
//     landed tile; each consumer warp releases the stage with one arrive;
//   - two consumer warpgroups, each owning 64 rows of the tile and walking
//     on its own (only warpgroup barriers, none across the CTA). The forward
//     recompute and the data-gradient chain are wgmma products m64 x N64
//     (N32 for dx) with A in registers and the weights as B in shared memory
//     (staged once per CTA, bf16, K-major [N][64] tiles in the 128-byte
//     swizzle, one per product and direction); they run register to
//     register: the accumulator fragment, after bias, ReLU (the mask kept as
//     32 bits a thread) or the mask, is the next product's A fragment. On
//     the way each warp writes those fragments of x, h_i, dpre_i and g into
//     feature-major tiles [feature][64 rows], in the swizzle wgmma reads,
//     with stmatrix .trans (one instruction per 16 rows x 16 features). x and
//     g reach the fragments through a padded warp-private bf16 block, read
//     from the landed tile one row per turn, so no read conflicts on banks;
//   - the weight gradients dw_i = act^T @ dpre reduce over rows, which are
//     contiguous in those tiles, so both wgmma operands are K-major shared
//     tiles: per tile and warpgroup one chain of m64 products over K = 64
//     rows (dw2 = h1^T @ dpre2 at N 64; dw1^T = dpre1^T @ x at N 32; dw_last
//     = h_last^T @ g at N 8 or 16). The accumulators (56 registers a
//     thread) stay in registers over the whole walk, and the products run
//     asynchronously under the next tile's first steps;
//   - dx is staged as f32 rows in shared memory (two buffers a warpgroup)
//     and written with one bulk store per 64 rows: coalesced, and the
//     store's read of the buffer overlaps the next tile;
//   - one f32 partial per CTA (the two warpgroups' sums added in a fixed
//     order), and a second kernel adds the CTAs' partials in CTA order: the
//     same bits on every launch, no atomics.
// Widths are zero-padded inside the kernel (din to 32, hidden to 64, dout to
// 8 or 16); rows past n are zero x and zero g, and with g = 0 every dpre of
// such a row is 0, so it adds nothing to any sum. x, g and dx must be
// 16-byte aligned (the wrapper checks): a full tile of x or g, and 64 rows
// of dx, are then whole multiples of 16 bytes at 16-byte aligned addresses.

#include "tiny_mlp_sm90.cuh"

namespace {
namespace tinyb {

using namespace tinyw;  // widths, thread layout, product, load_a, sm_count

constexpr int GP = 16;      // padded width of g (dout <= 16): one mma k-step
constexpr int STAGES = 2;
// row stride of the warp-private bf16 block of g (+8 as for x)
constexpr int LDO = GP + 8;
constexpr int FT = WG_ROWS * 2;  // bytes of one feature row of a tile (64 rows bf16)

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// Byte offsets of the shared-memory regions (base 1024-aligned).
template <int NHID>
struct Smem {
  // weight tiles B [N][K], K-major: forward (N = out, K = in) and data
  // gradients (N = in, K = out)
  static constexpr int W1F = 0;                                       // [64][64] w1^T
  static constexpr int W2F = W1F + WTILE;                             // [64][64] w2^T
  static constexpr int WOD = W2F + (NHID == 2 ? WTILE : 0);           // [64][64] w_last
  static constexpr int W2D = WOD + WTILE;                             // [64][64] w2
  static constexpr int W1D = W2D + (NHID == 2 ? WTILE : 0);           // [32][64] w1
  static constexpr int B1 = W1D + KIN * 128;                          // f32 b1
  static constexpr int B2 = B1 + HID * 4;                             // f32 b2
  static constexpr int BARS = B2 + HID * 4;                           // full[2], empty[2]
  static constexpr int X_BYTES = ROWS * KIN * 4;                      // a stage's x (row stride din)
  static constexpr int STAGE = X_BYTES + ROWS * GP * 4;               // + g (row stride dout)
  static constexpr int RING = align1k(BARS + 4 * 8);
  // feature-major tiles of one warpgroup, [feature][64 rows] bf16, swizzled
  static constexpr int XT = 0;                                        // [32]
  static constexpr int GT = XT + KIN * FT;                            // [16]
  static constexpr int H1T = GT + GP * FT;                            // [64]
  static constexpr int D1T = H1T + HID * FT;
  static constexpr int H2T = D1T + HID * FT;
  static constexpr int D2T = H2T + (NHID == 2 ? HID * FT : 0);
  static constexpr int WG_TILES = D2T + (NHID == 2 ? HID * FT : 0);
  static constexpr int TILES = RING + STAGES * STAGE;
  static constexpr int DX_BUF = WG_ROWS * KIN * 4;                    // f32 [64][din]
  static constexpr int DXS = TILES + 2 * WG_TILES;                    // [wg][2 buffers]
  static constexpr int XW = DXS + 2 * 2 * DX_BUF;                     // [8 warps][16][LDI] bf16
  static constexpr int GW = XW + 8 * 16 * LDI * 2;                    // [8 warps][16][LDO] bf16
  static constexpr int BYTES = GW + 8 * 16 * LDO * 2 + 1024;          // + alignment slack
};

// A weight tile dst [NP][64] (bf16, K-major, 128-byte swizzle): element
// (n, k) = w[k][n] (TRANS) or w[n][k] of a f32 row-major w with row length
// ld, zero for n >= nv or k >= kv.
template <int NP, bool TRANS>
__device__ __forceinline__ void stage_w(const float* __restrict__ w, int nv, int kv, int ld,
                                        unsigned char* dst) {
  for (int i = threadIdx.x; i < NP * 64; i += THREADS) {
    const int nn = i / 64, k = i % 64;
    const float val = nn < nv && k < kv ? __ldg(w + (TRANS ? (size_t)k * ld + nn : (size_t)nn * ld + k)) : 0.f;
    *reinterpret_cast<bf16*>(dst + swz(nn, k)) = __float2bfloat16_rn(val);
  }
}

__device__ __forceinline__ void stage_bias(const float* __restrict__ b, int nout, float* dst) {
  for (int i = threadIdx.x; i < HID; i += THREADS) dst[i] = i < nout ? __ldg(b + i) : 0.f;
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ void stmatrix_x2_trans(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(addr), "r"(r0),
               "r"(r1)
               : "memory");
}

// The warp's bf16 A fragments (KS k16 steps: rows rw .. rw + 15, features
// 16 ks .. 16 ks + 15) into the feature-major tile at shared address T,
// features < NF: stmatrix .trans writes each 8 x 8 block of a fragment
// column by column, each column (one feature, 8 rows) one 16-byte chunk of
// the swizzled tile. Lanes 8 q .. 8 q + 7 address the rows of block q.
template <int KS, int NF>
__device__ __forceinline__ void store_frags_t(uint32_t T, const uint32_t (&a)[KS][4], int rw, int lane) {
  const int q = lane >> 3, j = lane & 7;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if constexpr (NF >= 16) {
      stmatrix_x4_trans(T + swz(16 * ks + 8 * (q >> 1) + j, rw + 8 * (q & 1)), a[ks]);
    } else {  // 8 features: the blocks of the first n-tile only
      stmatrix_x2_trans(T + swz(16 * ks + j, rw + 8 * (q & 1)), a[ks][0], a[ks][1]);
    }
  }
}

// h = relu(acc + bias): bit nt*4+j of `mask` says pre > 0; bf16(h) goes into
// A fragments (n-tiles 2ks and 2ks+1 of the accumulator are one k-step),
// the next layer's operand, and from there to the tile T.
__device__ __forceinline__ void relu_mask(const float (&acc)[HID / 2], const float* bias,
                                          uint32_t& mask, uint32_t (&a)[HID / 16][4], uint32_t T,
                                          int rw, int lane) {
  const int tg = lane & 3;
  mask = 0;
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt) {
    const float b0 = bias[nt * 8 + tg * 2], b1 = bias[nt * 8 + tg * 2 + 1];
    float v[4] = {acc[4 * nt] + b0, acc[4 * nt + 1] + b1, acc[4 * nt + 2] + b0, acc[4 * nt + 3] + b1};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (v[j] > 0.f) mask |= 1u << (nt * 4 + j);
      v[j] = fmaxf(v[j], 0.f);
    }
    a[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(v[0], v[1]);  // row g
    a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(v[2], v[3]);  // row g + 8
  }
  store_frags_t<HID / 16, HID>(T, a, rw, lane);
}

// dpre = dh where the mask bit is set, else 0: its f32 values add to the
// bias-gradient sums, bf16(dpre) goes into A fragments and the tile T.
__device__ __forceinline__ void mask_pack(const float (&acc)[HID / 2], uint32_t mask,
                                          float (&dbacc)[HID / 8][2], uint32_t (&a)[HID / 16][4],
                                          uint32_t T, int rw, int lane) {
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (mask >> (nt * 4 + j)) & 1u ? acc[4 * nt + j] : 0.f;
    dbacc[nt][0] += v[0] + v[2];
    dbacc[nt][1] += v[1] + v[3];
    a[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(v[0], v[1]);
    a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
  }
  store_frags_t<HID / 16, HID>(T, a, rw, lane);
}

// The warp's 16 rows of an f32 [rows][d] block in shared memory (row stride
// d), lane l reading column l % C of each row it visits (so the reads are
// contiguous), rounded to bf16 into the warp-private row-major block w
// (stride LD, columns >= d zero). Returns the sum of the f32 values the lane
// read. Every load is issued before the first store: both blocks are in
// shared memory, so the compiler may not move a load past a store itself,
// and interleaved they cost a load latency per row.
template <int C, int LD>
__device__ __forceinline__ float stage_rows(const float* blk, int d, bf16* w, int lane) {
  constexpr int TURNS = 16 * C / 32;
  float v[TURNS];
#pragma unroll
  for (int j = 0; j < TURNS; ++j) {
    const int i = lane + 32 * j, r = i / C, c = i % C;
    v[j] = c < d ? blk[r * d + c] : 0.f;
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < TURNS; ++j) {
    const int i = lane + 32 * j, r = i / C, c = i % C;
    sum += v[j];
    w[r * LD + c] = __float2bfloat16_rn(v[j]);
  }
  return sum;
}

// Per-thread column sums (rows g and g + 8 of every tile this warp saw) to
// the warp's row of `red` [8][HID]: summed over the 8 row groups by
// shuffles, written by the lanes of row group 0.
__device__ __forceinline__ void reduce_bias(const float (&dbacc)[HID / 8][2], float* red, int warp,
                                            int lane) {
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = dbacc[nt][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[warp * HID + nt * 8 + lane * 2 + e] = v;
    }
}

// Where each gradient sits in a partial (and in the final buffer), in f32
// elements: dw1 [din, h1], db1 [h1], (dw2 [h1, h2], db2 [h2],) dw_last
// [h_last, dout], db_last [dout].
struct Layout {
  int dw1, db1, dw2, db2, dwo, dbo, size;
};

template <int NHID>
__host__ __device__ inline Layout layout(int din, int h1, int h2, int dout) {
  Layout L;
  L.dw1 = 0;
  L.db1 = din * h1;
  L.dw2 = L.db1 + h1;
  L.db2 = L.dw2 + (NHID == 2 ? h1 * h2 : 0);
  L.dwo = L.db2 + (NHID == 2 ? h2 : 0);
  L.dbo = L.dwo + (NHID == 2 ? h2 : h1) * dout;
  L.size = L.dbo + dout;
  return L;
}

// Element (m, n) of register i of a wgmma m64nN accumulator, for thread t of
// a warpgroup: m = 16 (t / 32) + (t % 32) / 4 + 8 ((i % 4) / 2), n = 8 (i / 4)
// + 2 (t % 4) + i % 2. Stores the sum of two warpgroups' accumulators
// (a + b) at p[m * sm + n * sn] for m < rows, n < cols.
template <int N>
__device__ __forceinline__ void store_acc(const float (&a)[N], const float* b, float* p, int rows,
                                          int cols, int sm, int sn, int t) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int m = 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i & 3) >> 1);
    const int n = 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
    if (m < rows && n < cols) p[m * sm + n * sn] = a[i] + b[i * 128 + t];
  }
}

template <int N>
__device__ __forceinline__ void save_acc(const float (&a)[N], float* s, int t) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i * 128 + t] = a[i];
}

template <int NOUT>
__device__ __forceinline__ void wgmma_out(float (&d)[NOUT / 2], uint64_t da, uint64_t db) {
  if constexpr (NOUT == 16)
    wgmma_ss_n16<0, 0>(d, da, db, 1);
  else
    wgmma_ss_n8<0, 0>(d, da, db, 1);
}

// NHID hidden layers (1 or 2), g padded to NOUT (8 or 16) columns for the
// last layer's weight gradient.
template <int NHID, int NOUT>
__global__ void __launch_bounds__(THREADS, 1)
    tiny_mlp_bwd_kernel(const float* __restrict__ x, int din, long long n,
                        const float* __restrict__ w1, const float* __restrict__ b1, int h1,
                        const float* __restrict__ w2, const float* __restrict__ b2, int h2,
                        const float* __restrict__ wo, int dout, const float* __restrict__ gout,
                        float* __restrict__ dx, float* __restrict__ part) {
  using S = Smem<NHID>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw_u32 + 1023) & ~1023u) - raw_u32);
  const uint32_t base = smem_u32(sm);
  float* b1s = reinterpret_cast<float*>(sm + S::B1);
  float* b2s = reinterpret_cast<float*>(sm + S::B2);
  const uint32_t full = base + S::BARS, empty = full + 2 * 8;
  const int hl = NHID == 2 ? h2 : h1;  // width that feeds the last layer
  const long long ntiles = (n + ROWS - 1) / ROWS;

  stage_w<HID, true>(w1, h1, din, h1, sm + S::W1F);    // (out, in) = w1[in][out]
  stage_w<KIN, false>(w1, din, h1, h1, sm + S::W1D);   // (in, out) = w1[in][out]
  stage_bias(b1, h1, b1s);
  if constexpr (NHID == 2) {
    stage_w<HID, true>(w2, h2, h1, h2, sm + S::W2F);
    stage_w<HID, false>(w2, h1, h2, h2, sm + S::W2D);
    stage_bias(b2, h2, b2s);
  }
  stage_w<HID, false>(wo, hl, dout, dout, sm + S::WOD);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= CONSUMERS / 32) {
    // the producer warpgroup gives its registers to the consumers; its first
    // warp brings x and g of each tile into the ring
    setmaxnreg_dec<40>();
    if (warp != CONSUMERS / 32) return;
    const uint64_t stream = l2_stream();
    for (long long tile = blockIdx.x, k = 0; tile < ntiles; tile += gridDim.x, ++k) {
      const int s = (int)(k & 1);
      const uint32_t fb = full + 8 * s;
      float* xs = reinterpret_cast<float*>(sm + S::RING + s * S::STAGE);
      float* gs = reinterpret_cast<float*>(sm + S::RING + s * S::STAGE + S::X_BYTES);
      mbar_wait(empty + 8 * s, (uint32_t)((k >> 1) & 1) ^ 1u);
      const long long r0 = tile * ROWS;
      const int rows = (int)(n - r0 < ROWS ? n - r0 : ROWS);
      if (rows == ROWS) {
        if (lane == 0) {
          const uint32_t xb = ROWS * din * 4, gb = ROWS * dout * 4;
          mbar_expect_tx(fb, xb + gb);
          bulk_load(smem_u32(xs), x + r0 * din, xb, fb, stream);
          bulk_load(smem_u32(gs), gout + r0 * dout, gb, fb, stream);
        }
      } else {  // the ragged last tile, padded with zero rows
        for (int i = lane; i < ROWS * din; i += 32) xs[i] = i < rows * din ? __ldg(x + r0 * din + i) : 0.f;
        for (int i = lane; i < ROWS * dout; i += 32)
          gs[i] = i < rows * dout ? __ldg(gout + r0 * dout + i) : 0.f;
        __syncwarp();
        if (lane == 0) mbar_arrive(fb);
      }
      __syncwarp();
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of every tile
  setmaxnreg_inc<232>();
  const int wg = warp >> 2, t = threadIdx.x & 127;
  const int rw = (warp & 3) * 16;  // this warp's first row inside the warpgroup's 64
  const uint32_t tb = base + S::TILES + wg * S::WG_TILES;
  const uint64_t dxt = desc_kmajor(tb + S::XT), dgt = desc_kmajor(tb + S::GT);
  const uint64_t dh1 = desc_kmajor(tb + S::H1T), dd1 = desc_kmajor(tb + S::D1T);
  const uint64_t dd2 = desc_kmajor(tb + S::D2T), dhl = desc_kmajor(tb + (NHID == 2 ? S::H2T : S::H1T));
  const uint64_t normal = l2_normal();
  const uint64_t w1f = desc_kmajor(base + S::W1F), w2f = desc_kmajor(base + S::W2F);
  const uint64_t wod = desc_kmajor(base + S::WOD), w2d = desc_kmajor(base + S::W2D);
  const uint64_t w1d = desc_kmajor(base + S::W1D);

  // this thread's share of the sums, kept over the whole tile walk: the
  // weight gradients as wgmma accumulators, the bias gradients per column
  float dw2acc[NHID == 2 ? 32 : 1], dw1acc[16], dwoacc[NOUT / 2];
  float db1acc[HID / 8][2], db2acc[HID / 8][2], dbo = 0.f;  // dbo: column lane % 16 of g
  zero_acc(dw2acc);
  zero_acc(dw1acc);
  zero_acc(dwoacc);
#pragma unroll
  for (int i = 0; i < HID / 8; ++i) db1acc[i][0] = db1acc[i][1] = db2acc[i][0] = db2acc[i][1] = 0.f;

  for (long long tile = blockIdx.x, k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    const int s = (int)(k & 1);
    const float* xs = reinterpret_cast<const float*>(sm + S::RING + s * S::STAGE) + (wg * WG_ROWS + rw) * din;
    const float* gs =
        reinterpret_cast<const float*>(sm + S::RING + s * S::STAGE + S::X_BYTES) + (wg * WG_ROWS + rw) * dout;
    mbar_wait(full + 8 * s, (uint32_t)((k >> 1) & 1));
    bf16* xw = reinterpret_cast<bf16*>(sm + S::XW) + warp * 16 * LDI;
    bf16* gw = reinterpret_cast<bf16*>(sm + S::GW) + warp * 16 * LDO;
    stage_rows<KIN, LDI>(xs, din, xw, lane);
    dbo += stage_rows<GP, LDO>(gs, dout, gw, lane);  // the last bias sums the f32 g
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    uint32_t ax[KIN / 16][4], ag[1][4];
    load_a<KIN / 16, LDI>(ax, xw, lane);
    load_a<1, LDO>(ag, gw, lane);
    // the previous tile's weight-gradient products have read the tiles
    wgmma_wait<0>();
    pin(dw2acc);
    pin(dw1acc);
    pin(dwoacc);
    store_frags_t<KIN / 16, KIN>(tb + S::XT, ax, rw, lane);
    store_frags_t<1, NOUT>(tb + S::GT, ag, rw, lane);

    // forward recompute: the ReLU masks, and bf16 h into the tiles
    float acc[HID / 2];
    uint32_t ah[HID / 16][4];
    uint32_t m1, m2 = 0;
    product(acc, ax, w1f);
    relu_mask(acc, b1s, m1, ah, tb + S::H1T, rw, lane);
    if constexpr (NHID == 2) {
      product(acc, ah, w2f);
      relu_mask(acc, b2s, m2, ah, tb + S::H2T, rw, lane);
    }

    // data gradients: dh_last = bf16(g) @ w_last^T, then down the chain
    product(acc, ag, wod);
    if constexpr (NHID == 2) {
      mask_pack(acc, m2, db2acc, ah, tb + S::D2T, rw, lane);
      product(acc, ah, w2d);
    }
    mask_pack(acc, m1, db1acc, ah, tb + S::D1T, rw, lane);
    float o[KIN / 2];
    product(o, ah, w1d);

    // dx rows into this warpgroup's staging buffer (f32 [64][din], as in
    // global memory). For an even din, float2 stores, n-tile (k + g) % 4 in
    // turn k: with 32 columns the 16 lanes of a half-warp hit 32 distinct
    // banks (in n-tile order, the 8 rows of a quad would share four).
    float* dxs = reinterpret_cast<float*>(sm + S::DXS + (wg * 2 + s) * S::DX_BUF);
    {
      const int g = lane >> 2, tg = lane & 3;
      if (din % 2 == 0) {
#pragma unroll
        for (int k = 0; k < KIN / 8; ++k) {
          const int nt = (k + g) & 3, c = nt * 8 + tg * 2;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half;
            const float2 v = nt == 0   ? make_float2(o[e], o[e + 1])
                             : nt == 1 ? make_float2(o[4 + e], o[5 + e])
                             : nt == 2 ? make_float2(o[8 + e], o[9 + e])
                                       : make_float2(o[12 + e], o[13 + e]);
            if (c < din) *reinterpret_cast<float2*>(dxs + (rw + g + 8 * half) * din + c) = v;
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < KIN / 8; ++nt) {
          const int c = nt * 8 + tg * 2;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* row = dxs + (rw + g + 8 * half) * din;
            if (c < din) row[c] = o[4 * nt + 2 * half];
            if (c + 1 < din) row[c + 1] = o[4 * nt + 2 * half + 1];
          }
        }
      }
    }
    fence_async_shared();  // the tiles and the dx rows, for wgmma and the bulk store
    if (t == 0) bulk_store_wait_read();  // the store of two tiles ago has read this buffer
    wg_sync(wg);

    const long long r0 = tile * ROWS + wg * WG_ROWS;
    if (r0 + WG_ROWS <= n) {
      if (t == 0) bulk_store(dx + r0 * din, smem_u32(dxs), WG_ROWS * din * 4, normal);
    } else if (r0 < n) {
      const int valid = (int)(n - r0) * din;
      for (int i = t; i < valid; i += 128) dx[r0 * din + i] = dxs[i];
    }

    // weight gradients over the warpgroup's 64 rows, K-major both: 4 k-steps
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_ROWS / 16; ++kk) {
      const uint64_t step = kk * KSTEP_KMAJOR;
      if constexpr (NHID == 2) wgmma_ss_n64<0, 0>(dw2acc, dh1 + step, dd2 + step, 1);
      wgmma_ss_n32<0, 0>(dw1acc, dd1 + step, dxt + step, 1);
      wgmma_out<NOUT>(dwoacc, dhl + step, dgt + step);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  pin(dw2acc);
  pin(dw1acc);
  pin(dwoacc);
  if (t == 0) bulk_store_wait_all();

  // this CTA's partial: warpgroup 1 leaves its sums in shared memory (the
  // tiles are free once every product has retired), warpgroup 0 adds them
  // to its own, in that order
  consumer_sync();
  float* scr = reinterpret_cast<float*>(sm + S::TILES);
  float* s_dw2 = scr;
  float* s_dw1 = s_dw2 + (NHID == 2 ? 32 : 0) * 128;
  float* s_dwo = s_dw1 + 16 * 128;
  float* red1 = s_dwo + (NOUT / 2) * 128;
  float* red2 = red1 + 8 * HID;
  float* redo = red2 + 8 * HID;
  if (wg == 1) {
    if constexpr (NHID == 2) save_acc(dw2acc, s_dw2, t);
    save_acc(dw1acc, s_dw1, t);
    save_acc(dwoacc, s_dwo, t);
  }
  reduce_bias(db1acc, red1, warp, lane);
  if constexpr (NHID == 2) reduce_bias(db2acc, red2, warp, lane);
  dbo += __shfl_xor_sync(0xffffffffu, dbo, 16);
  if (lane < GP) redo[warp * GP + lane] = dbo;
  consumer_sync();

  const Layout L = layout<NHID>(din, h1, h2, dout);
  float* p = part + (size_t)blockIdx.x * L.size;
  if (wg == 0) {
    if constexpr (NHID == 2) store_acc(dw2acc, s_dw2, p + L.dw2, h1, h2, h2, 1, t);  // [h1][h2]
    store_acc(dw1acc, s_dw1, p + L.dw1, h1, din, 1, h1, t);  // dw1^T: (m = h1, n = din)
    store_acc(dwoacc, s_dwo, p + L.dwo, hl, dout, dout, 1, t);
  }
  for (int j = threadIdx.x; j < HID; j += CONSUMERS) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMERS / 32; ++w) {
      s1 += red1[w * HID + j];
      if (NHID == 2) s2 += red2[w * HID + j];
    }
    if (j < h1) p[L.db1 + j] = s1;
    if (NHID == 2 && j < h2) p[L.db2 + j] = s2;
  }
  if (threadIdx.x < dout) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMERS / 32; ++w) s += redo[w * GP + threadIdx.x];
    p[L.dbo + threadIdx.x] = s;
  }
}

// out[e] = sum over the CTAs' partials, in CTA order.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int nparts, int size,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.f;
  for (int c = 0; c < nparts; ++c) s += part[(size_t)c * size + e];
  out[e] = s;
}

template <int NHID, int NOUT>
cudaError_t launch_kernel(unsigned blocks, cudaStream_t stream, const float* x, int din,
                          long long n, const float* w1, const float* b1, int h1, const float* w2,
                          const float* b2, int h2, const float* wo, int dout, const float* g,
                          float* dx, float* part) {
  auto kernel = tiny_mlp_bwd_kernel<NHID, NOUT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<NHID>::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, Smem<NHID>::BYTES, stream>>>(x, din, n, w1, b1, h1, w2, b2, h2, wo,
                                                         dout, g, dx, part);
  return cudaGetLastError();
}

template <int NHID>
cudaError_t launch(const float* x, int din, long long n, const float* w1, const float* b1, int h1,
                   const float* w2, const float* b2, int h2, const float* wo, int dout,
                   const float* g, float* dx, float* grads, float* part, int max_parts,
                   cudaStream_t stream) {
  if (din < 1 || din > KIN || h1 < 1 || h1 > HID || h2 < 1 || h2 > HID || dout < 1 ||
      dout > GP || n < 1)
    return cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx) % 16 != 0) return cudaErrorMisalignedAddress;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + ROWS - 1) / ROWS;
  long long cap = sms < max_parts ? sms : max_parts;
  if (cap < 1) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(ntiles < cap ? ntiles : cap);
  err = dout <= 8 ? launch_kernel<NHID, 8>(blocks, stream, x, din, n, w1, b1, h1, w2, b2, h2, wo,
                                           dout, g, dx, part)
                  : launch_kernel<NHID, 16>(blocks, stream, x, din, n, w1, b1, h1, w2, b2, h2, wo,
                                            dout, g, dx, part);
  if (err != cudaSuccess) return err;
  const int size = layout<NHID>(din, h1, h2, dout).size;
  reduce_partials_kernel<<<(size + 255) / 256, 256, 0, stream>>>(part, (int)blocks, size, grads);
  return cudaGetLastError();
}

}  // namespace tinyb
}  // namespace

extern "C" {

const char* xr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Widest shapes the kernels take: din, hidden, dout.
int xr_fused_mlp_bwd_max_din() { return tinyb::KIN; }
int xr_fused_mlp_bwd_max_hidden() { return tinyb::HID; }
int xr_fused_mlp_bwd_max_dout() { return tinyb::GP; }

// The most partials a launch writes (CTAs in its grid: one per SM) on the
// current device, or -1: the caller allocates `part` [max_parts, grads
// elements].
int xr_fused_mlp_bwd_max_parts() {
  int sms = 0;
  return tinyb::sm_count(&sms) == cudaSuccess ? sms : -1;
}

// Dynamic shared memory of one CTA (bytes), density net and colour net.
int xr_fused_mlp2_bwd_smem_bytes() { return tinyb::Smem<1>::BYTES; }
int xr_fused_mlp3_bwd_smem_bytes() { return tinyb::Smem<2>::BYTES; }

// Backward of out = relu(x @ w1 + b1) @ w2 + b2 for the upstream gradient g
// [n, dout]: dx [n, din], and `grads` = dw1 [din, h] | db1 [h] | dw2
// [h, dout] | db2 [dout], all f32 row-major. n >= 1; x, g and dx 16-byte
// aligned. `part` is scratch for max_parts partials of `grads`' size.
// Launches on `stream`, does not synchronise; returns the cudaError_t of the
// launches (0 on success).
int xr_fused_mlp2_bwd(const float* x, int din, long long n, const float* w1, const float* b1,
                      int h, const float* w2, int dout, const float* g, float* dx, float* grads,
                      float* part, int max_parts, void* stream) {
  return (int)tinyb::launch<1>(x, din, n, w1, b1, h, nullptr, nullptr, h, w2, dout, g, dx, grads,
                               part, max_parts, (cudaStream_t)stream);
}

// Backward of out = relu(relu(x @ w1 + b1) @ w2 + b2) @ w3 + b3: dx, and
// `grads` = dw1 [din, h1] | db1 [h1] | dw2 [h1, h2] | db2 [h2] | dw3
// [h2, dout] | db3 [dout].
int xr_fused_mlp3_bwd(const float* x, int din, long long n, const float* w1, const float* b1,
                      int h1, const float* w2, const float* b2, int h2, const float* w3, int dout,
                      const float* g, float* dx, float* grads, float* part, int max_parts,
                      void* stream) {
  return (int)tinyb::launch<2>(x, din, n, w1, b1, h1, w2, b2, h2, w3, dout, g, dx, grads, part,
                               max_parts, (cudaStream_t)stream);
}

}  // extern "C"
