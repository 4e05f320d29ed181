// Fused vanilla-NeRF MLP backward for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel xrnerf_tpu/ops/pallas/fused_nerf_mlp.py:
// _bwd_kernel (:159), launched by _fused_core_bwd (pallas_call at :351),
// the custom VJP of fused_nerf_mlp (:382).
//
// What it computes, for the pack of fused_nerf_mlp_common.cuh and the
// upstream gradient g [n, 4] (rgb in columns 0..2, sigma in 3): the forward
// is recomputed (bf16 h0..h7, feat, v1; ReLU masks from h > 0), then
//   dv1 = bf16(g_rgb) @ Wrgb            dpre_v = mask_v ? dv1 : 0
//   dfeat = bf16(dpre_v) @ Wvf           dv = bf16(dpre_v) @ Wvv
//   dh7 = bf16(dfeat) @ Wf + bf16(g_sigma) * Wa[0]
//   dpre_i = mask_i ? dh_i : 0,  dh_{i-1} = bf16(dpre_i) @ W_i  (i = 7..1,
//   the skip layer 5 also gives dx = bf16(dpre5) @ W5x), dx += bf16(dpre0) @ W0
// and every weight gradient dW = bf16(dpre)^T @ h_in (f32 accumulate) and
// bias gradient db = sum over rows of the f32 dpre (dfeat + g_sigma for the
// feature/alpha head, g_rgb for the rgb head). These are _bwd_kernel's
// rounding points.
//
// What bounds it: operations, three times the forward's 593,408 MACs per
// row (remat, data gradients, weight gradients): 3.56 MFLOP per row against
// ~740 bytes of row input/output. Above that floor sits the scratch below:
// the weight gradients need every layer's input and dpre for all rows,
// 9.7 KB per row, which no SM holds, and a row tile's own share of all the
// dW blocks (2.4 MB of f32) would cost more than it saves. So the scratch
// stays, written once and read by pass (b), a floor of bytes of its own.
//
// Design, three launches on one stream:
//  (a) fused_nerf_mlp_bwd_rows: the forward kernel's engine (persistent
//      CTAs, two consumer warpgroups of 64 rows, a producer thread streaming
//      the weight image through a ring of 32 KB slabs). The recompute is the
//      forward; the data-gradient chain dh = bf16(dpre) @ W is the same
//      engine with the same image read MN-major (the instruction's transpose
//      bit: K = out, N = in), so there is no second weight copy. dpre of one
//      layer, masked and rounded in the accumulator registers, is the next
//      product's register A operand. ReLU masks are taken from the values a
//      thread holds at the recompute's epilogue (128 bits a layer) and parked
//      in a per-CTA slice of device memory that stays in the L2; the chain's
//      epilogue has the same thread owning the same elements. Bias gradients
//      are f32 sums of a thread's own dpre, combined across the warp by
//      halving exchanges (warp_col_sums) and added into that warp's own slice
//      of `sums`; the two 8-row heads' weight gradients (dWa, dWrgb) are
//      summed the same way with f32 FMAs. Each layer's bf16 input and bf16 dpre go from the
//      registers into a swizzled staging tile in shared memory and out with
//      one bulk store, in the layout pass (b) reads: per 64-row slab, panels
//      of [64 rows][64 features], rows of 128 bytes, 128-byte swizzle.
//      These stores carry an L2 evict-first policy and the weight loads
//      evict-last: without them the scratch stream (9.7 KB per row) pushes
//      the 1.2 MB of weights, which every tile reads twice, out of the L2.
//  (b) fused_nerf_mlp_bwd_wgrad: dW[o][i] = sum_r D[r][o] * H[r][i] as a
//      tiled wgmma GEMM whose K is the row count. A CTA owns 128 (o) x 256
//      (i) of one weight block (two warpgroups x m64n256, 128 accumulator
//      registers a thread) and one split of the rows; a producer thread
//      brings 64-row slabs of H and D into a four-slot ring by bulk copies;
//      both operands are read MN-major straight from the scratch's layout.
//      Each split writes its own f32 partial.
//  (c) fused_nerf_mlp_bwd_finish: sums the weight partials over the splits
//      and the bias / head partials over the warps in a fixed order.
// The TPU kernel sums weight gradients across row tiles with read-modify-
// write, race-free there only because its grid runs in sequence. Here every
// reduction goes only into addresses that one lane owns: `sums` holds a
// slice per CTA and per warp, zeroed by the caller; within a slice,
// warp_col_sums gives each pair of floats to one lane, which adds to them
// with red.global.add (no value comes back, so nothing waits on the L2) tile
// after tile in program order, and lane 0 adds the heads' four bias sums.
// The grid is fixed by the caller, weight partials are one per split, and
// pass (c) sums both in a fixed order: so no two threads ever add to one
// address, and the result is the same bits run to run.

#include "fused_nerf_mlp_common.cuh"

namespace {

constexpr int STAGES = 3;
constexpr int N_MASKS = 8;  // h0..h7 (v1's is used where it is made)
constexpr int GW = 4;       // g columns: rgb 0..2, sigma 3

// Scratch: per 64-row slab, panels of 8 KB.
constexpr int SPX = 0;               // x (1 panel)
constexpr int SPV = 1;               // v, padded to 64 (1)
constexpr int SPH = 2;               // h0..h7 (8 x 4)
constexpr int SPFEAT = SPH + 32;     // feat (4)
constexpr int SPDP = SPFEAT + 4;     // dpre0..dpre7 (8 x 4)
constexpr int SPDFEAT = SPDP + 32;   // bf16 dfeat (4)
constexpr int SPDPV = SPDFEAT + 4;   // bf16 dpre_v (2)
constexpr int SPANELS = SPDPV + 2;   // 76
constexpr size_t SLAB_SCRATCH = (size_t)SPANELS * BLOCK_BYTES;

// Per-warp f32 sums: the bias gradients, then dWa [256], then dWrgb [3][128].
constexpr int SUM_WA = OBEND;
constexpr int SUM_WRGB = SUM_WA + WIDTH;
constexpr int SUMS = SUM_WRGB + 3 * HV;

constexpr uint32_t SM_RING = 0;
constexpr uint32_t SM_XT = SM_RING + STAGES * SLAB_BYTES;
constexpr uint32_t SM_VT = SM_XT + CONSUMER_WGS * BLOCK_BYTES;
constexpr uint32_t SM_STG = SM_VT + CONSUMER_WGS * BLOCK_BYTES;  // [2][4 panels]
constexpr uint32_t SM_BIAS = SM_STG + CONSUMER_WGS * SLAB_BYTES;
constexpr uint32_t SM_G = SM_BIAS + ((OBEND * 4 + 15) / 16) * 16;  // [2][64][GW] f32
constexpr uint32_t SM_BARS = SM_G + CONSUMER_WGS * WG_ROWS * GW * 4;
constexpr uint32_t SM_END = SM_BARS + 2 * STAGES * 8;
constexpr size_t SMEM_ROWS = SM_END + 1024;

#define SLABS4_K(base) slab_k(base), slab_k(base + SLAB_BYTES), slab_k(base + 2 * SLAB_BYTES), slab_k(base + 3 * SLAB_BYTES)
#define SLABS4_MN(base) slab_mn(base, 0, 4), slab_mn(base, 1, 4), slab_mn(base, 2, 4), slab_mn(base, 3, 4)
constexpr uint32_t IW2 = IW1 + 4 * SLAB_BYTES, IW3 = IW2 + 4 * SLAB_BYTES, IW4 = IW3 + 4 * SLAB_BYTES;

// The slabs of one tile, in the order the consumers read them.
__constant__ Slab BWD_SEQ[] = {
    // recompute (K-major)
    slab_k(IW0), SLABS4_K(IW1), SLABS4_K(IW2), SLABS4_K(IW3), SLABS4_K(IW4), SLABS4_K(IW5H),
    slab_k(IW5X), SLABS4_K(IW6), SLABS4_K(IW7), SLABS4_K(IWF), slab_k(IWVF), slab_k(IWVF + SLAB_BYTES),
    slab_k(IWVV, 2 * BLOCK_BYTES),
    // data gradients (MN-major)
    slab_mn(IWVF, 0, 2), slab_mn(IWVF, 1, 2), slab_k(IWVV, 2 * BLOCK_BYTES), SLABS4_MN(IWF),
    SLABS4_MN(IW7), SLABS4_MN(IW6), slab_k(IW5X), SLABS4_MN(IW5H), SLABS4_MN(IW4), SLABS4_MN(IW3),
    SLABS4_MN(IW2), SLABS4_MN(IW1), slab_k(IW0),
};

// Column sums over a warp's 16 rows, added into the warp's own slice `p` of
// NJ n-tiles. s[2 j + e] is this thread's sum over its rows g and g + 8 of
// column 8 j + 2 tg + e. Three exchanges, one per bit of g, each with the
// lane that differs in that bit: a lane keeps the half of its values that
// the bit selects, hands over the other half and adds what it receives. So
// the values a lane holds halve each time (7 N / 8 shuffles for N values, not
// 3 N), and lane (g, tg) ends with the warp's sums of n-tiles g NJ / 8 ..
// (g + 1) NJ / 8 - 1. The order of the additions is fixed.
template <int NJ>
__device__ __forceinline__ void warp_col_sums(const float (&s)[2 * NJ], float* p, int g, int tg) {
  constexpr int N = 2 * NJ;
  float a[N / 2], b[N / 4], c[N / 8];
  const bool h2 = g & 4, h1 = g & 2, h0 = g & 1;
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    a[i] = (h2 ? s[N / 2 + i] : s[i]) + __shfl_xor_sync(0xffffffffu, h2 ? s[i] : s[N / 2 + i], 16);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    b[i] = (h1 ? a[N / 4 + i] : a[i]) + __shfl_xor_sync(0xffffffffu, h1 ? a[i] : a[N / 4 + i], 8);
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
    c[i] = (h0 ? b[N / 8 + i] : b[i]) + __shfl_xor_sync(0xffffffffu, h0 ? b[i] : b[N / 8 + i], 4);
#pragma unroll
  for (int i = 0; i < N / 8; i += 2) {
    // only this lane of this warp ever adds to these two floats (see the note
    // at the top), so the order of the additions is the program's
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(p + 8 * (g * (NJ / 8) + i / 2) + 2 * tg),
                 "f"(c[i]), "f"(c[i + 1])
                 : "memory");
  }
}

// Where this thread's bf16 pair of n-tile j goes in the staging tile: panel
// j / 8, row r (and r + 8: + 1024 bytes), chunk (j % 8) ^ (r % 8).
__device__ __forceinline__ uint32_t stg_off(int j, uint32_t rb, int xr) {
  return (uint32_t)(j >> 3) * BLOCK_BYTES + rb + ((uint32_t)((j & 7) ^ xr) << 4);
}

// The staging tile is free again (its last bulk store has read it).
__device__ __forceinline__ void stage_begin(int wg, int t) {
  if (t == 0) bulk_store_wait_read();
  wg_sync(wg);
}
// The tile is written: send it to `dst`.
__device__ __forceinline__ void stage_end(int wg, int t, void* dst, uint32_t src, uint32_t bytes) {
  fence_async_shared();
  wg_sync(wg);
  if (t == 0) bulk_store(dst, src, bytes, l2_stream());
}

// Recompute epilogue: bias, optional ReLU, bf16 -> the next A operand, the
// staging tile and (RELU) the mask bits of this thread's 128 elements.
template <bool RELU>
__device__ __forceinline__ uint4 epi_fwd(const float (&acc)[128], const float* bias,
                                         uint32_t (&a)[16][4], unsigned char* stg, uint32_t rb,
                                         int xr, int tg) {
  uint32_t m[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * tg);
    float v0 = acc[4 * j + 0] + b.x, v1 = acc[4 * j + 1] + b.y;
    float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
    if (RELU) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
      v2 = fmaxf(v2, 0.f);
      v3 = fmaxf(v3, 0.f);
    }
    const uint32_t p0 = pack_bf16(v0, v1), p1 = pack_bf16(v2, v3);
    a[j >> 1][(j & 1) * 2 + 0] = p0;
    a[j >> 1][(j & 1) * 2 + 1] = p1;
    if (RELU) {  // after the ReLU, the bf16 value is > 0 iff its magnitude bits are set
      const uint32_t bits = ((p0 & 0x7FFFu) ? 1u : 0u) | ((p0 & 0x7FFF0000u) ? 2u : 0u) |
                            ((p1 & 0x7FFFu) ? 4u : 0u) | ((p1 & 0x7FFF0000u) ? 8u : 0u);
      m[j >> 3] |= bits << ((j & 7) * 4);
    }
    const uint32_t o = stg_off(j, rb, xr);
    *reinterpret_cast<uint32_t*>(stg + o) = p0;
    *reinterpret_cast<uint32_t*>(stg + o + 1024) = p1;
  }
  return make_uint4(m[0], m[1], m[2], m[3]);
}

// Chain epilogue: dpre = mask ? acc (+ bf16(g_sigma) * Wa[0][col]) : 0 in
// f32; its column sums go to `sums`, its bf16 to the next A operand and the
// staging tile.
template <bool MASKED, bool ALPHA>
__device__ __forceinline__ void epi_bwd(const float (&acc)[128], uint4 mask, uint32_t (&a)[16][4],
                                        unsigned char* stg, uint32_t rb, int xr, int tg, int g,
                                        float* sums, float gs0 = 0.f, float gs1 = 0.f,
                                        const bf16* __restrict__ wa = nullptr) {
  const uint32_t m[4] = {mask.x, mask.y, mask.z, mask.w};
  float cs[64];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float v0 = acc[4 * j + 0], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
    if (ALPHA) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(wa + 8 * j + 2 * tg));
      v0 = fmaf(gs0, bf16_lo(w), v0);
      v1 = fmaf(gs0, bf16_hi(w), v1);
      v2 = fmaf(gs1, bf16_lo(w), v2);
      v3 = fmaf(gs1, bf16_hi(w), v3);
    }
    if (MASKED) {
      const uint32_t bits = m[j >> 3] >> ((j & 7) * 4);
      v0 = (bits & 1u) ? v0 : 0.f;
      v1 = (bits & 2u) ? v1 : 0.f;
      v2 = (bits & 4u) ? v2 : 0.f;
      v3 = (bits & 8u) ? v3 : 0.f;
    }
    cs[2 * j] = v0 + v2;
    cs[2 * j + 1] = v1 + v3;
    const uint32_t p0 = pack_bf16(v0, v1), p1 = pack_bf16(v2, v3);
    a[j >> 1][(j & 1) * 2 + 0] = p0;
    a[j >> 1][(j & 1) * 2 + 1] = p1;
    const uint32_t o = stg_off(j, rb, xr);
    *reinterpret_cast<uint32_t*>(stg + o) = p0;
    *reinterpret_cast<uint32_t*>(stg + o + 1024) = p1;
  }
  warp_col_sums<32>(cs, sums, g, tg);
}

// out[row][col] (+)= acc for rows < n, cols < ncols of a 64-wide product.
template <bool ADD>
__device__ __forceinline__ void store_rows(const float (&acc)[32], float* __restrict__ out,
                                           int ncols, long long n, long long row, int tg) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = row + 8 * (e >> 1);
      const int col = 8 * j + 2 * tg + (e & 1);
      if (r < n && col < ncols) {
        float* p = out + r * ncols + col;
        *p = ADD ? *p + acc[4 * j + e] : acc[4 * j + e];
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_nerf_mlp_bwd_rows(const float* __restrict__ x, int dx, const float* __restrict__ v,
                            int dv, const float* __restrict__ gin, long long n,
                            const unsigned char* __restrict__ image, const bf16* __restrict__ Wp,
                            const float* __restrict__ Bp, float* __restrict__ dxo,
                            float* __restrict__ dvo, unsigned char* __restrict__ S,
                            uint4* __restrict__ masks, float* __restrict__ sums_all) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  float* bias = reinterpret_cast<float*>(sm + SM_BIAS);

  const long long my_tiles = cta_tiles(n);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(base + SM_BARS + 8 * s, 1);
      mbar_init(base + SM_BARS + 8 * (STAGES + s), CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < OBEND; i += THREADS) bias[i] = Bp[i];
  for (int i = threadIdx.x; i < 2 * CONSUMER_WGS * (int)BLOCK_BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(sm + SM_XT)[i] = make_uint4(0, 0, 0, 0);  // pad columns stay zero
  fence_async_shared();
  __syncthreads();

  Ring<STAGES> ring;
  ring.full = base + SM_BARS;
  ring.empty = base + SM_BARS + 8 * STAGES;
  ring.data = base + SM_RING;

  const int wg = threadIdx.x >> 7;
  if (wg == CONSUMER_WGS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) produce(ring, BWD_SEQ, image, my_tiles);
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5;
    const int g = lane >> 2, tg = lane & 3;
    const int r = warp * 16 + g;  // this thread's rows in the warpgroup: r, r + 8
    const uint32_t rb = (uint32_t)r * 128 + tg * 4;
    const int xr = r & 7;
    unsigned char* xt = sm + SM_XT + wg * BLOCK_BYTES;
    unsigned char* vt = sm + SM_VT + wg * BLOCK_BYTES;
    unsigned char* stg = sm + SM_STG + wg * SLAB_BYTES;
    const uint32_t xt_a = base + SM_XT + wg * BLOCK_BYTES, vt_a = base + SM_VT + wg * BLOCK_BYTES;
    const uint32_t stg_a = base + SM_STG + wg * SLAB_BYTES;
    const uint64_t xdesc = desc_kmajor(xt_a), vdesc = desc_kmajor(vt_a);
    float* gs = reinterpret_cast<float*>(sm + SM_G) + wg * WG_ROWS * GW;
    uint4* mk = masks + (size_t)blockIdx.x * N_MASKS * CONSUMERS + threadIdx.x;
    float* sums = sums_all + ((size_t)blockIdx.x * CONSUMER_WARPS + (threadIdx.x >> 5)) * SUMS;
    uint32_t prev = 0;

    for (long long i = 0; i < my_tiles; ++i) {
      const long long tile = blockIdx.x + i * gridDim.x;
      const long long row0 = tile * TILE + wg * WG_ROWS;
      unsigned char* Ss = S + (size_t)(tile * CONSUMER_WGS + wg) * SLAB_SCRATCH;
      auto panel = [&](int p) { return Ss + (size_t)p * BLOCK_BYTES; };

      stage_begin(wg, t);  // the last tile's stores have read xt, vt and the staging tile
      stage_tile(x, dx, n, row0, xt, t);
      stage_tile(v, dv, n, row0, vt, t);
      for (int i = t; i < WG_ROWS * GW; i += 128)
        gs[i] = (row0 + i / GW < n) ? __ldg(gin + row0 * GW + i) : 0.f;
      fence_async_shared();
      wg_sync(wg);
      if (t == 0) {
        bulk_store(panel(SPX), xt_a, BLOCK_BYTES, l2_stream());
        bulk_store(panel(SPV), vt_a, BLOCK_BYTES, l2_stream());
      }
      // bias gradients of the two heads: sums of the f32 g over this warp's rows
      {
        float s[GW];
#pragma unroll
        for (int c = 0; c < GW; ++c) s[c] = lane < 16 ? gs[(warp * 16 + lane) * GW + c] : 0.f;
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
#pragma unroll
          for (int c = 0; c < GW; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
        if (lane == 0) {
          sums[OBRGB + 0] += s[0];
          sums[OBRGB + 1] += s[1];
          sums[OBRGB + 2] += s[2];
          sums[OBA] += s[3];
        }
      }

      float acc[128];
      uint32_t a[16][4];
      uint4 m;

      // ---- recompute the forward; each layer: its mask and its scratch copy ----
      consume_begin(ring);
      mma_ss256(acc, xdesc, ring.addr(), true);
      consume_end(ring, prev, lane);
      drain(prev, lane);
      pin(acc);
      stage_begin(wg, t);
      m = epi_fwd<true>(acc, bias, a, stg, rb, xr, tg);  // h0
      stage_end(wg, t, panel(SPH), stg_a, SLAB_BYTES);
      mk[0] = m;

#pragma unroll 1
      for (int l = 1; l <= 7; ++l) {
        layer_rs<0>(acc, a, ring, prev, lane, true);
        if (l == 5) {  // + x @ W5x
          consume_begin(ring);
          mma_ss256(acc, xdesc, ring.addr(), false);
          consume_end(ring, prev, lane);
        }
        drain(prev, lane);
        pin(acc);
        stage_begin(wg, t);
        m = epi_fwd<true>(acc, bias + l * WIDTH, a, stg, rb, xr, tg);
        stage_end(wg, t, panel(SPH + 4 * l), stg_a, SLAB_BYTES);
        mk[l * CONSUMERS] = m;
      }

      // dWa[i] += sum_r bf16(g_sigma[r]) * h7[r][i] (the alpha head's weight gradient)
      const float gsig0 = bf16r(gs[r * GW + 3]), gsig1 = bf16r(gs[(r + 8) * GW + 3]);
      {
        float cs[64];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const uint32_t p0 = a[j >> 1][(j & 1) * 2 + 0], p1 = a[j >> 1][(j & 1) * 2 + 1];
          cs[2 * j] = fmaf(gsig0, bf16_lo(p0), gsig1 * bf16_lo(p1));
          cs[2 * j + 1] = fmaf(gsig0, bf16_hi(p0), gsig1 * bf16_hi(p1));
        }
        warp_col_sums<32>(cs, sums + SUM_WA, g, tg);
      }

      // feat = bf16(h7 @ Wf + bf)
      layer_rs<0>(acc, a, ring, prev, lane, true);
      drain(prev, lane);
      pin(acc);
      stage_begin(wg, t);
      epi_fwd<false>(acc, bias + OBF, a, stg, rb, xr, tg);
      stage_end(wg, t, panel(SPFEAT), stg_a, SLAB_BYTES);

      // v1 = relu(feat @ Wvf + v @ Wvv + bv); its mask; dWrgb from it; dpre_v
      uint32_t av[8][4];
      {
        float vacc[64];
        pin(a);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          consume_begin(ring);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            wgmma_rs_n128<0>(vacc, a[s * 8 + k],
                             desc_kmajor(ring.addr() + (k >> 2) * 2 * BLOCK_BYTES) + (k & 3) * KSTEP_KMAJOR,
                             (s | k) != 0);
          consume_end(ring, prev, lane);
        }
        consume_begin(ring);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss_n128<0, 0>(vacc, vdesc + k * KSTEP_KMAJOR, desc_kmajor(ring.addr()) + k * KSTEP_KMAJOR, 1);
        consume_end(ring, prev, lane);
        drain(prev, lane);
        pin(vacc);

        float gb0[3], gb1[3];
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          gb0[o] = bf16r(gs[r * GW + o]);
          gb1[o] = bf16r(gs[(r + 8) * GW + o]);
        }
        float cw[3][32], cb[32];
        stage_begin(wg, t);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * tg;
          const float2 b = *reinterpret_cast<const float2*>(bias + OBV + col);
          const uint32_t p0 = pack_bf16(fmaxf(vacc[4 * j + 0] + b.x, 0.f), fmaxf(vacc[4 * j + 1] + b.y, 0.f));
          const uint32_t p1 = pack_bf16(fmaxf(vacc[4 * j + 2] + b.x, 0.f), fmaxf(vacc[4 * j + 3] + b.y, 0.f));
          // dWrgb[o][col] += sum_r bf16(g_rgb[r][o]) * v1[r][col]
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            cw[o][2 * j] = fmaf(gb0[o], bf16_lo(p0), gb1[o] * bf16_lo(p1));
            cw[o][2 * j + 1] = fmaf(gb0[o], bf16_hi(p0), gb1[o] * bf16_hi(p1));
          }
          // dpre_v = (v1 > 0) ? bf16(g_rgb) @ Wrgb : 0
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(Wp + OWRGB + o * HV + col));
            d0 = fmaf(gb0[o], bf16_lo(w), d0);
            d1 = fmaf(gb0[o], bf16_hi(w), d1);
            d2 = fmaf(gb1[o], bf16_lo(w), d2);
            d3 = fmaf(gb1[o], bf16_hi(w), d3);
          }
          d0 = (p0 & 0x7FFFu) ? d0 : 0.f;
          d1 = (p0 & 0x7FFF0000u) ? d1 : 0.f;
          d2 = (p1 & 0x7FFFu) ? d2 : 0.f;
          d3 = (p1 & 0x7FFF0000u) ? d3 : 0.f;
          cb[2 * j] = d0 + d2;
          cb[2 * j + 1] = d1 + d3;
          const uint32_t q0 = pack_bf16(d0, d1), q1 = pack_bf16(d2, d3);
          av[j >> 1][(j & 1) * 2 + 0] = q0;
          av[j >> 1][(j & 1) * 2 + 1] = q1;
          const uint32_t o = stg_off(j, rb, xr);
          *reinterpret_cast<uint32_t*>(stg + o) = q0;
          *reinterpret_cast<uint32_t*>(stg + o + 1024) = q1;
        }
        stage_end(wg, t, panel(SPDPV), stg_a, 2 * BLOCK_BYTES);
#pragma unroll
        for (int o = 0; o < 3; ++o) warp_col_sums<16>(cw[o], sums + SUM_WRGB + o * HV, g, tg);
        warp_col_sums<16>(cb, sums + OBV, g, tg);
      }

      // ---- data-gradient chain ----
      // dfeat = bf16(dpre_v) @ Wvf; dv = bf16(dpre_v) @ Wvv
      {
        float dvacc[32];
        pin(av);
        consume_begin(ring);
        mma_rs256<1, 0>(acc, av, ring.addr(), true);
        consume_end(ring, prev, lane);
        consume_begin(ring);
        mma_rs256<1, 4>(acc, av, ring.addr(), false);
        consume_end(ring, prev, lane);
        consume_begin(ring);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          wgmma_rs_n64<1>(dvacc, av[k], desc_mnmajor(ring.addr(), BLOCK_BYTES) + k * KSTEP_MNMAJOR, k > 0);
        consume_end(ring, prev, lane);
        drain(prev, lane);
        pin(dvacc);
        store_rows<false>(dvacc, dvo, dv, n, row0 + r, tg);
      }
      pin(acc);
      stage_begin(wg, t);
      epi_bwd<false, false>(acc, m, a, stg, rb, xr, tg, g, sums + OBF);  // sums: bf's gradient
      stage_end(wg, t, panel(SPDFEAT), stg_a, SLAB_BYTES);

      // dpre7 from dh7 = bf16(dfeat) @ Wf + bf16(g_sigma) * Wa[0]
      layer_rs<1>(acc, a, ring, prev, lane, true);
      drain(prev, lane);
      pin(acc);
      m = mk[7 * CONSUMERS];
      stage_begin(wg, t);
      epi_bwd<true, true>(acc, m, a, stg, rb, xr, tg, g, sums + 7 * WIDTH, gsig0, gsig1, Wp + OWA);
      stage_end(wg, t, panel(SPDP + 4 * 7), stg_a, SLAB_BYTES);

#pragma unroll 1
      for (int l = 6; l >= 0; --l) {  // dpre_l from dh_l = bf16(dpre_{l+1}) @ W_{l+1}
        if (l == 4) {  // dx = bf16(dpre5) @ W5x (the skip input's part)
          float dxacc[32];
          pin(a);
          consume_begin(ring);
#pragma unroll
          for (int k = 0; k < 16; ++k)
            wgmma_rs_n64<1>(dxacc, a[k], desc_mnmajor(ring.addr(), BLOCK_BYTES) + k * KSTEP_MNMAJOR, k > 0);
          consume_end(ring, prev, lane);
          drain(prev, lane);
          pin(dxacc);
          store_rows<false>(dxacc, dxo, dx, n, row0 + r, tg);
        }
        layer_rs<1>(acc, a, ring, prev, lane, true);
        drain(prev, lane);
        pin(acc);
        m = mk[l * CONSUMERS];
        stage_begin(wg, t);
        epi_bwd<true, false>(acc, m, a, stg, rb, xr, tg, g, sums + l * WIDTH);
        stage_end(wg, t, panel(SPDP + 4 * l), stg_a, SLAB_BYTES);
      }
      {  // dx += bf16(dpre0) @ W0 (same thread, same elements as above)
        float dxacc[32];
        pin(a);
        consume_begin(ring);
#pragma unroll
        for (int k = 0; k < 16; ++k)
          wgmma_rs_n64<1>(dxacc, a[k], desc_mnmajor(ring.addr(), BLOCK_BYTES) + k * KSTEP_MNMAJOR, k > 0);
        consume_end(ring, prev, lane);
        drain(prev, lane);
        pin(dxacc);
        store_rows<true>(dxacc, dxo, dx, n, row0 + r, tg);
      }
    }
    if (t == 0) bulk_store_wait_all();  // the scratch is complete before the kernel ends
  }
}

// ----------------------------------------------------------- pass (b)

// One CTA's share of the weight gradients: 128 output rows (two warpgroups
// of 64) of one weight block. H: `h_panels` panels from `h_panel` of the
// scratch; D: two panels from `d_panel`; dW at pack offset `w_off`, rows of
// `ld` valid columns.
struct WTile {
  uint32_t h_panel, h_panels, d_panel, w_off, ld;
};
constexpr WTile wtile(int h, int hp, int d, size_t w, int ld, int half) {
  return {(uint32_t)h, (uint32_t)hp, (uint32_t)(d + 2 * half), (uint32_t)(w + (size_t)half * 128 * ld),
          (uint32_t)ld};
}
#define WTILE2(h, hp, d, w, ld) wtile(h, hp, d, w, ld, 0), wtile(h, hp, d, w, ld, 1)
__constant__ WTile WTILES[] = {
    WTILE2(SPH + 0, 4, SPDP + 4, OW1, WIDTH),   WTILE2(SPH + 4, 4, SPDP + 8, OW2, WIDTH),
    WTILE2(SPH + 8, 4, SPDP + 12, OW3, WIDTH),  WTILE2(SPH + 12, 4, SPDP + 16, OW4, WIDTH),
    WTILE2(SPH + 16, 4, SPDP + 20, OW5H, WIDTH), WTILE2(SPH + 20, 4, SPDP + 24, OW6, WIDTH),
    WTILE2(SPH + 24, 4, SPDP + 28, OW7, WIDTH),  WTILE2(SPH + 28, 4, SPDFEAT, OWF, WIDTH),
    wtile(SPFEAT, 4, SPDPV, OWVF, WIDTH, 0),
    WTILE2(SPX, 1, SPDP + 0, OW0, PX),           WTILE2(SPX, 1, SPDP + 20, OW5X, PX),
    wtile(SPV, 1, SPDPV, OWVV, PV, 0),
};
constexpr int N_WTILES = sizeof(WTILES) / sizeof(WTile);  // 22
constexpr int WG_STAGES = 4;
constexpr uint32_t WG_STAGE_BYTES = SLAB_BYTES + 2 * BLOCK_BYTES;  // H slab + D half-slab
constexpr uint32_t SMW_BARS = WG_STAGES * WG_STAGE_BYTES;
constexpr size_t SMEM_WGRAD = SMW_BARS + 2 * WG_STAGES * 8 + 1024;

template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&acc)[N / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss_mn<256>(float (&acc)[128], uint64_t da, uint64_t db) {
  wgmma_ss_n256<1, 1>(acc, da, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_ss_mn<64>(float (&acc)[32], uint64_t da, uint64_t db) {
  wgmma_ss_n64<1, 1>(acc, da, db, 1);
}

// The consumer side of one wgrad CTA for an N-wide H (256 or 64).
template <int N>
__device__ __forceinline__ void wgrad_consume(uint32_t base, long long count, const WTile& T,
                                              float* __restrict__ out, int wg, int lane, int warp) {
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  pin(acc);
  int slot = 0;
  uint32_t phase = 0, prev = 0;
  for (long long s = 0; s < count; ++s) {
    const uint32_t stage = base + slot * WG_STAGE_BYTES;
    mbar_wait(base + SMW_BARS + 8 * slot, phase);
    wgmma_fence();
    const uint64_t da = desc_mnmajor(stage + SLAB_BYTES + wg * BLOCK_BYTES, BLOCK_BYTES);
    const uint64_t db = desc_mnmajor(stage, BLOCK_BYTES);
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_ss_mn<N>(acc, da + k * KSTEP_MNMAJOR, db + k * KSTEP_MNMAJOR);
    wgmma_commit();
    if (prev) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(prev);
    }
    prev = base + SMW_BARS + 8 * (WG_STAGES + slot);
    if (++slot == WG_STAGES) {
      slot = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  pin(acc);
  const int g = lane >> 2, tg = lane & 3;
  const int o = wg * WG_ROWS + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * tg;
    if (col < (int)T.ld) {
      *reinterpret_cast<float2*>(out + (size_t)o * T.ld + col) = make_float2(acc[4 * j + 0], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (size_t)(o + 8) * T.ld + col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// Grid (22 tiles, splits of the rows).
__global__ void __launch_bounds__(THREADS, 1)
    fused_nerf_mlp_bwd_wgrad(const unsigned char* __restrict__ S, long long slabs,
                             long long chunk_slabs, float* __restrict__ wpart) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const WTile T = WTILES[blockIdx.x];
  const long long s0 = (long long)blockIdx.y * chunk_slabs;
  const long long s1 = s0 + chunk_slabs < slabs ? s0 + chunk_slabs : slabs;
  const long long count = s1 > s0 ? s1 - s0 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(base + SMW_BARS + 8 * s, 1);
      mbar_init(base + SMW_BARS + 8 * (WG_STAGES + s), CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == CONSUMER_WGS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      const uint32_t hbytes = T.h_panels * BLOCK_BYTES;
      const uint64_t once = l2_normal();  // the other half of the block's rows reads H too
      int slot = 0;
      uint32_t phase = 1;
      for (long long s = s0; s < s1; ++s) {
        const unsigned char* src = S + (size_t)s * SLAB_SCRATCH;
        const uint32_t full = base + SMW_BARS + 8 * slot, stage = base + slot * WG_STAGE_BYTES;
        mbar_wait(base + SMW_BARS + 8 * (WG_STAGES + slot), phase);
        mbar_expect_tx(full, hbytes + 2 * BLOCK_BYTES);
        bulk_load(stage, src + (size_t)T.h_panel * BLOCK_BYTES, hbytes, full, once);
        bulk_load(stage + SLAB_BYTES, src + (size_t)T.d_panel * BLOCK_BYTES, 2 * BLOCK_BYTES, full, once);
        if (++slot == WG_STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    float* out = wpart + (size_t)blockIdx.y * OWEND + T.w_off;
    if (T.h_panels == 4)
      wgrad_consume<256>(base, count, T, out, wg, lane, warp);
    else
      wgrad_consume<64>(base, count, T, out, wg, lane, warp);
  }
}

// ----------------------------------------------------------- pass (c)

// dw[e] and db[e]: sums over the partials in a fixed order: eight groups
// (p = rg, rg + 8, ...) summed in turn, then combined 0..7. Weight blocks
// come from wpart [splits][OWEND]; the biases and the two heads' first rows
// from sums [warps][SUMS]; the heads' padding rows are zero.
constexpr int RED_GROUPS = 8;
__global__ void __launch_bounds__(32 * RED_GROUPS)
    fused_nerf_mlp_bwd_finish(const float* __restrict__ wpart, int splits,
                              const float* __restrict__ sums, int warps, float* __restrict__ dw,
                              float* __restrict__ db) {
  __shared__ float red[RED_GROUPS][32];
  const int c = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const long long e = (long long)blockIdx.x * 32 + c;
  const float* src = nullptr;
  long long parts = 0, stride = 0;
  if (e < (long long)OWEND) {
    if (e >= (long long)OWA && e < (long long)OWVF) {
      if (e < (long long)OWA + WIDTH) src = sums + SUM_WA + (e - OWA), parts = warps, stride = SUMS;
    } else if (e >= (long long)OWRGB) {
      if (e < (long long)OWRGB + 3 * HV) src = sums + SUM_WRGB + (e - OWRGB), parts = warps, stride = SUMS;
    } else {
      src = wpart + e, parts = splits, stride = (long long)OWEND;
    }
  } else if (e < (long long)OWEND + OBEND) {
    src = sums + (e - OWEND), parts = warps, stride = SUMS;
  }
  float s = 0.f;
  for (long long p = rg; p < parts; p += RED_GROUPS) s += src[p * stride];
  red[rg][c] = s;
  __syncthreads();
  if (rg == 0 && e < (long long)OWEND + OBEND) {
    float tot = red[0][c];
#pragma unroll
    for (int j = 1; j < RED_GROUPS; ++j) tot += red[j][c];
    if (e < (long long)OWEND)
      dw[e] = tot;
    else
      db[e - OWEND] = tot;
  }
}

cudaError_t raise_smem_limits() {
  cudaError_t err = cudaFuncSetAttribute(fused_nerf_mlp_bwd_rows,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_ROWS);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fused_nerf_mlp_bwd_wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_WGRAD);
}

}  // namespace

extern "C" {

long long xr_fused_nerf_mlp_bwd_weight_elems() { return (long long)OWEND; }
long long xr_fused_nerf_mlp_bwd_bias_elems() { return (long long)OBEND; }
long long xr_fused_nerf_mlp_bwd_image_elems() { return (long long)(IWEND / 2); }
// Scratch the caller allocates: bytes per 64-row slab of `s`, bytes of
// `masks` and floats of `sums` per CTA of the row pass.
long long xr_fused_nerf_mlp_bwd_scratch_bytes_per_slab() { return (long long)SLAB_SCRATCH; }
long long xr_fused_nerf_mlp_bwd_mask_bytes_per_cta() { return (long long)N_MASKS * CONSUMERS * 16; }
long long xr_fused_nerf_mlp_bwd_sum_floats_per_cta() { return (long long)CONSUMER_WARPS * SUMS; }
// The card's SM count (0 if the card cannot be asked), and dynamic shared
// memory of a CTA of passes (a) and (b).
long long xr_fused_nerf_mlp_bwd_sm_count() {
  int sms = 0;
  return sm_count(&sms) == cudaSuccess ? sms : 0;
}
long long xr_fused_nerf_mlp_bwd_rows_smem_bytes() { return (long long)SMEM_ROWS; }
long long xr_fused_nerf_mlp_bwd_wgrad_smem_bytes() { return (long long)SMEM_WGRAD; }

const char* xr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [n, dx] f32 (dx <= 64), v [n, dv] f32 (dv <= 32), g [n, 4] f32, image:
// the weight image, w / b: the pack. Writes dx [n, dx], dv [n, dv], dw
// [weight elems] and db [bias elems], all f32. Scratch from the caller: s
// (slabs of npad / 64, npad = n rounded up to 128), masks and sums (per CTA
// of `grid`; sums zeroed), wpart (f32, splits * weight elems); kchunk a
// multiple of 64 with splits * kchunk >= npad > (splits - 1) * kchunk.
// Launches on `stream`, does not synchronise; returns the cudaError_t of the
// launches (0 on success).
int xr_fused_nerf_mlp_bwd(const float* x, int dx, const float* v, int dv, const float* g,
                          long long n, const void* image, const void* w, const float* b,
                          float* dxo, float* dvo, float* dw, float* db, void* s, void* masks,
                          float* sums, float* wpart, int grid, int splits, long long kchunk,
                          void* stream) {
  const long long npad = (n + TILE - 1) / TILE * TILE;
  if (dx < 1 || dx > PX || dv < 1 || dv > PV || n < 1 || grid < 1 || kchunk < 1 ||
      kchunk % WG_ROWS != 0 || splits < 1 || (long long)splits * kchunk < npad ||
      (long long)(splits - 1) * kchunk >= npad || ((uintptr_t)image & 15) || ((uintptr_t)s & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = raise_smem_limits();
  if (err != cudaSuccess) return (int)err;
  fused_nerf_mlp_bwd_rows<<<(unsigned)grid, THREADS, SMEM_ROWS, st>>>(
      x, dx, v, dv, g, n, reinterpret_cast<const unsigned char*>(image),
      reinterpret_cast<const bf16*>(w), b, dxo, dvo, reinterpret_cast<unsigned char*>(s),
      reinterpret_cast<uint4*>(masks), sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fused_nerf_mlp_bwd_wgrad<<<dim3(N_WTILES, (unsigned)splits), THREADS, SMEM_WGRAD, st>>>(
      reinterpret_cast<const unsigned char*>(s), npad / WG_ROWS, kchunk / WG_ROWS, wpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fused_nerf_mlp_bwd_finish<<<(unsigned)((OWEND + OBEND + 31) / 32), 32 * RED_GROUPS, 0, st>>>(
      wpart, splits, sums, grid * CONSUMER_WARPS, dw, db);
  return (int)cudaGetLastError();
}

}  // extern "C"
