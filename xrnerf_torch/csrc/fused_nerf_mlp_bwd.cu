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
// What bounds it: operations. Three times the forward's 593,408 MACs per
// row (remat, data gradients, weight gradients): 3.56 MFLOP per row against
// ~740 bytes of row input/output. In this bring-up design it is bytes
// instead, because of the scratch below.
//
// Design, three launches on one stream:
//  (a) fused_nerf_mlp_bwd_rows: one CTA per 128-row tile, 16 warps, as the
//      forward kernel. It recomputes the forward with two ping-pong
//      [128, 256] bf16 buffers in shared memory, keeps each layer's ReLU mask
//      as bits (37 KB), then runs the data-gradient chain in the same two
//      buffers. The weight-gradient products need every layer's input and
//      dpre for all rows, ~10 KB per row, which no SM holds; so the tile
//      writes each bf16 layer input and bf16 dpre, transposed (feature-major,
//      [feature][npad]), to a global scratch. dx and dv go straight to their
//      outputs, bias gradients to per-CTA f32 partials.
//  (b) fused_nerf_mlp_bwd_wgrad: dW[o][i] = sum_r D[o][r] * H[i][r] for the
//      14 weight blocks, one CTA per 128 (in) x 64 (out) tile and split of
//      the rows, mma.sync with both operands read as 16-byte loads from the
//      feature-major scratch. Each split writes its own f32 partial.
//  (c) fused_nerf_mlp_bwd_reduce (twice): sums the weight and bias partials
//      over the splits in a fixed order.
// The TPU kernel sums weight gradients across row tiles with read-modify-
// write, race-free there only because its grid runs in sequence. Here no
// CTA reads or writes another's sums: no atomics, and the result is the same
// bits run to run.
//
// Cost of the scratch: 4,976 bf16 features per row are written once and read
// back by (b), ~8 GB at 786,432 rows. Keeping them on chip is later work.
//
// Products whose weight operand is read transposed (the data-gradient chain
// reads W [out, in] as [K = out, N = in]) load B fragments as two 16-bit
// loads per register; the forward's [out, in] order gives one 32-bit load.
// The 8-row alpha and rgb heads enter the data-gradient chain as one or
// three f32 FMAs per element instead of a padded mma.

#include "fused_nerf_mlp_common.cuh"

namespace {

constexpr int MASK_W = WIDTH / 32;  // mask words per row and layer
constexpr int N_MASKS = 9;          // h0..h7, v1
constexpr int GW = 4;               // g columns: rgb 0..2, sigma 3
constexpr size_t SMEM_BWD = sizeof(bf16) * TILE * (LDX + LDV + 2 * LDH) +
                            sizeof(uint32_t) * N_MASKS * TILE * MASK_W +
                            sizeof(float) * TILE * GW;

// Scratch features (rows of the feature-major [SEND][npad] bf16 scratch).
constexpr int SX = 0;                  // x (64)
constexpr int SV = SX + PX;            // v (32)
constexpr int SH = SV + PV;            // h0..h7 (8 x 256)
constexpr int SFEAT = SH + 8 * WIDTH;  // feat (256)
constexpr int SV1 = SFEAT + WIDTH;     // v1 (128)
constexpr int SG = SV1 + HV;           // 0..7: bf16 g_rgb (3) + 0; 8..15: bf16 g_sigma + 0
constexpr int SDP = SG + 16;           // dpre0..dpre7 (8 x 256)
constexpr int SDFEAT = SDP + 8 * WIDTH;  // bf16 dfeat (256)
constexpr int SDPV = SDFEAT + WIDTH;   // bf16 dpre_v (128)
constexpr int SEND = SDPV + HV;        // 4,976

__device__ __forceinline__ uint32_t ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ float bf16r(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// acc[rows m0.., cols n0..n0+8*NT) += As[:, 0:K] @ W[0:K, n0..] with W a
// global bf16 [K][LDW] matrix: the pack's [out][in] block read as its
// transpose (K = out, N = in).
template <int NT, int K, int LDW>
__device__ __forceinline__ void mma_acc_t(float (&acc)[MT][NT][4], const bf16* As, int lda,
                                          const bf16* __restrict__ W, int n0, int m0,
                                          int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* wp = W + (size_t)(k + tg * 2) * LDW + n0 + nt * 8 + g;
      b[nt][0] = ldg16(wp) | (ldg16(wp + LDW) << 16);
      b[nt][1] = ldg16(wp + 8 * LDW) | (ldg16(wp + 9 * LDW) << 16);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const bf16* ap = As + (m0 + mt * 16 + g) * lda + k + tg * 2;
      const uint32_t a0 = lds32(ap);
      const uint32_t a1 = lds32(ap + 8 * lda);
      const uint32_t a2 = lds32(ap + 8);
      const uint32_t a3 = lds32(ap + 8 * lda + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma16816(acc[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
    }
  }
}

// Bit c of masks[r * MASK_W + c / 32] = (H[r][c] > 0), for C columns.
template <int C>
__device__ __forceinline__ void record_mask(const bf16* H, uint32_t* masks) {
  for (int i = threadIdx.x; i < TILE * (C / 32); i += THREADS) {
    const int r = i / (C / 32), w = i % (C / 32);
    const bf16* p = H + r * LDH + w * 32;
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) bits |= (uint32_t)(__bfloat162float(p[j]) > 0.f) << j;
    masks[r * MASK_W + w] = bits;
  }
}

// seg[c * npad + row0 + r] = buf[r][c] for c < C, r < TILE: the tile's
// columns into the feature-major scratch, two rows per store.
template <int C>
__device__ __forceinline__ void store_t(const bf16* buf, int ld, bf16* __restrict__ seg,
                                        long long npad, long long row0) {
  for (int i = threadIdx.x; i < C * (TILE / 2); i += THREADS) {
    const int c = i / (TILE / 2), r = (i % (TILE / 2)) * 2;
    __nv_bfloat162 pr;
    pr.x = buf[r * ld + c];
    pr.y = buf[(r + 1) * ld + c];
    *reinterpret_cast<__nv_bfloat162*>(seg + c * npad + row0 + r) = pr;
  }
}

// dpre = mask ? acc (+ bf16(g_sigma) * wa[col]) : 0 in f32. Its bf16 goes to
// Out, its column sums over this warp's 64 rows to bsum[col] (a fixed
// shuffle order). mask == nullptr: no activation (feat).
template <int NT>
__device__ __forceinline__ void epi_dpre(float (&acc)[MT][NT][4], const uint32_t* mask,
                                         bf16* Out, float* __restrict__ bsum, int n0, int m0,
                                         int lane, const float* gs = nullptr,
                                         const bf16* __restrict__ wa = nullptr) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + tg * 2;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int row = m0 + mt * 16 + g + 8 * h;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (wa != nullptr) {
          const float gsb = bf16r(gs[row * GW + 3]);
          v0 = fmaf(gsb, __bfloat162float(wa[col]), v0);
          v1 = fmaf(gsb, __bfloat162float(wa[col + 1]), v1);
        }
        if (mask != nullptr) {
          const uint32_t m = mask[row * MASK_W + col / 32] >> (col % 32);
          v0 = (m & 1u) ? v0 : 0.f;
          v1 = (m & 2u) ? v1 : 0.f;
        }
        s0 += v0;
        s1 += v1;
        *reinterpret_cast<__nv_bfloat162*>(Out + row * LDH + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (g == 0) {
      bsum[col] = s0;
      bsum[col + 1] = s1;
    }
  }
}

// out[row][col] (+)= acc for rows < n, cols < ncols: one n8 tile per warp.
template <bool ADD>
__device__ __forceinline__ void store_rows(const float (&acc)[MT][1][4], float* __restrict__ out,
                                           int ncols, long long n, long long row0, int n0,
                                           int m0, int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + m0 + mt * 16 + g + 8 * h;
      if (row >= n) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = n0 + tg * 2 + c;
        if (col >= ncols) continue;
        float* p = out + row * ncols + col;
        *p = ADD ? *p + acc[mt][0][2 * h + c] : acc[mt][0][2 * h + c];
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_nerf_mlp_bwd_rows(const float* __restrict__ x, int dx, const float* __restrict__ v,
                            int dv, const float* __restrict__ gin, long long n,
                            const bf16* __restrict__ Wp, const float* __restrict__ Bp,
                            float* __restrict__ dxo, float* __restrict__ dvo,
                            bf16* __restrict__ S, long long npad, float* __restrict__ bpart) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [TILE][LDX]
  bf16* vs = xs + TILE * LDX;                // [TILE][LDV]
  bf16* A = vs + TILE * LDV;                 // [TILE][LDH]
  bf16* B = A + TILE * LDH;                  // [TILE][LDH]
  uint32_t* masks = reinterpret_cast<uint32_t*>(B + TILE * LDH);  // [N_MASKS][TILE][MASK_W]
  float* gs = reinterpret_cast<float*>(masks + N_MASKS * TILE * MASK_W);  // [TILE][GW]

  const long long row0 = (long long)blockIdx.x * TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = wm * (TILE / WARPS_M);
  const int n0 = wn * (WIDTH / WARPS_N);  // 32 columns of a 256-wide layer
  const int n8 = wn * 8;                  // one n8 tile of a 64 / 32-wide output
  float* bsum = bpart + ((size_t)blockIdx.x * WARPS_M + wm) * OBEND;
  auto mask = [&](int l) { return masks + l * TILE * MASK_W; };
  auto seg = [&](int f) { return S + (size_t)f * npad; };

  stage<PX, LDX>(x, dx, n, row0, xs);
  stage<PV, LDV>(v, dv, n, row0, vs);
  for (int i = threadIdx.x; i < TILE * GW; i += THREADS)
    gs[i] = (row0 + i / GW < n) ? __ldg(gin + row0 * GW + i) : 0.f;
  __syncthreads();
  store_t<PX>(xs, LDX, seg(SX), npad, row0);
  store_t<PV>(vs, LDV, seg(SV), npad, row0);

  // --- recompute the forward; after each layer: its mask and its scratch copy ---
  dense_relu<PX>(xs, LDX, Wp + OW0, Bp + 0 * WIDTH, A, n0, m0, lane);  // h0
  __syncthreads();
  record_mask<WIDTH>(A, mask(0));
  store_t<WIDTH>(A, LDH, seg(SH + 0 * WIDTH), npad, row0);
  dense_relu<WIDTH>(A, LDH, Wp + OW1, Bp + 1 * WIDTH, B, n0, m0, lane);  // h1
  __syncthreads();
  record_mask<WIDTH>(B, mask(1));
  store_t<WIDTH>(B, LDH, seg(SH + 1 * WIDTH), npad, row0);
  dense_relu<WIDTH>(B, LDH, Wp + OW2, Bp + 2 * WIDTH, A, n0, m0, lane);  // h2
  __syncthreads();
  record_mask<WIDTH>(A, mask(2));
  store_t<WIDTH>(A, LDH, seg(SH + 2 * WIDTH), npad, row0);
  dense_relu<WIDTH>(A, LDH, Wp + OW3, Bp + 3 * WIDTH, B, n0, m0, lane);  // h3
  __syncthreads();
  record_mask<WIDTH>(B, mask(3));
  store_t<WIDTH>(B, LDH, seg(SH + 3 * WIDTH), npad, row0);
  dense_relu<WIDTH>(B, LDH, Wp + OW4, Bp + 4 * WIDTH, A, n0, m0, lane);  // h4
  __syncthreads();
  record_mask<WIDTH>(A, mask(4));
  store_t<WIDTH>(A, LDH, seg(SH + 4 * WIDTH), npad, row0);
  {  // h5 = relu(h4 @ W5h + x @ W5x + b5)
    float acc[MT][4][4];
    zero(acc);
    mma_acc<4, WIDTH>(acc, A, LDH, Wp + OW5H, n0, m0, lane);
    mma_acc<4, PX>(acc, xs, LDX, Wp + OW5X, n0, m0, lane);
    store_bf16<4, true>(acc, Bp + 5 * WIDTH, B, LDH, n0, m0, lane);
  }
  __syncthreads();
  record_mask<WIDTH>(B, mask(5));
  store_t<WIDTH>(B, LDH, seg(SH + 5 * WIDTH), npad, row0);
  dense_relu<WIDTH>(B, LDH, Wp + OW6, Bp + 6 * WIDTH, A, n0, m0, lane);  // h6
  __syncthreads();
  record_mask<WIDTH>(A, mask(6));
  store_t<WIDTH>(A, LDH, seg(SH + 6 * WIDTH), npad, row0);
  dense_relu<WIDTH>(A, LDH, Wp + OW7, Bp + 7 * WIDTH, B, n0, m0, lane);  // h7
  __syncthreads();
  record_mask<WIDTH>(B, mask(7));
  store_t<WIDTH>(B, LDH, seg(SH + 7 * WIDTH), npad, row0);
  {  // feat = bf16(h7 @ Wf + bf)
    float acc[MT][4][4];
    zero(acc);
    mma_acc<4, WIDTH>(acc, B, LDH, Wp + OWF, n0, m0, lane);
    store_bf16<4, false>(acc, Bp + OBF, A, LDH, n0, m0, lane);
  }
  __syncthreads();
  store_t<WIDTH>(A, LDH, seg(SFEAT), npad, row0);
  {  // v1 = relu(feat @ Wvf + v @ Wvv + bv), 16 columns per warp
    const int nv = wn * (HV / WARPS_N);
    float acc[MT][2][4];
    zero(acc);
    mma_acc<2, WIDTH>(acc, A, LDH, Wp + OWVF, nv, m0, lane);
    mma_acc<2, PV>(acc, vs, LDV, Wp + OWVV, nv, m0, lane);
    store_bf16<2, true>(acc, Bp + OBV, B, LDH, nv, m0, lane);
  }
  __syncthreads();
  record_mask<HV>(B, mask(8));
  store_t<HV>(B, LDH, seg(SV1), npad, row0);

  // --- heads: g into the scratch, rgb / alpha bias gradients ---
  for (int i = threadIdx.x; i < 16 * (TILE / 2); i += THREADS) {
    const int c = i / (TILE / 2), r = (i % (TILE / 2)) * 2;
    const int src = c < 3 ? c : (c == 8 ? 3 : -1);
    const float g0 = src >= 0 ? gs[r * GW + src] : 0.f;
    const float g1 = src >= 0 ? gs[(r + 1) * GW + src] : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(seg(SG + c) + row0 + r) = __floats2bfloat162_rn(g0, g1);
  }
  if (threadIdx.x < HEAD) {
    const int t = threadIdx.x;
    float s_rgb = 0.f, s_sig = 0.f;
    for (int r = 0; r < TILE; ++r) {
      if (t < 3) s_rgb += gs[r * GW + t];
      if (t == 0) s_sig += gs[r * GW + 3];
    }
    float* b0 = bpart + (size_t)blockIdx.x * WARPS_M * OBEND;
    b0[OBRGB + t] = s_rgb;
    b0[OBA + t] = s_sig;
    b0[OBEND + OBRGB + t] = 0.f;  // the second row-half's slot
    b0[OBEND + OBA + t] = 0.f;
  }
  __syncthreads();  // mask(8) is read below

  // --- data-gradient chain ---
  {  // dpre_v = mask_v ? bf16(g_rgb) @ Wrgb : 0, 16 columns per warp
    const int nv = wn * (HV / WARPS_N);
    const int g = lane >> 2, tg = lane & 3;
    float acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + mt * 16 + g + 8 * (e >> 1);
          const int col = nv + nt * 8 + tg * 2 + (e & 1);
          float s = 0.f;
#pragma unroll
          for (int o = 0; o < 3; ++o)
            s = fmaf(bf16r(gs[row * GW + o]), __bfloat162float(Wp[OWRGB + o * HV + col]), s);
          acc[mt][nt][e] = s;
        }
    epi_dpre<2>(acc, mask(8), A, bsum + OBV, nv, m0, lane);
  }
  __syncthreads();
  store_t<HV>(A, LDH, seg(SDPV), npad, row0);
  {  // dfeat = bf16(dpre_v) @ Wvf (no activation); its sums are bf's gradient
    float acc[MT][4][4];
    zero(acc);
    mma_acc_t<4, HV, WIDTH>(acc, A, LDH, Wp + OWVF, n0, m0, lane);
    epi_dpre<4>(acc, nullptr, B, bsum + OBF, n0, m0, lane);
  }
  if (wn < PV / 8) {  // dv = bf16(dpre_v) @ Wvv
    float acc[MT][1][4];
    zero(acc);
    mma_acc_t<1, HV, PV>(acc, A, LDH, Wp + OWVV, n8, m0, lane);
    store_rows<false>(acc, dvo, dv, n, row0, n8, m0, lane);
  }
  __syncthreads();
  store_t<WIDTH>(B, LDH, seg(SDFEAT), npad, row0);
  {  // dpre7 from dh7 = bf16(dfeat) @ Wf + bf16(g_sigma) * Wa[0]
    float acc[MT][4][4];
    zero(acc);
    mma_acc_t<4, WIDTH, WIDTH>(acc, B, LDH, Wp + OWF, n0, m0, lane);
    epi_dpre<4>(acc, mask(7), A, bsum + 7 * WIDTH, n0, m0, lane, gs, Wp + OWA);
  }
  __syncthreads();
  store_t<WIDTH>(A, LDH, seg(SDP + 7 * WIDTH), npad, row0);
  {  // dpre6
    float acc[MT][4][4];
    zero(acc);
    mma_acc_t<4, WIDTH, WIDTH>(acc, A, LDH, Wp + OW7, n0, m0, lane);
    epi_dpre<4>(acc, mask(6), B, bsum + 6 * WIDTH, n0, m0, lane);
  }
  __syncthreads();
  store_t<WIDTH>(B, LDH, seg(SDP + 6 * WIDTH), npad, row0);
  {  // dpre5
    float acc[MT][4][4];
    zero(acc);
    mma_acc_t<4, WIDTH, WIDTH>(acc, B, LDH, Wp + OW6, n0, m0, lane);
    epi_dpre<4>(acc, mask(5), A, bsum + 5 * WIDTH, n0, m0, lane);
  }
  __syncthreads();
  store_t<WIDTH>(A, LDH, seg(SDP + 5 * WIDTH), npad, row0);
  {  // dx = bf16(dpre5) @ W5x (the skip input's part)
    float acc[MT][1][4];
    zero(acc);
    mma_acc_t<1, WIDTH, PX>(acc, A, LDH, Wp + OW5X, n8, m0, lane);
    store_rows<false>(acc, dxo, dx, n, row0, n8, m0, lane);
  }
  {  // dpre4
    float acc[MT][4][4];
    zero(acc);
    mma_acc_t<4, WIDTH, WIDTH>(acc, A, LDH, Wp + OW5H, n0, m0, lane);
    epi_dpre<4>(acc, mask(4), B, bsum + 4 * WIDTH, n0, m0, lane);
  }
  __syncthreads();
  store_t<WIDTH>(B, LDH, seg(SDP + 4 * WIDTH), npad, row0);
  {  // dpre3
    float acc[MT][4][4];
    zero(acc);
    mma_acc_t<4, WIDTH, WIDTH>(acc, B, LDH, Wp + OW4, n0, m0, lane);
    epi_dpre<4>(acc, mask(3), A, bsum + 3 * WIDTH, n0, m0, lane);
  }
  __syncthreads();
  store_t<WIDTH>(A, LDH, seg(SDP + 3 * WIDTH), npad, row0);
  {  // dpre2
    float acc[MT][4][4];
    zero(acc);
    mma_acc_t<4, WIDTH, WIDTH>(acc, A, LDH, Wp + OW3, n0, m0, lane);
    epi_dpre<4>(acc, mask(2), B, bsum + 2 * WIDTH, n0, m0, lane);
  }
  __syncthreads();
  store_t<WIDTH>(B, LDH, seg(SDP + 2 * WIDTH), npad, row0);
  {  // dpre1
    float acc[MT][4][4];
    zero(acc);
    mma_acc_t<4, WIDTH, WIDTH>(acc, B, LDH, Wp + OW2, n0, m0, lane);
    epi_dpre<4>(acc, mask(1), A, bsum + 1 * WIDTH, n0, m0, lane);
  }
  __syncthreads();
  store_t<WIDTH>(A, LDH, seg(SDP + 1 * WIDTH), npad, row0);
  {  // dpre0
    float acc[MT][4][4];
    zero(acc);
    mma_acc_t<4, WIDTH, WIDTH>(acc, A, LDH, Wp + OW1, n0, m0, lane);
    epi_dpre<4>(acc, mask(0), B, bsum + 0 * WIDTH, n0, m0, lane);
  }
  __syncthreads();
  store_t<WIDTH>(B, LDH, seg(SDP + 0 * WIDTH), npad, row0);
  {  // dx += bf16(dpre0) @ W0 (same thread, same elements as above)
    float acc[MT][1][4];
    zero(acc);
    mma_acc_t<1, WIDTH, PX>(acc, B, LDH, Wp + OW0, n8, m0, lane);
    store_rows<true>(acc, dxo, dx, n, row0, n8, m0, lane);
  }
}

// One weight block's gradient dW[o][i] = sum_r D[o][r] * H[i][r]: H and D
// are feature rows of the scratch, dW sits at pack offset w ([O][I]).
struct WJob {
  int h, d, I, O;
  long long w;
};
constexpr int N_JOBS = 14;
struct WJobs {
  WJob j[N_JOBS];
};
constexpr int WG_WARPS = 4;
constexpr int WG_I = 32 * WG_WARPS;  // a warp owns 32 rows of I
constexpr int WG_O = 64;             // and 64 columns of O

__host__ __device__ inline int wg_tiles(const WJob& j) {
  return ((j.I + WG_I - 1) / WG_I) * ((j.O + WG_O - 1) / WG_O);
}

__device__ __forceinline__ uint4 ldg128(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Grid (tiles of all jobs, splits of the rows). A lane loads 8 consecutive
// rows r of one H / D feature as one 16-byte load and feeds them to two
// mma k-steps; H and D use the same order of r, so the products pair the
// same rows.
__global__ void __launch_bounds__(32 * WG_WARPS)
    fused_nerf_mlp_bwd_wgrad(const bf16* __restrict__ S, long long npad, long long kchunk,
                             WJobs jobs, float* __restrict__ wpart) {
  int t = blockIdx.x, jb = 0;
  while (jb < N_JOBS - 1 && t >= wg_tiles(jobs.j[jb])) t -= wg_tiles(jobs.j[jb++]);
  const WJob J = jobs.j[jb];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int nto = (J.O + WG_O - 1) / WG_O;
  const int i0 = (t / nto) * WG_I + warp * 32, o0 = (t % nto) * WG_O;
  if (i0 >= J.I) return;
  const int nto8 = min(WG_O, J.O - o0) / 8;
  const long long k0 = (long long)blockIdx.y * kchunk;
  const long long k1 = min(k0 + kchunk, npad);
  const bf16* H = S + ((size_t)J.h + i0) * npad;
  const bf16* D = S + ((size_t)J.d + o0) * npad;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (long long k = k0 + tg * 8; k < k1; k += 32) {
    uint4 a[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) a[mt][hh] = ldg128(H + (size_t)(mt * 16 + g + 8 * hh) * npad + k);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= nto8) break;
      const uint4 b = ldg128(D + (size_t)(nt * 8 + g) * npad + k);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma16816(acc[mt][nt], a[mt][0].x, a[mt][1].x, a[mt][0].y, a[mt][1].y, b.x, b.y);
        mma16816(acc[mt][nt], a[mt][0].z, a[mt][1].z, a[mt][0].w, a[mt][1].w, b.z, b.w);
      }
    }
  }

  float* out = wpart + (size_t)blockIdx.y * OWEND + J.w;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nto8) break;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + mt * 16 + g + 8 * (e >> 1);
        const int o = o0 + nt * 8 + tg * 2 + (e & 1);
        out[(size_t)o * J.I + i] = acc[mt][nt][e];
      }
  }
}

// out[e] = sum over s < rows of part[s * E + e], in a fixed order: eight row
// groups (s = rg, rg + 8, ...) summed in turn, then combined 0..7.
constexpr int RED_GROUPS = 8;
__global__ void __launch_bounds__(32 * RED_GROUPS)
    fused_nerf_mlp_bwd_reduce(const float* __restrict__ part, long long rows, long long E,
                              float* __restrict__ out) {
  __shared__ float red[RED_GROUPS][32];
  const int c = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const long long e = (long long)blockIdx.x * 32 + c;
  float s = 0.f;
  if (e < E)
    for (long long r = rg; r < rows; r += RED_GROUPS) s += part[r * E + e];
  red[rg][c] = s;
  __syncthreads();
  if (rg == 0 && e < E) {
    float tot = red[0][c];
#pragma unroll
    for (int j = 1; j < RED_GROUPS; ++j) tot += red[j][c];
    out[e] = tot;
  }
}

}  // namespace

extern "C" {

// Features per row of the bf16 scratch the caller allocates ([SEND][npad]).
long long xr_fused_nerf_mlp_bwd_scratch_features() { return SEND; }
long long xr_fused_nerf_mlp_bwd_weight_elems() { return (long long)OWEND; }
long long xr_fused_nerf_mlp_bwd_bias_elems() { return (long long)OBEND; }

const char* xr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [n, dx] f32 (dx <= 64), v [n, dv] f32 (dv <= 32), g [n, 4] f32, w / b
// packed as the forward's. Writes dx [n, dx], dv [n, dv], dw [weight elems]
// and db [bias elems], all f32. Scratch from the caller: s (bf16,
// SEND * npad), wpart (f32, splits * weight elems), bpart (f32,
// 2 * (npad / 128) * bias elems); npad is n rounded up to 128, kchunk a
// multiple of 128 with splits * kchunk >= npad. Launches on `stream`, does
// not synchronise; returns the cudaError_t of the launches (0 on success).
int xr_fused_nerf_mlp_bwd(const float* x, int dx, const float* v, int dv, const float* g,
                          long long n, const void* w, const float* b, float* dxo, float* dvo,
                          float* dw, float* db, void* s, long long npad, float* wpart,
                          int splits, long long kchunk, float* bpart, void* stream) {
  if (dx < 1 || dx > PX || dv < 1 || dv > PV || n < 1 || npad < n || npad % TILE != 0 ||
      kchunk < 1 || kchunk % TILE != 0 || splits < 1 || (long long)splits * kchunk < npad ||
      (long long)(splits - 1) * kchunk >= npad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* wp = reinterpret_cast<const bf16*>(w);
  bf16* sp = reinterpret_cast<bf16*>(s);
  cudaError_t err = cudaFuncSetAttribute(fused_nerf_mlp_bwd_rows,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BWD);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = npad / TILE;
  fused_nerf_mlp_bwd_rows<<<(unsigned)blocks, THREADS, SMEM_BWD, st>>>(
      x, dx, v, dv, g, n, wp, b, dxo, dvo, sp, npad, bpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const WJobs jobs = {{
      {SX, SDP + 0 * WIDTH, PX, WIDTH, (long long)OW0},
      {SH + 0 * WIDTH, SDP + 1 * WIDTH, WIDTH, WIDTH, (long long)OW1},
      {SH + 1 * WIDTH, SDP + 2 * WIDTH, WIDTH, WIDTH, (long long)OW2},
      {SH + 2 * WIDTH, SDP + 3 * WIDTH, WIDTH, WIDTH, (long long)OW3},
      {SH + 3 * WIDTH, SDP + 4 * WIDTH, WIDTH, WIDTH, (long long)OW4},
      {SH + 4 * WIDTH, SDP + 5 * WIDTH, WIDTH, WIDTH, (long long)OW5H},
      {SX, SDP + 5 * WIDTH, PX, WIDTH, (long long)OW5X},
      {SH + 5 * WIDTH, SDP + 6 * WIDTH, WIDTH, WIDTH, (long long)OW6},
      {SH + 6 * WIDTH, SDP + 7 * WIDTH, WIDTH, WIDTH, (long long)OW7},
      {SH + 7 * WIDTH, SDFEAT, WIDTH, WIDTH, (long long)OWF},
      {SH + 7 * WIDTH, SG + 8, WIDTH, HEAD, (long long)OWA},
      {SFEAT, SDPV, WIDTH, HV, (long long)OWVF},
      {SV, SDPV, PV, HV, (long long)OWVV},
      {SV1, SG + 0, HV, HEAD, (long long)OWRGB},
  }};
  int tiles = 0;
  for (int j = 0; j < N_JOBS; ++j) tiles += wg_tiles(jobs.j[j]);
  fused_nerf_mlp_bwd_wgrad<<<dim3((unsigned)tiles, (unsigned)splits), 32 * WG_WARPS, 0, st>>>(
      sp, npad, kchunk, jobs, wpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fused_nerf_mlp_bwd_reduce<<<(unsigned)((OWEND + 31) / 32), 32 * RED_GROUPS, 0, st>>>(
      wpart, splits, (long long)OWEND, dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fused_nerf_mlp_bwd_reduce<<<(unsigned)((OBEND + 31) / 32), 32 * RED_GROUPS, 0, st>>>(
      bpart, blocks * WARPS_M, (long long)OBEND, db);
  return (int)cudaGetLastError();
}

}  // extern "C"
