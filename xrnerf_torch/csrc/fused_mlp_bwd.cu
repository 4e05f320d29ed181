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
// H100's ~295 FLOP/B ridge. So nothing but x, g and dx touches device
// memory per row, and the design is about the two things a sequential TPU
// grid gave for free:
//   - the weight gradient is a sum over all rows. A CTA walks 128-row tiles
//     grid-stride and keeps its share of every dw and db in registers for
//     the whole walk; at the end it writes one f32 partial, and a second
//     kernel adds the partials of all CTAs in a fixed order. No atomics: the
//     same bits run to run;
//   - dw_i = act^T @ dpre reduces over rows, so both mma operands want the
//     row index contiguous. Each warp owns 16 rows for the forward recompute
//     and the data-gradient chain, which run register to register as in the
//     forward kernel (accumulator fragment -> A fragment), and on the way
//     writes x, h_i, dpre_i and g as bf16 into feature-major shared tiles
//     [feature][128 rows]. After a block barrier the 8 warps split the dw
//     outputs by n-tile and run mma over the tile's 128 rows (8 k-steps)
//     with both operands read as ordinary fragments from those tiles;
//   - the weights are staged once per CTA in both orientations: [out][in]
//     for the forward recompute and [in][out] for dh = dpre @ w^T.
// Widths are zero-padded inside the kernel (din to 32, hidden to 64, dout to
// 8 or 16); rows past n load x = 0 and g = 0, and with g = 0 every dpre of
// such a row is 0, so it adds nothing to any sum. Padded lanes of dx are not
// written. wgmma, TMA and a coalesced dx store are later work.

#include "mma_sync.cuh"

namespace {
namespace tinyb {

constexpr int KIN = 32;   // padded input width (din <= 32)
constexpr int HID = 64;   // padded hidden width (hidden <= 64)
constexpr int GP = 16;    // padded width of g (dout <= 16): one mma k-step
constexpr int ROWS = 128; // rows per tile
constexpr int WARPS = 8;  // 16 rows each
constexpr int NTHREADS = 32 * WARPS;
// shared row strides (bf16): +8 keeps the 8 rows of an mma fragment on
// distinct banks
constexpr int LDI = KIN + 8;
constexpr int LDH = HID + 8;
constexpr int LDO = GP + 8;
constexpr int LDT = ROWS + 8;

// Offsets (bf16 elements) of the shared-memory regions.
template <int NHID>
struct Smem {
  static constexpr int W1T = 0;                                   // [HID][LDI]  w1 as [out][in]
  static constexpr int W2T = W1T + HID * LDI;                     // [HID][LDH]  w2 as [out][in]
  static constexpr int W1N = W2T + (NHID == 2 ? HID * LDH : 0);   // [KIN][LDH]  w1 as [in][out]
  static constexpr int W2N = W1N + KIN * LDH;                     // [HID][LDH]  w2 as [in][out]
  static constexpr int WON = W2N + (NHID == 2 ? HID * LDH : 0);   // [HID][LDO]  w_last as [in][out]
  static constexpr int XW = WON + HID * LDO;                      // [WARPS][16][LDI] row-major x
  static constexpr int GW = XW + WARPS * 16 * LDI;                // [WARPS][16][LDO] row-major g
  static constexpr int XT = GW + WARPS * 16 * LDO;                // [KIN][LDT]
  static constexpr int H1T = XT + KIN * LDT;                      // [HID][LDT]
  static constexpr int D1T = H1T + HID * LDT;                     // [HID][LDT]
  static constexpr int H2T = D1T + HID * LDT;                     // [HID][LDT]
  static constexpr int D2T = H2T + (NHID == 2 ? HID * LDT : 0);   // [HID][LDT]
  static constexpr int GT = D2T + (NHID == 2 ? HID * LDT : 0);    // [GP][LDT]
  static constexpr int END = GT + GP * LDT;
  static constexpr int BYTES = END * 2 + 2 * HID * 4;             // + f32 b1, b2
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// dst[o][k] = bf16(w[k][o]) for a f32 [kin, nout] row-major matrix, padded
// with zeros to [NP][KP]; dst row stride LD.
template <int KP, int NP, int LD>
__device__ __forceinline__ void stage_transposed(const float* __restrict__ w, int kin, int nout,
                                                 bf16* dst) {
  for (int i = threadIdx.x; i < KP * NP; i += NTHREADS) {
    const int k = i / NP, o = i % NP;
    const float val = (k < kin && o < nout) ? __ldg(w + (size_t)k * nout + o) : 0.f;
    dst[o * LD + k] = __float2bfloat16_rn(val);
  }
}

// dst[k][o] = bf16(w[k][o]), padded with zeros to [KP][NP]; dst row stride LD.
template <int KP, int NP, int LD>
__device__ __forceinline__ void stage_natural(const float* __restrict__ w, int kin, int nout,
                                              bf16* dst) {
  for (int i = threadIdx.x; i < KP * NP; i += NTHREADS) {
    const int k = i / NP, o = i % NP;
    const float val = (k < kin && o < nout) ? __ldg(w + (size_t)k * nout + o) : 0.f;
    dst[k * LD + o] = __float2bfloat16_rn(val);
  }
}

template <int NP>
__device__ __forceinline__ void stage_bias(const float* __restrict__ b, int nout, float* dst) {
  for (int i = threadIdx.x; i < NP; i += NTHREADS) dst[i] = i < nout ? __ldg(b + i) : 0.f;
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[nt] += A (KS k-steps of register fragments) @ W[nt*8 .. nt*8+8, :]^T,
// W stored [n][k] with row stride LD.
template <int NT, int KS, int LD>
__device__ __forceinline__ void layer(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                      const bf16* W, int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* wp = W + (nt * 8 + g) * LD + ks * 16 + tg * 2;
      mma16816(acc[nt], a[ks][0], a[ks][1], a[ks][2], a[ks][3], lds32(wp), lds32(wp + 8));
    }
}

// A fragments (KS k-steps) of a warp-private row-major [16][LD] bf16 block.
template <int KS, int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* blk, int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* ap = blk + g * LD + ks * 16 + tg * 2;
    a[ks][0] = lds32(ap);
    a[ks][1] = lds32(ap + 8 * LD);
    a[ks][2] = lds32(ap + 8);
    a[ks][3] = lds32(ap + 8 * LD + 8);
  }
}

// The four values of accumulator n-tile nt, rounded to bf16, into a
// feature-major tile T[feature][row]: rows rw + g and rw + g + 8.
__device__ __forceinline__ void store_transposed(bf16* T, int nt, int rw, int lane, float v0,
                                                 float v1, float v2, float v3) {
  const int g = lane >> 2, tg = lane & 3;
  bf16* p = T + (nt * 8 + tg * 2) * LDT + rw + g;
  p[0] = __float2bfloat16_rn(v0);
  p[LDT] = __float2bfloat16_rn(v1);
  p[8] = __float2bfloat16_rn(v2);
  p[LDT + 8] = __float2bfloat16_rn(v3);
}

// h = relu(acc + bias): bit nt*4+j of `mask` says pre > 0; bf16(h) goes to the
// feature-major tile T and, with PACK, into the next layer's A fragments
// (n-tiles 2ks and 2ks+1 of the accumulator are one k-step).
template <bool PACK>
__device__ __forceinline__ void relu_mask(const float (&acc)[HID / 8][4], const float* bias,
                                          uint32_t& mask, uint32_t (&a)[HID / 16][4], bf16* T,
                                          int rw, int lane) {
  const int tg = lane & 3;
  mask = 0;
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt) {
    const float b0 = bias[nt * 8 + tg * 2], b1 = bias[nt * 8 + tg * 2 + 1];
    float v[4] = {acc[nt][0] + b0, acc[nt][1] + b1, acc[nt][2] + b0, acc[nt][3] + b1};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (v[j] > 0.f) mask |= 1u << (nt * 4 + j);
      v[j] = fmaxf(v[j], 0.f);
    }
    store_transposed(T, nt, rw, lane, v[0], v[1], v[2], v[3]);
    if (PACK) {
      a[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(v[0], v[1]);  // row g
      a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(v[2], v[3]);  // row g + 8
    }
  }
}

// dpre = dh where the mask bit is set, else 0: its f32 values add to the
// bias-gradient sums, bf16(dpre) goes to the tile T and into A fragments.
__device__ __forceinline__ void mask_pack(const float (&acc)[HID / 8][4], uint32_t mask,
                                          float (&dbacc)[HID / 8][2], uint32_t (&a)[HID / 16][4],
                                          bf16* T, int rw, int lane) {
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (mask >> (nt * 4 + j)) & 1u ? acc[nt][j] : 0.f;
    dbacc[nt][0] += v[0] + v[2];
    dbacc[nt][1] += v[1] + v[3];
    store_transposed(T, nt, rw, lane, v[0], v[1], v[2], v[3]);
    a[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(v[0], v[1]);
    a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
  }
}

// acc[mt] += AT[mt*16 .. +16, rows] @ BT[nt*8 .. +8, rows]^T over the tile's
// 128 rows: both operands are feature-major tiles, so the reduction index
// (the row) is contiguous for both fragments.
template <int MT>
__device__ __forceinline__ void wgrad(float (&acc)[MT][4], const bf16* AT, const bf16* BT, int nt,
                                      int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int ks = 0; ks < ROWS / 16; ++ks) {
    const bf16* bp = BT + (nt * 8 + g) * LDT + ks * 16 + tg * 2;
    const uint32_t b0 = lds32(bp), b1 = lds32(bp + 8);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const bf16* ap = AT + (mt * 16 + g) * LDT + ks * 16 + tg * 2;
      mma16816(acc[mt], lds32(ap), lds32(ap + 8 * LDT), lds32(ap + 8), lds32(ap + 8 * LDT + 8), b0,
               b1);
    }
  }
}

// One CTA's dw block (MT m-tiles of n-tile nt) into its f32 partial p, a
// [rows, cols] row-major matrix: element (m, n) for m < rows, n < cols.
template <int MT>
__device__ __forceinline__ void store_wgrad(const float (&acc)[MT][4], float* p, int rows,
                                            int cols, int m0, int nt, int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + mt * 16 + g + 8 * (j >> 1), c = nt * 8 + tg * 2 + (j & 1);
      if (m < rows && c < cols) p[m * cols + c] = acc[mt][j];
    }
}

// Per-thread column sums (rows g and g + 8 of every tile this warp saw) to
// the warp's row of `red` [WARPS][HID]: summed over the 8 row groups by
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

// NHID hidden layers (1 or 2), g padded to NOUT (8 or 16) columns for the
// last layer's weight gradient.
template <int NHID, int NOUT>
__global__ void __launch_bounds__(NTHREADS)
    tiny_mlp_bwd_kernel(const float* __restrict__ x, int din, long long n,
                        const float* __restrict__ w1, const float* __restrict__ b1, int h1,
                        const float* __restrict__ w2, const float* __restrict__ b2, int h2,
                        const float* __restrict__ wo, int dout, const float* __restrict__ gout,
                        float* __restrict__ dx, float* __restrict__ part) {
  using S = Smem<NHID>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16 *w1t = sm + S::W1T, *w2t = sm + S::W2T, *w1n = sm + S::W1N, *w2n = sm + S::W2N;
  bf16 *won = sm + S::WON, *xT = sm + S::XT, *h1T = sm + S::H1T, *d1T = sm + S::D1T;
  bf16 *h2T = sm + S::H2T, *d2T = sm + S::D2T, *gT = sm + S::GT;
  float* b1s = reinterpret_cast<float*>(smem_raw + (size_t)S::END * 2);
  float* b2s = b1s + HID;
  const int hl = NHID == 2 ? h2 : h1;  // width that feeds the last layer

  stage_transposed<KIN, HID, LDI>(w1, din, h1, w1t);
  stage_natural<KIN, HID, LDH>(w1, din, h1, w1n);
  stage_bias<HID>(b1, h1, b1s);
  if constexpr (NHID == 2) {
    stage_transposed<HID, HID, LDH>(w2, h1, h2, w2t);
    stage_natural<HID, HID, LDH>(w2, h1, h2, w2n);
    stage_bias<HID>(b2, h2, b2s);
  }
  stage_natural<HID, GP, LDO>(wo, hl, dout, won);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int rw = warp * 16;  // this warp's first row inside the tile
  bf16* xw = sm + S::XW + warp * 16 * LDI;  // warp-private
  bf16* gw = sm + S::GW + warp * 16 * LDO;

  // this thread's share of the CTA's sums, kept over the whole tile walk
  float dw1acc[KIN / 16][4], dw2acc[HID / 16][4], dwoacc[1][4];
  float db1acc[HID / 8][2], db2acc[HID / 8][2], dboacc = 0.f;
  zero_acc(dw1acc);
  zero_acc(dw2acc);
  zero_acc(dwoacc);
#pragma unroll
  for (int i = 0; i < HID / 8; ++i) db1acc[i][0] = db1acc[i][1] = db2acc[i][0] = db2acc[i][1] = 0.f;

  const long long ntiles = (n + ROWS - 1) / ROWS;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * ROWS + rw;  // this warp's first row
    // the warp's 16 x din block of x and 16 x dout block of g, rounded to
    // bf16, row-major for the A fragments and feature-major for the weight
    // gradients; pad columns and rows past n read as zero
#pragma unroll
    for (int i = lane; i < 16 * KIN; i += 32) {
      const int r = i / KIN, c = i % KIN;
      const float val = (r0 + r < n && c < din) ? __ldg(x + (r0 + r) * din + c) : 0.f;
      const bf16 v = __float2bfloat16_rn(val);
      xw[r * LDI + c] = v;
      xT[c * LDT + rw + r] = v;
    }
#pragma unroll
    for (int i = lane; i < 16 * GP; i += 32) {
      const int r = i / GP, c = i % GP;  // c == lane % 16 in every turn
      const float val = (r0 + r < n && c < dout) ? __ldg(gout + (r0 + r) * dout + c) : 0.f;
      dboacc += val;  // the last bias gradient sums the f32 g
      const bf16 v = __float2bfloat16_rn(val);
      gw[r * LDO + c] = v;
      gT[c * LDT + rw + r] = v;
    }
    __syncwarp();
    uint32_t ax[KIN / 16][4], ag[1][4];
    load_a<KIN / 16, LDI>(ax, xw, lane);
    load_a<1, LDO>(ag, gw, lane);

    // forward recompute: the ReLU masks, and bf16 h into the tiles
    float acc[HID / 8][4];
    uint32_t ah[HID / 16][4];
    uint32_t m1, m2 = 0;
    zero_acc(acc);
    layer<HID / 8, KIN / 16, LDI>(acc, ax, w1t, lane);
    relu_mask<NHID == 2>(acc, b1s, m1, ah, h1T, rw, lane);
    if constexpr (NHID == 2) {
      zero_acc(acc);
      layer<HID / 8, HID / 16, LDH>(acc, ah, w2t, lane);
      relu_mask<false>(acc, b2s, m2, ah, h2T, rw, lane);
    }

    // data gradients: dh_last = bf16(g) @ w_last^T, then down the chain
    zero_acc(acc);
    layer<HID / 8, 1, LDO>(acc, ag, won, lane);
    if constexpr (NHID == 2) {
      mask_pack(acc, m2, db2acc, ah, d2T, rw, lane);
      zero_acc(acc);
      layer<HID / 8, HID / 16, LDH>(acc, ah, w2n, lane);
    }
    mask_pack(acc, m1, db1acc, ah, d1T, rw, lane);
    float o[KIN / 8][4];
    zero_acc(o);
    layer<KIN / 8, HID / 16, LDH>(o, ah, w1n, lane);
#pragma unroll
    for (int nt = 0; nt < KIN / 8; ++nt) {
      const int c = nt * 8 + tg * 2;  // this lane holds columns c, c + 1
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = r0 + g + 8 * half;
        if (r < n) {
          if (c < din) dx[r * din + c] = o[nt][2 * half];
          if (c + 1 < din) dx[r * din + c + 1] = o[nt][2 * half + 1];
        }
      }
    }
    __syncthreads();  // the tiles of all 8 warps are written

    // weight gradients over the tile's 128 rows; warp w owns n-tile w
    wgrad<KIN / 16>(dw1acc, xT, d1T, warp, lane);
    if constexpr (NHID == 2) wgrad<HID / 16>(dw2acc, h1T, d2T, warp, lane);
    if (warp < 4 * (NOUT / 8))  // [64, NOUT]: (m-tile, n-tile) pairs over the warps
      wgrad<1>(dwoacc, (NHID == 2 ? h2T : h1T) + (warp & 3) * 16 * LDT, gT, warp >> 2, lane);
    __syncthreads();  // before the next tile overwrites them
  }

  // this CTA's partial
  const Layout L = layout<NHID>(din, h1, h2, dout);
  float* p = part + (size_t)blockIdx.x * L.size;
  store_wgrad<KIN / 16>(dw1acc, p + L.dw1, din, h1, 0, warp, lane);
  if constexpr (NHID == 2) store_wgrad<HID / 16>(dw2acc, p + L.dw2, h1, h2, 0, warp, lane);
  if (warp < 4 * (NOUT / 8))
    store_wgrad<1>(dwoacc, p + L.dwo, hl, dout, (warp & 3) * 16, warp >> 2, lane);

  // bias gradients: warps' sums through shared memory (the tiles are free
  // after the loop's last barrier), added in warp order
  float* red1 = reinterpret_cast<float*>(h1T);
  float* red2 = red1 + WARPS * HID;
  float* redo = red2 + WARPS * HID;
  reduce_bias(db1acc, red1, warp, lane);
  if constexpr (NHID == 2) reduce_bias(db2acc, red2, warp, lane);
  dboacc += __shfl_xor_sync(0xffffffffu, dboacc, 16);
  if (lane < GP) redo[warp * GP + lane] = dboacc;
  __syncthreads();
  for (int j = threadIdx.x; j < HID; j += NTHREADS) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      s1 += red1[w * HID + j];
      if (NHID == 2) s2 += red2[w * HID + j];
    }
    if (j < h1) p[L.db1 + j] = s1;
    if (NHID == 2 && j < h2) p[L.db2 + j] = s2;
  }
  if (threadIdx.x < dout) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += redo[w * GP + threadIdx.x];
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

// CTAs per SM: what the shared tiles leave room for.
template <int NHID>
constexpr int ctas_per_sm() {
  return NHID == 2 ? 1 : 2;
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
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
  kernel<<<blocks, NTHREADS, Smem<NHID>::BYTES, stream>>>(x, din, n, w1, b1, h1, w2, b2, h2, wo,
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
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + ROWS - 1) / ROWS;
  long long cap = (long long)sms * ctas_per_sm<NHID>();
  if (cap > max_parts) cap = max_parts;
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

// The most partials a launch writes (CTAs in its grid) on the current
// device, or -1: the caller allocates `part` [max_parts, grads elements].
int xr_fused_mlp_bwd_max_parts() {
  int sms = 0;
  return tinyb::sm_count(&sms) == cudaSuccess ? 2 * sms : -1;
}

// Backward of out = relu(x @ w1 + b1) @ w2 + b2 for the upstream gradient g
// [n, dout]: dx [n, din], and `grads` = dw1 [din, h] | db1 [h] | dw2
// [h, dout] | db2 [dout], all f32 row-major. n >= 1. `part` is scratch for
// max_parts partials of `grads`' size. Launches on `stream`, does not
// synchronise; returns the cudaError_t of the launches (0 on success).
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
