// Fused tiny-MLP forwards for Hopper (sm_90a), bound with ctypes: the
// Instant-NGP density net (one hidden layer) and colour net (two).
//
// Replaces the TPU kernels of xrnerf_tpu/ops/pallas/fused_mlp.py:
//   xr_fused_mlp2_fwd  <-  _fwd2_kernel (:64), launched by _fused2_fwd_impl
//                          (pallas_call at :121) under fused_mlp2 (:112)
//   xr_fused_mlp3_fwd  <-  _fwd3_kernel (:184), launched by _fused3_fwd_impl
//                          (pallas_call at :253) under fused_mlp3 (:245)
//
// What they compute, per row of x [n, din] (f32 in global memory):
//   mlp2: out = relu(x@w1 + b1) @ w2 + b2
//   mlp3: out = relu(relu(x@w1 + b1) @ w2 + b2) @ w3 + b3
// with the TPU bodies' numerics: x and the weights rounded to bf16 (round
// to nearest even), products accumulated in f32, f32 biases added to the
// accumulators, each hidden activation rounded to bf16 after its ReLU, the
// output left in f32. Weights arrive as the JAX package passes them, f32
// [in, out] row-major, and are rounded here. Widths are padded with zeros
// inside the kernels (din to 32, hidden to 64, out to 8 or 16), so the
// caller passes the JAX shapes: a padded hidden unit has zero weights and
// bias, so it is relu(0) = 0 and adds nothing.
//
// What bounds them: bytes. At the widths Instant-NGP uses, a row moves
// 192 B (32 in, 16 out) for 6,144 FLOP, or 136 B (31 in, 3 out) for 12,544
// FLOP: 32 and 92 FLOP per byte, far under the H100's ~295 FLOP/B ridge.
// So nothing but x once and out once touches device memory per row. What
// decides the time is whether the chain of small products per tile keeps
// pace with the bytes: the file holds two designs.
//
// The colour net (tiny_mlp3_fwd_kernel) is the forward half of the wgmma
// design of fused_mlp_bwd.cu:
//   - a persistent grid, CTAS_PER_SM = 2 CTAs per SM (one per SM measured
//     slower: two give each SM four consumer warpgroups whose chains
//     overlap), walking 128-row tiles grid-stride, so the weights are staged
//     once per CTA;
//   - a producer warpgroup (registers cut to PRODUCER_REGS with setmaxnreg:
//     wgmma kernels are allocated by warpgroup, so a lone producer warp would
//     cap the consumers). Its first warp keeps x in flight with cp.async.bulk
//     (a tile is 128 x din f32 at a 16-byte aligned offset) into a
//     STAGES-deep mbarrier ring. It asks for the first tile at once, while
//     the consumers stage the weights, and for the rest once they hold them:
//     the weights' loads would otherwise queue behind every SM's whole ring.
//     A ragged last tile is copied in bulk up to its last 16-byte block, the
//     rest and the zero rows by lanes. Its second warp writes the output;
//   - the consumers stage the weights coalesced (each thread reads 8 k of
//     one output column, a warp whole rows of w, all loads before the first
//     store) as bf16 K-major B tiles in the 128-byte swizzle, [64][64] for
//     w1 and w2 and [8 or 16][64] for w3;
//   - two consumer warpgroups, 64 rows of each tile each, walking on their
//     own: no barrier across warpgroups inside the walk. Each warp rounds its
//     16 landed f32 rows to bf16 pairs in a padded warp-private block (a
//     half-warp a row, so the two half-warps' loads fall on distinct banks at
//     the odd 124-byte row stride), frees the ring stage and loads its A
//     fragments from the block. The chain is three wgmma products with A in
//     registers, m64n64k32, m64n64k64 and m64n8k64 (dout padded to 8): bias,
//     ReLU and bf16 rounding turn each accumulator into the next product's A
//     fragment, which is the m16k16 fragment layout;
//   - each warpgroup stages its 64 x dout f32 output rows in shared memory
//     (two buffers, in turn) and hands them over on an mbarrier; the store
//     warp writes them with one bulk store and frees the buffer once the
//     store has read it, so no consumer waits on a store. A ragged last
//     block is stored by the store warp's lanes.
// x and out must be 16-byte aligned (the wrapper checks): a full tile of x,
// and 64 rows of out, are then whole multiples of 16 bytes at 16-byte
// aligned addresses.
//
// The density net (tiny_mlp_fwd_kernel) keeps the mma.sync design, which
// reads 60 % of its bytes bound at the render shape: a CTA stages the weights
// (bf16, transposed to [out][in]) once and walks 128-row tiles grid-stride;
// each of its 8 warps owns 16 rows of a tile for the whole chain, copies its
// 16 x din block of x to a warp-private bf16 buffer and reads it back as
// mma A fragments, and from there the hidden activations never leave
// registers: the f32 accumulator fragment of two neighbouring n-tiles of
// mma.sync m16n8k16 is, after bias, ReLU and rounding, the A fragment of one
// k-step of the next layer. The colour net's design keeps from it the
// in-kernel zero padding, the rounding points and that register-to-register
// chain, which need no shared-memory round trip for the hidden layers.

#include <limits.h>

#include "mma_sync.cuh"
#include "tiny_mlp_sm90.cuh"

namespace {

// ------------------------------------------- density net: mma.sync design

namespace tiny {

using namespace tinyw;  // KIN, HID, ROWS, LDI, sm_count

constexpr int WARPS = 8;     // 16 rows each
constexpr int NTHREADS = 32 * WARPS;
constexpr int LDH = HID + 8; // shared row stride of the hidden layer (bf16), as LDI

// dst[o][k] = bf16(w[k][o]) for a f32 [kin, nout] row-major matrix, padded
// with zeros to [NP][KP]; dst row stride LD.
template <int KP, int NP, int LD>
__device__ __forceinline__ void stage_weight(const float* __restrict__ w, int kin, int nout,
                                             bf16* dst) {
  for (int i = threadIdx.x; i < KP * NP; i += NTHREADS) {
    const int k = i / NP, o = i % NP;
    const float val = (k < kin && o < nout) ? __ldg(w + (size_t)k * nout + o) : 0.f;
    dst[o * LD + k] = __float2bfloat16_rn(val);
  }
}

template <int NP>
__device__ __forceinline__ void stage_bias(const float* __restrict__ b, int nout, float* dst) {
  for (int i = threadIdx.x; i < NP; i += NTHREADS) dst[i] = i < nout ? __ldg(b + i) : 0.f;
}

// acc[nt] += A (KS k-steps of register fragments) @ W[nt*8 .. nt*8+8, :]^T.
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

// a = bf16(relu(acc + bias)) as the next layer's A fragments: n-tiles 2ks and
// 2ks+1 of the accumulator are columns 16ks..16ks+15, one k-step.
__device__ __forceinline__ void relu_pack(const float (&acc)[HID / 8][4], const float* bias,
                                          uint32_t (&a)[HID / 16][4], int lane) {
  const int tg = lane & 3;
#pragma unroll
  for (int ks = 0; ks < HID / 16; ++ks)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nt = 2 * ks + half;
      const float b0 = bias[nt * 8 + tg * 2], b1 = bias[nt * 8 + tg * 2 + 1];
      a[ks][half * 2 + 0] =
          pack_bf16(fmaxf(acc[nt][0] + b0, 0.f), fmaxf(acc[nt][1] + b1, 0.f));  // row g
      a[ks][half * 2 + 1] =
          pack_bf16(fmaxf(acc[nt][2] + b0, 0.f), fmaxf(acc[nt][3] + b1, 0.f));  // row g + 8
    }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// One hidden layer, output padded to NOUT (8 or 16) columns.
template <int NOUT>
__global__ void __launch_bounds__(NTHREADS)
    tiny_mlp_fwd_kernel(const float* __restrict__ x, int din, long long n,
                        const float* __restrict__ w1, const float* __restrict__ b1, int h1,
                        const float* __restrict__ wo, const float* __restrict__ bo, int dout,
                        float* __restrict__ out) {
  // bf16 storage, declared as raw 16-bit words
  __shared__ __align__(16) unsigned short w1raw[HID * LDI];
  __shared__ __align__(16) unsigned short woraw[NOUT * LDH];
  __shared__ __align__(16) unsigned short xraw[WARPS * 16 * LDI];
  __shared__ float b1s[HID], bos[NOUT];
  bf16* w1s = reinterpret_cast<bf16*>(w1raw);
  bf16* wos = reinterpret_cast<bf16*>(woraw);

  stage_weight<KIN, HID, LDI>(w1, din, h1, w1s);
  stage_bias<HID>(b1, h1, b1s);
  stage_weight<HID, NOUT, LDH>(wo, h1, dout, wos);
  stage_bias<NOUT>(bo, dout, bos);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  bf16* xw = reinterpret_cast<bf16*>(xraw) + warp * 16 * LDI;  // warp-private
  const long long ntiles = (n + ROWS - 1) / ROWS;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * ROWS + warp * 16;  // this warp's first row
    // the warp's 16 x din block of x, rounded to bf16; pad columns and rows
    // past n read as zero
#pragma unroll
    for (int i = lane; i < 16 * KIN; i += 32) {
      const int r = i / KIN, c = i % KIN;
      const float val = (r0 + r < n && c < din) ? __ldg(x + (r0 + r) * din + c) : 0.f;
      xw[r * LDI + c] = __float2bfloat16_rn(val);
    }
    __syncwarp();
    uint32_t ax[KIN / 16][4];
#pragma unroll
    for (int ks = 0; ks < KIN / 16; ++ks) {
      const bf16* ap = xw + g * LDI + ks * 16 + tg * 2;
      ax[ks][0] = lds32(ap);
      ax[ks][1] = lds32(ap + 8 * LDI);
      ax[ks][2] = lds32(ap + 8);
      ax[ks][3] = lds32(ap + 8 * LDI + 8);
    }
    __syncwarp();  // xw is free for the next tile

    float acc[HID / 8][4];
    uint32_t ah[HID / 16][4];
    zero_acc(acc);
    layer<HID / 8, KIN / 16, LDI>(acc, ax, w1s, lane);
    relu_pack(acc, b1s, ah, lane);
    float o[NOUT / 8][4];
    zero_acc(o);
    layer<NOUT / 8, HID / 16, LDH>(o, ah, wos, lane);

#pragma unroll
    for (int nt = 0; nt < NOUT / 8; ++nt) {
      const int c = nt * 8 + tg * 2;  // this lane holds columns c, c + 1
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = r0 + g + 8 * half;
        if (r < n) {
          if (c < dout) out[r * dout + c] = o[nt][2 * half] + bos[c];
          if (c + 1 < dout) out[r * dout + c + 1] = o[nt][2 * half + 1] + bos[c + 1];
        }
      }
    }
  }
}

cudaError_t launch(const float* x, int din, long long n, const float* w1, const float* b1, int h1,
                   const float* wo, const float* bo, int dout, float* out, cudaStream_t stream) {
  if (din < 1 || din > KIN || h1 < 1 || h1 > HID || dout < 1 || dout > 16 || n < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + ROWS - 1) / ROWS;
  const long long cap = (long long)sms * 4;  // CTAs walk the tiles grid-stride
  const unsigned blocks = (unsigned)(ntiles < cap ? ntiles : cap);
  if (dout <= 8)
    tiny_mlp_fwd_kernel<8><<<blocks, NTHREADS, 0, stream>>>(x, din, n, w1, b1, h1, wo, bo, dout, out);
  else
    tiny_mlp_fwd_kernel<16><<<blocks, NTHREADS, 0, stream>>>(x, din, n, w1, b1, h1, wo, bo, dout, out);
  return cudaGetLastError();
}

}  // namespace tiny

// --------------------------------------------- colour net: wgmma design

namespace tinyf {

using namespace tinyw;  // widths, thread layout, product, load_a, sm_count

constexpr int CTAS_PER_SM = 2;
constexpr int STAGES = 2;  // x tiles in flight per CTA
// registers a thread after setmaxnreg (multiples of 8): what the producer
// warpgroup gives up the consumers take, within the CTA's launch allocation
// (65,536 registers an SM shared by CTAS_PER_SM CTAs of THREADS threads)
constexpr int LAUNCH_REGS = 65536 / (THREADS * CTAS_PER_SM) / 8 * 8;
constexpr int PRODUCER_REGS = 48;
constexpr int CONSUMER_REGS = (THREADS * LAUNCH_REGS - 128 * PRODUCER_REGS) / CONSUMERS / 8 * 8;

// Byte offsets of the shared-memory regions (base 1024-aligned).
template <int NOUT>
struct Smem {
  // weight tiles B [N][K], K-major, (n, k) = w[k][n]
  static constexpr int W1 = 0;                    // [64][64] (din <= 32 of K used)
  static constexpr int W2 = W1 + WTILE;           // [64][64]
  static constexpr int W3 = W2 + WTILE;           // [NOUT][64]
  static constexpr int B1 = W3 + NOUT * 128;      // f32 b1, b2, b3
  static constexpr int B2 = B1 + HID * 4;
  static constexpr int B3 = B2 + HID * 4;
  // full[STAGES], empty[STAGES] of the ring; ofull[4], oempty[4] of the out
  // sets ([wg][set])
  static constexpr int BARS = B3 + NOUT * 4;
  static constexpr int RING = align1k(BARS + (2 * STAGES + 8) * 8);
  static constexpr int STAGE = ROWS * KIN * 4;    // a stage's x (row stride din)
  static constexpr int OUT_BUF = WG_ROWS * NOUT * 4;  // f32 [64][dout]
  static constexpr int OUTS = RING + STAGES * STAGE;  // [wg][2 sets]
  static constexpr int XW = OUTS + 4 * OUT_BUF;       // [8 warps][16][LDI] bf16
  static constexpr int BYTES = XW + 8 * 16 * LDI * 2 + 1024;  // + alignment slack
};

// The producer warp waits, the consumers only arrive: named barrier 4 (0 is
// __syncthreads, 3 the consumers').
__device__ __forceinline__ void weights_landed_sync() {
  asm volatile("bar.sync 4, %0;\n" ::"n"(CONSUMERS + 32) : "memory");
}
__device__ __forceinline__ void weights_landed_arrive() {
  asm volatile("bar.arrive 4, %0;\n" ::"n"(CONSUMERS + 32) : "memory");
}

// Weight tile [NP][64] (bf16, K-major, 128-byte swizzle): (n, k) = w[k][n] of
// a f32 [kv][nv] row-major w, zero for n >= nv or k >= kv. Consumer thread t
// takes the 16-byte chunks (n, 8c .. 8c + 7) with n + NP c = t + CONSUMERS j:
// a warp's loads of one k read 32 neighbouring floats of a row of w, its
// chunk stores fall on distinct banks. Loads first, stores after, so that
// every load of every weight is in flight at once.
template <int NP>
struct WeightChunks {
  static constexpr int ITEMS = NP * 8, PER_THREAD = (ITEMS + CONSUMERS - 1) / CONSUMERS;
  float v[PER_THREAD][8];

  __device__ __forceinline__ void load(const float* __restrict__ w, int kv, int nv, int t) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = t + CONSUMERS * j, nn = i % NP, k0 = i / NP * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[j][e] = i < ITEMS && nn < nv && k0 + e < kv ? __ldg(w + (size_t)(k0 + e) * nv + nn) : 0.f;
    }
  }

  __device__ __forceinline__ void store(unsigned char* dst, int t) const {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = t + CONSUMERS * j;
      if (i < ITEMS)
        *reinterpret_cast<uint4*>(dst + swz(i % NP, i / NP * 8)) =
            make_uint4(pack_bf16(v[j][0], v[j][1]), pack_bf16(v[j][2], v[j][3]),
                       pack_bf16(v[j][4], v[j][5]), pack_bf16(v[j][6], v[j][7]));
    }
  }
};

// The warp's 16 landed f32 rows (row stride d <= KIN) rounded to bf16 into
// its row-major block w (stride LDI, columns >= d zero). Lane l takes columns
// 2 (l % 16) and + 1 of rows 2 i + l / 16: one 32-bit store a turn, and for
// an odd d (31: neighbouring rows d words apart) the loads of the two
// half-warps fall on distinct banks. All loads are issued before the first
// store (see fused_mlp_bwd.cu:stage_rows).
__device__ __forceinline__ void stage_x(const float* blk, int d, bf16* w, int lane) {
  const int c = 2 * (lane & 15), rr = lane >> 4;
  float v[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float* row = blk + (2 * i + rr) * d;
    v[i][0] = c < d ? row[c] : 0.f;
    v[i][1] = c + 1 < d ? row[c + 1] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<uint32_t*>(w + (2 * i + rr) * LDI + c) = pack_bf16(v[i][0], v[i][1]);
}

// a = bf16(relu(acc + bias)) as the next product's A fragments: n-tiles 2ks
// and 2ks+1 of the m64n64 accumulator are columns 16ks .. 16ks+15, one k16
// step (thread t holds rows g = t % 32 / 4 and g + 8 of its warp's 16,
// columns 8 nt + 2 (t % 4) and + 1 in acc[4 nt .. 4 nt + 3]). The ReLU is
// taken after the rounding, on bf16 pairs: rounding is monotonic and keeps
// 0, so relu(bf16(v)) = bf16(relu(v)).
__device__ __forceinline__ void relu_pack(const float (&acc)[HID / 2], const float* bias,
                                          uint32_t (&a)[HID / 16][4], int lane) {
  const int tg = lane & 3;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(bias + nt * 8 + tg * 2);
    const __nv_bfloat162 r0 = __hmax2(__floats2bfloat162_rn(acc[4 * nt] + b.x, acc[4 * nt + 1] + b.y), zero);
    const __nv_bfloat162 r1 = __hmax2(__floats2bfloat162_rn(acc[4 * nt + 2] + b.x, acc[4 * nt + 3] + b.y), zero);
    a[nt >> 1][(nt & 1) * 2 + 0] = *reinterpret_cast<const uint32_t*>(&r0);  // row g
    a[nt >> 1][(nt & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&r1);  // row g + 8
  }
}

// Two hidden layers, output padded to NOUT (8 or 16) columns.
template <int NOUT>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
    tiny_mlp3_fwd_kernel(const float* __restrict__ x, int din, long long n,
                         const float* __restrict__ w1, const float* __restrict__ b1, int h1,
                         const float* __restrict__ w2, const float* __restrict__ b2, int h2,
                         const float* __restrict__ w3, const float* __restrict__ b3, int dout,
                         float* __restrict__ out) {
  using S = Smem<NOUT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw_u32 + 1023) & ~1023u) - raw_u32);
  const uint32_t base = smem_u32(sm);
  const uint32_t full = base + S::BARS, empty = full + STAGES * 8;
  const uint32_t ofull = empty + STAGES * 8, oempty = ofull + 4 * 8;
  const int ntiles = (int)((n + ROWS - 1) / ROWS);  // the launch checks that it fits
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    for (int b = 0; b < 4; ++b) {
      mbar_init(ofull + 8 * b, 4);  // the warps of a warpgroup
      mbar_init(oempty + 8 * b, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // the producer warpgroup gives its registers to the consumers
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 + 1) {
      // its second warp writes each warpgroup's staged out rows with bulk
      // stores
      const uint64_t normal = l2_normal();
      for (int tile = blockIdx.x, k = 0; tile < ntiles; tile += gridDim.x, ++k) {
        for (int wg = 0; wg < 2; ++wg) {
          const int b = wg * 2 + (k & 1);
          mbar_wait(ofull + 8 * b, (uint32_t)((k >> 1) & 1));
          const long long r0 = (long long)tile * ROWS + wg * WG_ROWS;
          const float* os = reinterpret_cast<const float*>(sm + S::OUTS + b * S::OUT_BUF);
          if (r0 + WG_ROWS <= n) {
            if (lane == 0) bulk_store(out + r0 * dout, smem_u32(os), WG_ROWS * dout * 4, normal);
          } else if (r0 < n) {  // a ragged last block, by lanes
            const int valid = (int)(n - r0) * dout;
            for (int i = lane; i < valid; i += 32) out[r0 * dout + i] = os[i];
          }
          if (lane == 0) bulk_store_wait_read();
          __syncwarp();
          if (lane == 0) mbar_arrive(oempty + 8 * b);
        }
      }
      if (lane == 0) bulk_store_wait_all();
      return;
    }
    if (warp != CONSUMERS / 32) return;
    // its first warp brings x of each tile into the ring: the first tile at
    // once, the rest once the consumers hold the weights (their loads would
    // queue behind the whole ring's)
    const uint64_t stream = l2_stream();
    int k = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
      if (k == 1) weights_landed_sync();
      const int s = k % STAGES;
      const uint32_t fb = full + 8 * s;
      float* xs = reinterpret_cast<float*>(sm + S::RING + s * S::STAGE);
      mbar_wait(empty + 8 * s, (uint32_t)((k / STAGES) & 1) ^ 1u);
      const long long r0 = (long long)tile * ROWS;
      const int rows = (int)(n - r0 < ROWS ? n - r0 : ROWS);
      if (rows == ROWS) {
        if (lane == 0) {
          mbar_expect_tx(fb, ROWS * din * 4);
          bulk_load(smem_u32(xs), x + r0 * din, ROWS * din * 4, fb, stream);
        }
      } else {  // the ragged last tile: its 16-byte blocks in bulk, the rest and zero rows by lanes
        const int bulk = rows * din / 4 * 4;
        for (int i = bulk + lane; i < ROWS * din; i += 32) xs[i] = i < rows * din ? __ldg(x + r0 * din + i) : 0.f;
        __syncwarp();
        if (lane == 0) {
          if (bulk > 0) {
            mbar_expect_tx(fb, bulk * 4);
            bulk_load(smem_u32(xs), x + r0 * din, bulk * 4, fb, stream);
          } else {
            mbar_arrive(fb);
          }
        }
      }
      __syncwarp();
    }
    if (k <= 1) weights_landed_sync();
    return;
  }

  // consumers: stage the weights and biases while the first tiles land
  setmaxnreg_inc<CONSUMER_REGS>();
  {
    const int tc = threadIdx.x;
    WeightChunks<HID> c1, c2;
    WeightChunks<NOUT> c3;
    c1.load(w1, din, h1, tc);
    c2.load(w2, h1, h2, tc);
    c3.load(w3, h2, dout, tc);
    const float bias = tc < HID           ? (tc < h1 ? __ldg(b1 + tc) : 0.f)
                       : tc < 2 * HID     ? (tc - HID < h2 ? __ldg(b2 + tc - HID) : 0.f)
                       : tc < 2 * HID + NOUT ? (tc - 2 * HID < dout ? __ldg(b3 + tc - 2 * HID) : 0.f)
                                            : 0.f;
    c1.store(sm + S::W1, tc);
    c2.store(sm + S::W2, tc);
    c3.store(sm + S::W3, tc);
    if (tc < 2 * HID + NOUT) reinterpret_cast<float*>(sm + S::B1)[tc] = bias;  // b1 | b2 | b3
    weights_landed_arrive();
    fence_async_shared();  // the weight tiles, for wgmma
    consumer_sync();
  }
  const float* b1s = reinterpret_cast<const float*>(sm + S::B1);
  const float* b2s = reinterpret_cast<const float*>(sm + S::B2);
  const float* b3s = reinterpret_cast<const float*>(sm + S::B3);
  const uint64_t w1d = desc_kmajor(base + S::W1), w2d = desc_kmajor(base + S::W2);
  const uint64_t w3d = desc_kmajor(base + S::W3);

  // warpgroup wg owns rows 64 wg .. 64 wg + 63 of every tile
  const int wg = warp >> 2;
  const int rw = (warp & 3) * 16;  // this warp's first row inside the warpgroup's 64
  const int g = lane >> 2, tg = lane & 3;
  bf16* xw = reinterpret_cast<bf16*>(sm + S::XW) + warp * 16 * LDI;
  for (int tile = blockIdx.x, k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    const int s = k % STAGES;
    const float* xs = reinterpret_cast<const float*>(sm + S::RING + s * S::STAGE) + (wg * WG_ROWS + rw) * din;
    mbar_wait(full + 8 * s, (uint32_t)((k / STAGES) & 1));
    stage_x(xs, din, xw, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    uint32_t ax[KIN / 16][4];
    load_a<KIN / 16, LDI>(ax, xw, lane);
    __syncwarp();  // xw is free for the next tile

    float acc[HID / 2];
    uint32_t ah[HID / 16][4];
    product(acc, ax, w1d);
    relu_pack(acc, b1s, ah, lane);
    product(acc, ah, w2d);
    relu_pack(acc, b2s, ah, lane);
    float o[NOUT / 2];
    product(o, ah, w3d);

    // out rows into this warpgroup's staging buffer (f32 [64][dout], as in
    // global memory; two a warpgroup, in turn), handed to the store warp
    const int b = wg * 2 + (k & 1);
    mbar_wait(oempty + 8 * b, (uint32_t)((k >> 1) & 1) ^ 1u);
    float* os = reinterpret_cast<float*>(sm + S::OUTS + b * S::OUT_BUF);
#pragma unroll
    for (int nt = 0; nt < NOUT / 8; ++nt) {
      const int c = nt * 8 + tg * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* row = os + (rw + g + 8 * half) * dout;
        if (c < dout) row[c] = o[4 * nt + 2 * half] + b3s[c];
        if (c + 1 < dout) row[c + 1] = o[4 * nt + 2 * half + 1] + b3s[c + 1];
      }
    }
    fence_async_shared();  // the out rows, for the bulk store
    __syncwarp();
    if (lane == 0) mbar_arrive(ofull + 8 * b);
  }
}

template <int NOUT>
cudaError_t launch_kernel(unsigned blocks, cudaStream_t stream, const float* x, int din, long long n,
                          const float* w1, const float* b1, int h1, const float* w2, const float* b2,
                          int h2, const float* w3, const float* b3, int dout, float* out) {
  auto kernel = tiny_mlp3_fwd_kernel<NOUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<NOUT>::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, Smem<NOUT>::BYTES, stream>>>(x, din, n, w1, b1, h1, w2, b2, h2, w3, b3,
                                                         dout, out);
  return cudaGetLastError();
}

cudaError_t launch(const float* x, int din, long long n, const float* w1, const float* b1, int h1,
                   const float* w2, const float* b2, int h2, const float* w3, const float* b3,
                   int dout, float* out, cudaStream_t stream) {
  if (din < 1 || din > KIN || h1 < 1 || h1 > HID || h2 < 1 || h2 > HID || dout < 1 || dout > 16 ||
      n < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (((uintptr_t)x | (uintptr_t)out) % 16 != 0) return cudaErrorMisalignedAddress;
  if ((n + ROWS - 1) / ROWS > INT_MAX / 2) return cudaErrorInvalidValue;  // tile indices are int
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + ROWS - 1) / ROWS;
  const long long cap = (long long)sms * CTAS_PER_SM;
  const unsigned blocks = (unsigned)(ntiles < cap ? ntiles : cap);
  return dout <= 8 ? launch_kernel<8>(blocks, stream, x, din, n, w1, b1, h1, w2, b2, h2, w3, b3, dout, out)
                   : launch_kernel<16>(blocks, stream, x, din, n, w1, b1, h1, w2, b2, h2, w3, b3, dout, out);
}

}  // namespace tinyf
}  // namespace

extern "C" {

const char* xr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Widest shapes the kernels take: din, hidden, dout.
int xr_fused_mlp_fwd_max_din() { return tinyw::KIN; }
int xr_fused_mlp_fwd_max_hidden() { return tinyw::HID; }
int xr_fused_mlp_fwd_max_dout() { return 16; }

// Dynamic shared memory of one colour-net CTA (bytes) at dout <= 8.
int xr_fused_mlp3_fwd_smem_bytes() { return tinyf::Smem<8>::BYTES; }

// out [n, dout] = relu(x [n, din] @ w1 [din, h] + b1) @ w2 [h, dout] + b2, all
// f32 row-major. Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launch (0 on success).
int xr_fused_mlp2_fwd(const float* x, int din, long long n, const float* w1, const float* b1,
                      int h, const float* w2, const float* b2, int dout, float* out,
                      void* stream) {
  return (int)tiny::launch(x, din, n, w1, b1, h, w2, b2, dout, out, (cudaStream_t)stream);
}

// out [n, dout] = relu(relu(x @ w1 [din, h1] + b1) @ w2 [h1, h2] + b2) @ w3
// [h2, dout] + b3; x and out 16-byte aligned.
int xr_fused_mlp3_fwd(const float* x, int din, long long n, const float* w1, const float* b1,
                      int h1, const float* w2, const float* b2, int h2, const float* w3,
                      const float* b3, int dout, float* out, void* stream) {
  return (int)tinyf::launch(x, din, n, w1, b1, h1, w2, b2, h2, w3, b3, dout, out,
                            (cudaStream_t)stream);
}

}  // extern "C"
