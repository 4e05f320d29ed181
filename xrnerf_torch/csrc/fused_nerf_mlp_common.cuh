// Shared pieces of the fused vanilla-NeRF MLP kernels (forward and
// backward) for Hopper (sm_90a). Included by fused_nerf_mlp_fwd.cu and
// fused_nerf_mlp_bwd.cu; each is its own translation unit, so everything
// here lives in an anonymous namespace.
//
// The engine both kernels repeat some thirty times per row tile is one
// 256-wide layer Out = act(In @ W^T + b) for 64 rows of one warpgroup:
//
//  - Products run on wgmma (m64nNk16, bf16 in, f32 accumulate). A warpgroup
//    owns 64 rows for the whole chain; its share of the m64n256 accumulator
//    (128 registers a thread), after bias, ReLU and rounding, is its share
//    of the next layer's register A operand (64 registers): activations
//    never touch shared memory between layers.
//  - Weights go through shared memory, loaded once per CTA: a producer
//    thread streams 32 KB slabs into a ring with cp.async.bulk, each
//    completing on an mbarrier; the consumer warps release a slot with an
//    mbarrier arrive once the wgmmas that read it have retired.
//  - The grid is persistent: at most one CTA per SM, CTA b walking row
//    tiles b, b + grid, ..., so the ring keeps streaming across tiles.
//  - The slabs are copied from the weight *image*: the pack's bf16 values
//    laid out in device memory block by block in exactly the 128-byte
//    swizzled order that wgmma's shared-memory descriptors read, so a
//    one-dimensional bulk copy suffices and no tensor map is needed
//    (xrnerf_torch/ops/fused_nerf_mlp.py:weight_image_index builds it).
//    Every matrix [O][I] is cut into blocks of 64 out x 64 in, 8 KB each:
//    row r of a block is 128 bytes, its 16-byte chunk q stored at chunk
//    q ^ (r % 8). Blocks are ordered in-chunk-major (c, then ob). Read
//    K-major (forward, K = in) the four blocks of one c are one contiguous
//    [256 out][64 k] slab; read MN-major (data gradients, K = out, the
//    transpose bit of the instruction) the four blocks of one ob are a
//    [64 k][256 n] slab, 8 KB pieces 32 KB apart. One image serves both.
//
// Pack layout (bf16 weights, each matrix [out, in] row-major, in this
// order; xrnerf_torch/ops/fused_nerf_mlp.py:_layout):
//   W0[256,64] W1..W4[256,256] W5h[256,256] W5x[256,64] W6 W7[256,256]
//   Wf[256,256] Wa[8,256] (row 0 = alpha) Wvf[128,256] Wvv[128,32]
//   Wrgb[8,128] (rows 0..2 = rgb)
// Bias layout (f32): b0..b7[256] bf[256] ba[8] bv[128] brgb[8].
// Image layout (bf16, in the forward's streaming order):
//   W0 W1..W4 W5h W5x W6 W7 Wa Wf Wvf Wvv(in padded to 64) Wrgb
// with the 8-row heads as [8][64] chunks of 1 KB.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int WIDTH = 256;
constexpr int HV = WIDTH / 2;
constexpr int PX = 64;  // posenc(pts) 63 -> 64
constexpr int PV = 32;  // posenc(dirs) 27 -> 32
constexpr int PVI = 64; // and -> 64 in the image and the shared tiles (one swizzle row)
constexpr int HEAD = 8; // alpha / rgb heads padded to one wgmma n-tile

constexpr int WG_ROWS = 64;           // rows of one consumer warpgroup
constexpr int CONSUMER_WGS = 2;
constexpr int TILE = WG_ROWS * CONSUMER_WGS;  // rows of one CTA tile
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMERS + 128;  // + the producer's warpgroup
constexpr int CONSUMER_WARPS = CONSUMERS / 32;

// Offsets into the pack (elements).
constexpr size_t WW = (size_t)WIDTH * WIDTH;
constexpr size_t OW0 = 0;
constexpr size_t OW1 = OW0 + (size_t)WIDTH * PX;
constexpr size_t OW2 = OW1 + WW;
constexpr size_t OW3 = OW2 + WW;
constexpr size_t OW4 = OW3 + WW;
constexpr size_t OW5H = OW4 + WW;
constexpr size_t OW5X = OW5H + WW;
constexpr size_t OW6 = OW5X + (size_t)WIDTH * PX;
constexpr size_t OW7 = OW6 + WW;
constexpr size_t OWF = OW7 + WW;
constexpr size_t OWA = OWF + WW;
constexpr size_t OWVF = OWA + (size_t)HEAD * WIDTH;
constexpr size_t OWVV = OWVF + (size_t)HV * WIDTH;
constexpr size_t OWRGB = OWVV + (size_t)HV * PV;
constexpr size_t OWEND = OWRGB + (size_t)HEAD * HV;

constexpr int OBF = 8 * WIDTH;
constexpr int OBA = OBF + WIDTH;
constexpr int OBV = OBA + HEAD;
constexpr int OBRGB = OBV + HV;
constexpr int OBEND = OBRGB + HEAD;

// Offsets into the image (bytes).
constexpr uint32_t BLOCK_BYTES = 64 * 128;  // one 64 x 64 bf16 block
constexpr uint32_t SLAB_BYTES = 4 * BLOCK_BYTES;
constexpr uint32_t IW0 = 0;
constexpr uint32_t IW1 = IW0 + SLAB_BYTES;
constexpr uint32_t IW5H = IW1 + 4 * 4 * SLAB_BYTES;
constexpr uint32_t IW5X = IW5H + 4 * SLAB_BYTES;
constexpr uint32_t IW6 = IW5X + SLAB_BYTES;
constexpr uint32_t IW7 = IW6 + 4 * SLAB_BYTES;
constexpr uint32_t IWA = IW7 + 4 * SLAB_BYTES;
constexpr uint32_t IWF = IWA + 4 * 1024;
constexpr uint32_t IWVF = IWF + 4 * SLAB_BYTES;
constexpr uint32_t IWVV = IWVF + 8 * BLOCK_BYTES;
constexpr uint32_t IWRGB = IWVV + 2 * BLOCK_BYTES;
constexpr uint32_t IWEND = IWRGB + 2 * 1024;

// ------------------------------------------------------- the slab ring

constexpr int MAX_COPIES = 4;
// One fill of a ring slot: `copies` bulk copies of `bytes` each, `stride`
// bytes apart in the image, packed back to back in the slot.
struct Slab {
  uint32_t off, bytes, stride, copies;
};
constexpr Slab slab_k(uint32_t off, uint32_t bytes = SLAB_BYTES) { return {off, bytes, 0, 1}; }
// MN-major slab ob of a matrix with `obs` row blocks and four in-chunks.
constexpr Slab slab_mn(uint32_t base, uint32_t ob, uint32_t obs) {
  return {base + ob * BLOCK_BYTES, BLOCK_BYTES, obs * BLOCK_BYTES, 4};
}

// Ring state of one thread: slot index and phase parity.
template <int STAGES>
struct Ring {
  uint32_t full, empty, data;  // shared addresses: full[STAGES], empty[STAGES], slots
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ uint32_t full_bar() const { return full + 8 * slot; }
  __device__ __forceinline__ uint32_t empty_bar() const { return empty + 8 * slot; }
  __device__ __forceinline__ uint32_t addr() const { return data + slot * SLAB_BYTES; }
  __device__ __forceinline__ void advance() {
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Row tiles of `n` rows that this CTA walks: tiles blockIdx.x, + gridDim.x, ...
__device__ __forceinline__ long long cta_tiles(long long n) {
  const long long tiles = (n + TILE - 1) / TILE;
  return blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
}

// The producer thread: for each of `tiles` row tiles, stream the N slabs of
// `seq` through the ring.
template <int STAGES, int N>
__device__ __forceinline__ void produce(Ring<STAGES> ring, const Slab (&seq)[N],
                                        const unsigned char* __restrict__ image, long long tiles) {
  const uint64_t keep = l2_keep();
  ring.phase = 1;  // every slot starts empty
  for (long long t = 0; t < tiles; ++t) {
    for (int i = 0; i < N; ++i) {
      const Slab s = seq[i];
      mbar_wait(ring.empty_bar(), ring.phase);
      mbar_expect_tx(ring.full_bar(), s.bytes * s.copies);
      for (uint32_t c = 0; c < s.copies; ++c)
        bulk_load(ring.addr() + c * s.bytes, image + s.off + c * s.stride, s.bytes, ring.full_bar(),
                  keep);
      ring.advance();
    }
  }
}

// Consumer side of one slab: consume_begin waits for it and opens a wgmma
// group; the caller issues the products that read ring.addr(); consume_end
// commits the group and releases the slot of the slab before (whose group
// has then retired). `prev` is that slot's empty barrier, or 0 for none.
template <int STAGES>
__device__ __forceinline__ void consume_begin(const Ring<STAGES>& ring) {
  mbar_wait(ring.full_bar(), ring.phase);
  wgmma_fence();
}
template <int STAGES>
__device__ __forceinline__ void consume_end(Ring<STAGES>& ring, uint32_t& prev, int lane) {
  wgmma_commit();
  if (prev) {
    wgmma_wait<1>();
    if (lane == 0) mbar_arrive(prev);
  }
  prev = ring.empty_bar();
  ring.advance();
}

// All of this warpgroup's wgmmas have retired: release the last slot.
__device__ __forceinline__ void drain(uint32_t& prev, int lane) {
  wgmma_wait<0>();
  if (prev && lane == 0) mbar_arrive(prev);
  prev = 0;
}

// -------------------------------------------------- products on a slab

// acc (+)= A[:, 16 K0 .. 16 (K0 + 4)) @ slab with A in registers (k16
// fragments); the slab K-major ([256 out][64 k]) or, TB = 1, MN-major
// ([64 k][256 in], four panels of 8 KB).
template <int TB, int K0, int NA>
__device__ __forceinline__ void mma_rs256(float (&acc)[128], const uint32_t (&a)[NA][4],
                                          uint32_t slab, bool first) {
  const uint64_t d = TB ? desc_mnmajor(slab, BLOCK_BYTES) : desc_kmajor(slab);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_rs_n256<TB>(acc, a[K0 + k], d + k * (TB ? KSTEP_MNMAJOR : KSTEP_KMAJOR),
                      !(first && k == 0));
}

// acc (+)= T @ slab^T with T a [64][64] K-major shared tile (descriptor
// `adesc`) and the slab K-major [256 out][64 k].
__device__ __forceinline__ void mma_ss256(float (&acc)[128], uint64_t adesc, uint32_t slab,
                                          bool first) {
  const uint64_t d = desc_kmajor(slab);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_ss_n256<0, 0>(acc, adesc + k * KSTEP_KMAJOR, d + k * KSTEP_KMAJOR, !(first && k == 0));
}

// One 256-deep, 256-wide product over four slabs of the ring:
// acc (+)= A @ W^T (TB = 0, the forward) or A @ W (TB = 1, data gradients).
template <int TB, int STAGES>
__device__ __forceinline__ void layer_rs(float (&acc)[128], uint32_t (&a)[16][4],
                                         Ring<STAGES>& ring, uint32_t& prev, int lane,
                                         bool first) {
  pin(a);
  consume_begin(ring);
  mma_rs256<TB, 0>(acc, a, ring.addr(), first);
  consume_end(ring, prev, lane);
  consume_begin(ring);
  mma_rs256<TB, 4>(acc, a, ring.addr(), false);
  consume_end(ring, prev, lane);
  consume_begin(ring);
  mma_rs256<TB, 8>(acc, a, ring.addr(), false);
  consume_end(ring, prev, lane);
  consume_begin(ring);
  mma_rs256<TB, 12>(acc, a, ring.addr(), false);
  consume_end(ring, prev, lane);
}

// The accumulator fragment (rows g, g + 8; columns 8 j + 2 tg, + 1 of
// n-tile j) after bias, optional ReLU and rounding is the next product's
// register A operand: n-tiles 2 k and 2 k + 1 make k16 fragment k.
template <bool RELU>
__device__ __forceinline__ void epilogue(const float (&acc)[128], const float* bias,
                                         uint32_t (&a)[16][4], int tg) {
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
    a[j >> 1][(j & 1) * 2 + 0] = pack_bf16(v0, v1);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(v2, v3);
  }
}

// Round the 64 rows from row0 of a [n, d] f32 matrix (d <= 64) into a
// [64][64] bf16 tile (rows of 128 bytes, swizzled), thread t of 128: rows
// >= n read as zero; columns >= d are not written (the tile starts zeroed).
// Elements are walked in memory order, so the reads coalesce.
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, int d, long long n,
                                           long long row0, unsigned char* dst, int t) {
  const float* p = src + row0 * d;
  const long long avail = (n - row0) * (long long)d;  // elements of rows < n from row0 on
  const int total = WG_ROWS * d, dr = 128 / d, dc = 128 % d;
  int r = t / d, c = t % d;
  for (int i = t; i < total; i += 128) {
    const float val = i < avail ? __ldg(p + i) : 0.f;
    *reinterpret_cast<bf16*>(dst + swz(r, c)) = __float2bfloat16_rn(val);
    r += dr;
    c += dc;
    if (c >= d) {
      c -= d;
      ++r;
    }
  }
}

// ------------------------------------------------------------ host side

// SM count of the current device: the most CTAs of a persistent grid.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace
