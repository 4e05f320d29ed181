// Fused vanilla-NeRF MLP forward for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel xrnerf_tpu/ops/pallas/fused_nerf_mlp.py:
// _fwd_kernel (:150) over _trunk_forward (:112-147), launched by
// _fused_core_fwd_impl (pallas_call at :321) under fused_nerf_mlp (:382).
//
// What it computes, per row (x: posenc of a point, v: posenc of its view
// direction; both f32 in global memory, read and rounded to bf16 here):
//   h0 = relu(x@W0 + b0); h1..h4 = relu(h@Wi + bi)
//   h5 = relu(h4@W5h + x@W5x + b5)       (the skip concat as split matmuls)
//   h6, h7 as h1
//   feat = h7@Wf + bf (bf16), sigma = h7@Wa + ba (read from f32)
//   v1 = relu(feat@Wvf + v@Wvv + bv)     (width/2 = 128)
//   rgb = v1@Wrgb + brgb                  (f32)
// Numerics are _trunk_forward's: bf16 operands, f32 accumulation, f32 biases
// added into the accumulators, every hidden h / feat / v1 rounded to bf16
// (round to nearest even) after its epilogue, sigma and rgb kept in f32.
//
// What bounds it: operations. Useful work is 593,408 MACs = 1.187 MFLOP per
// row against ~376 bytes of row input/output, ~3,000 FLOP per byte, ten
// times the H100's ~295 FLOP/B ridge. What can hold it below that bound is
// the weights: 1.2 MB of bf16 do not fit in an SM's 227 KB, so every row
// tile streams them again out of the L2.
//
// Design (the engine is described in fused_nerf_mlp_common.cuh): a
// persistent grid, one CTA per SM walking over 128-row tiles. Two consumer
// warpgroups own 64 rows each for the whole chain; products run on wgmma
// with the hidden activations as register A operands, so between layers
// they stay in registers (accumulator fragment -> bias, ReLU, bf16 -> next
// A fragment). A producer thread streams the weight image through a
// four-slot ring of 32 KB slabs in shared memory with cp.async.bulk and
// mbarriers; both warpgroups read each slab once, so a tile costs one pass
// over the weights (9.3 KB per row out of the L2) instead of one per warp,
// and the ring keeps streaming across tiles. x and v are rounded into small
// swizzled shared tiles (A operands read through descriptors: layer 0, the
// skip layer, the view layer); biases sit in shared memory for the kernel's
// life. The ragged last tile is masked: rows >= n read as zero and are
// never stored. None of the TPU kernel's shape is carried over (2048-row
// tiles with all weights resident in one core's VMEM).

#include "fused_nerf_mlp_common.cuh"

namespace {

constexpr int STAGES = 4;
constexpr uint32_t SM_RING = 0;
constexpr uint32_t SM_XT = SM_RING + STAGES * SLAB_BYTES;  // [2][64][128 B]
constexpr uint32_t SM_VT = SM_XT + CONSUMER_WGS * BLOCK_BYTES;
constexpr uint32_t SM_BIAS = SM_VT + CONSUMER_WGS * BLOCK_BYTES;
constexpr uint32_t SM_BARS = SM_BIAS + ((OBEND * 4 + 15) / 16) * 16;
constexpr uint32_t SM_END = SM_BARS + 2 * STAGES * 8;
constexpr size_t SMEM_BYTES = SM_END + 1024;  // + room to align the base to 1024

// The slabs of one tile, in the order the consumers read them.
__constant__ Slab FWD_SEQ[] = {
    slab_k(IW0),
    slab_k(IW1 + 0 * SLAB_BYTES), slab_k(IW1 + 1 * SLAB_BYTES), slab_k(IW1 + 2 * SLAB_BYTES), slab_k(IW1 + 3 * SLAB_BYTES),
    slab_k(IW1 + 4 * SLAB_BYTES), slab_k(IW1 + 5 * SLAB_BYTES), slab_k(IW1 + 6 * SLAB_BYTES), slab_k(IW1 + 7 * SLAB_BYTES),
    slab_k(IW1 + 8 * SLAB_BYTES), slab_k(IW1 + 9 * SLAB_BYTES), slab_k(IW1 + 10 * SLAB_BYTES), slab_k(IW1 + 11 * SLAB_BYTES),
    slab_k(IW1 + 12 * SLAB_BYTES), slab_k(IW1 + 13 * SLAB_BYTES), slab_k(IW1 + 14 * SLAB_BYTES), slab_k(IW1 + 15 * SLAB_BYTES),
    slab_k(IW5H + 0 * SLAB_BYTES), slab_k(IW5H + 1 * SLAB_BYTES), slab_k(IW5H + 2 * SLAB_BYTES), slab_k(IW5H + 3 * SLAB_BYTES),
    slab_k(IW5X),
    slab_k(IW6 + 0 * SLAB_BYTES), slab_k(IW6 + 1 * SLAB_BYTES), slab_k(IW6 + 2 * SLAB_BYTES), slab_k(IW6 + 3 * SLAB_BYTES),
    slab_k(IW7 + 0 * SLAB_BYTES), slab_k(IW7 + 1 * SLAB_BYTES), slab_k(IW7 + 2 * SLAB_BYTES), slab_k(IW7 + 3 * SLAB_BYTES),
    slab_k(IWA, 4 * 1024),
    slab_k(IWF + 0 * SLAB_BYTES), slab_k(IWF + 1 * SLAB_BYTES), slab_k(IWF + 2 * SLAB_BYTES), slab_k(IWF + 3 * SLAB_BYTES),
    slab_k(IWVF), slab_k(IWVF + SLAB_BYTES),
    slab_k(IWVV, 2 * BLOCK_BYTES),
    slab_k(IWRGB, 2 * 1024),
};

__global__ void __launch_bounds__(THREADS, 1)
    fused_nerf_mlp_fwd_kernel(const float* __restrict__ x, int dx, const float* __restrict__ v,
                              int dv, long long n, const unsigned char* __restrict__ image,
                              const float* __restrict__ Bp, float* __restrict__ rgb,
                              float* __restrict__ sigma) {
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
    if (threadIdx.x == CONSUMERS) produce(ring, FWD_SEQ, image, my_tiles);
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5;
    const int g = lane >> 2, tg = lane & 3;
    unsigned char* xt = sm + SM_XT + wg * BLOCK_BYTES;
    unsigned char* vt = sm + SM_VT + wg * BLOCK_BYTES;
    const uint64_t xdesc = desc_kmajor(base + SM_XT + wg * BLOCK_BYTES);
    const uint64_t vdesc = desc_kmajor(base + SM_VT + wg * BLOCK_BYTES);
    uint32_t prev = 0;

    for (long long i = 0; i < my_tiles; ++i) {
      const long long tile = blockIdx.x + i * gridDim.x;
      const long long row0 = tile * TILE + wg * WG_ROWS;
      stage_tile(x, dx, n, row0, xt, t);
      stage_tile(v, dv, n, row0, vt, t);
      fence_async_shared();
      wg_sync(wg);

      float acc[128];
      uint32_t a[16][4];

      // h0 = relu(x @ W0 + b0)
      consume_begin(ring);
      mma_ss256(acc, xdesc, ring.addr(), true);
      consume_end(ring, prev, lane);
      drain(prev, lane);
      pin(acc);
      epilogue<true>(acc, bias + 0 * WIDTH, a, tg);

      // h1..h4
#pragma unroll 1
      for (int l = 1; l <= 4; ++l) {
        layer_rs<0>(acc, a, ring, prev, lane, true);
        drain(prev, lane);
        pin(acc);
        epilogue<true>(acc, bias + l * WIDTH, a, tg);
      }

      // h5 = relu(h4 @ W5h + x @ W5x + b5)
      layer_rs<0>(acc, a, ring, prev, lane, true);
      consume_begin(ring);
      mma_ss256(acc, xdesc, ring.addr(), false);
      consume_end(ring, prev, lane);
      drain(prev, lane);
      pin(acc);
      epilogue<true>(acc, bias + 5 * WIDTH, a, tg);

      // h6, h7
#pragma unroll 1
      for (int l = 6; l <= 7; ++l) {
        layer_rs<0>(acc, a, ring, prev, lane, true);
        drain(prev, lane);
        pin(acc);
        epilogue<true>(acc, bias + l * WIDTH, a, tg);
      }

      // sigma = h7 @ Wa + ba (f32, column 0 of an n8 tile); feat = bf16(h7 @ Wf + bf)
      float sacc[4];
      pin(a);
      consume_begin(ring);
#pragma unroll
      for (int k = 0; k < 16; ++k)
        wgmma_rs_n8<0>(sacc, a[k], desc_kmajor(ring.addr() + (k >> 2) * 1024) + (k & 3) * KSTEP_KMAJOR,
                       k > 0);
      consume_end(ring, prev, lane);
      layer_rs<0>(acc, a, ring, prev, lane, true);
      drain(prev, lane);
      pin(acc);
      pin(sacc);
      if (tg == 0) {
        const long long r = row0 + warp * 16 + g;
        const float ba = bias[OBA];
        if (r < n) sigma[r] = sacc[0] + ba;
        if (r + 8 < n) sigma[r + 8] = sacc[2] + ba;
      }
      epilogue<false>(acc, bias + OBF, a, tg);

      // v1 = relu(feat @ Wvf + v @ Wvv + bv), 128 wide
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
      uint32_t av[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(bias + OBV + 8 * j + 2 * tg);
        av[j >> 1][(j & 1) * 2 + 0] = pack_bf16(fmaxf(vacc[4 * j + 0] + b.x, 0.f), fmaxf(vacc[4 * j + 1] + b.y, 0.f));
        av[j >> 1][(j & 1) * 2 + 1] = pack_bf16(fmaxf(vacc[4 * j + 2] + b.x, 0.f), fmaxf(vacc[4 * j + 3] + b.y, 0.f));
      }

      // rgb = v1 @ Wrgb + brgb (f32), columns 0..2 of an n8 tile
      float racc[4];
      pin(av);
      consume_begin(ring);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        wgmma_rs_n8<0>(racc, av[k], desc_kmajor(ring.addr() + (k >> 2) * 1024) + (k & 3) * KSTEP_KMAJOR,
                       k > 0);
      consume_end(ring, prev, lane);
      drain(prev, lane);
      pin(racc);
      if (tg < 2) {
        const int c = tg * 2;  // this lane holds columns c, c + 1
        const long long r = row0 + warp * 16 + g;
        const float b0 = bias[OBRGB + c], b1 = bias[OBRGB + c + 1];
        if (r < n) {
          rgb[r * 3 + c] = racc[0] + b0;
          if (c + 1 < 3) rgb[r * 3 + c + 1] = racc[1] + b1;
        }
        if (r + 8 < n) {
          rgb[(r + 8) * 3 + c] = racc[2] + b0;
          if (c + 1 < 3) rgb[(r + 8) * 3 + c + 1] = racc[3] + b1;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Element counts of the packed weight (bf16) and bias (f32) buffers, and of
// the weight image (bf16) the kernel reads.
long long xr_fused_nerf_mlp_fwd_weight_elems() { return (long long)OWEND; }
long long xr_fused_nerf_mlp_fwd_bias_elems() { return (long long)OBEND; }
long long xr_fused_nerf_mlp_fwd_image_elems() { return (long long)(IWEND / 2); }
// Dynamic shared memory of a CTA (bytes).
long long xr_fused_nerf_mlp_fwd_smem_bytes() { return (long long)SMEM_BYTES; }

const char* xr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [n, dx] f32 (dx <= 64), v [n, dv] f32 (dv <= 32), image: the weight
// image (bf16, 16-byte aligned), b: the packed biases, rgb [n, 3] f32 and
// sigma [n] f32 written. Launches on `stream`, does not synchronise; returns
// the cudaError_t of the launch (0 on success).
int xr_fused_nerf_mlp_fwd(const float* x, int dx, const float* v, int dv, long long n,
                          const void* image, const float* b, float* rgb, float* sigma,
                          void* stream) {
  if (dx < 1 || dx > PX || dv < 1 || dv > PV || n < 0 || ((uintptr_t)image & 15))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(fused_nerf_mlp_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return (int)err;
  const long long tiles = (n + TILE - 1) / TILE;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);  // a persistent grid
  fused_nerf_mlp_fwd_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, dx, v, dv, n, reinterpret_cast<const unsigned char*>(image), b, rgb, sigma);
  return (int)cudaGetLastError();
}

}  // extern "C"
