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
// times the H100's ~295 FLOP/B ridge. So activations never leave the SM:
// one CTA owns a 128-row tile and keeps x, v and two ping-pong [128, 256]
// bf16 activation buffers in dynamic shared memory (160 KB) for the whole
// chain; only the final rgb/sigma go back to global memory. Products run
// on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate);
// 16 warps split each layer's [128 x 256] output as 2 (rows) x 8 (cols).
//
// What is not carried over from the TPU design: its 2048-row tiles, and all
// weights resident in one core's VMEM (1.2 MB of bf16 weights does not fit
// in an SM's 227 KB). Weights are read straight from global memory by each
// warp as mma B fragments (one 32-bit load per register, since they are
// stored [out, in]); the 1.2 MB stays resident in the 50 MB L2, and a
// 128-row tile re-reads it once (~9.3 KB of L2 traffic per row, about 128
// FLOP per L2 byte). wgmma, TMA and shared-memory weight staging are later
// work. The ragged last tile is masked here: rows >= n read as zero and
// are never stored.
//
// Weight layout (bf16, each matrix [out, in] row-major, in this order; the
// Python side builds it in xrnerf_torch/ops/fused_nerf_mlp.py:_layout):
//   W0[256,64] W1..W4[256,256] W5h[256,256] W5x[256,64] W6 W7[256,256]
//   Wf[256,256] Wa[8,256] (row 0 = alpha) Wvf[128,256] Wvv[128,32]
//   Wrgb[8,128] (rows 0..2 = rgb)
// Bias layout (f32): b0..b7[256] bf[256] ba[8] bv[128] brgb[8].

#include "fused_nerf_mlp_common.cuh"

namespace {

constexpr size_t SMEM_BYTES = sizeof(__nv_bfloat16) * TILE * (LDX + LDV + 2 * LDH);

__global__ void __launch_bounds__(THREADS, 1)
    fused_nerf_mlp_fwd_kernel(const float* __restrict__ x, int dx, const float* __restrict__ v,
                              int dv, long long n, const bf16* __restrict__ Wp,
                              const float* __restrict__ Bp, float* __restrict__ rgb,
                              float* __restrict__ sigma) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [TILE][LDX]
  bf16* vs = xs + TILE * LDX;                // [TILE][LDV]
  bf16* h0 = vs + TILE * LDV;                // [TILE][LDH]
  bf16* h1 = h0 + TILE * LDH;                // [TILE][LDH]

  const long long row0 = (long long)blockIdx.x * TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp / WARPS_N) * (TILE / WARPS_M);
  const int wn = warp % WARPS_N;
  const int n0 = wn * (WIDTH / WARPS_N);  // 32 columns of a 256-wide layer
  const int g = lane >> 2, tg = lane & 3;

  stage<PX, LDX>(x, dx, n, row0, xs);
  stage<PV, LDV>(v, dv, n, row0, vs);
  __syncthreads();

  dense_relu<PX>(xs, LDX, Wp + OW0, Bp + 0 * WIDTH, h0, n0, m0, lane);
  __syncthreads();
  dense_relu<WIDTH>(h0, LDH, Wp + OW1, Bp + 1 * WIDTH, h1, n0, m0, lane);
  __syncthreads();
  dense_relu<WIDTH>(h1, LDH, Wp + OW2, Bp + 2 * WIDTH, h0, n0, m0, lane);
  __syncthreads();
  dense_relu<WIDTH>(h0, LDH, Wp + OW3, Bp + 3 * WIDTH, h1, n0, m0, lane);
  __syncthreads();
  dense_relu<WIDTH>(h1, LDH, Wp + OW4, Bp + 4 * WIDTH, h0, n0, m0, lane);  // h4
  __syncthreads();
  {  // h5 = relu(h4 @ W5h + x @ W5x + b5)
    float acc[MT][4][4];
    zero(acc);
    mma_acc<4, WIDTH>(acc, h0, LDH, Wp + OW5H, n0, m0, lane);
    mma_acc<4, PX>(acc, xs, LDX, Wp + OW5X, n0, m0, lane);
    store_bf16<4, true>(acc, Bp + 5 * WIDTH, h1, LDH, n0, m0, lane);
  }
  __syncthreads();
  dense_relu<WIDTH>(h1, LDH, Wp + OW6, Bp + 6 * WIDTH, h0, n0, m0, lane);
  __syncthreads();
  dense_relu<WIDTH>(h0, LDH, Wp + OW7, Bp + 7 * WIDTH, h1, n0, m0, lane);  // h7
  __syncthreads();
  {  // feat = bf16(h7 @ Wf + bf), no activation
    float acc[MT][4][4];
    zero(acc);
    mma_acc<4, WIDTH>(acc, h1, LDH, Wp + OWF, n0, m0, lane);
    store_bf16<4, false>(acc, Bp + OBF, h0, LDH, n0, m0, lane);
  }
  if (wn == 0) {  // sigma = h7 @ Wa + ba, from the f32 accumulator (column 0)
    float acc[MT][1][4];
    zero(acc);
    mma_acc<1, WIDTH>(acc, h1, LDH, Wp + OWA, 0, m0, lane);
    if (tg == 0) {
      const float ba = __ldg(Bp + OBA);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const long long r = row0 + m0 + mt * 16 + g;
        if (r < n) sigma[r] = acc[mt][0][0] + ba;
        if (r + 8 < n) sigma[r + 8] = acc[mt][0][2] + ba;
      }
    }
  }
  __syncthreads();
  {  // v1 = relu(feat @ Wvf + v @ Wvv + bv), 128 wide: 16 columns per warp
    const int nv = wn * (HV / WARPS_N);
    float acc[MT][2][4];
    zero(acc);
    mma_acc<2, WIDTH>(acc, h0, LDH, Wp + OWVF, nv, m0, lane);
    mma_acc<2, PV>(acc, vs, LDV, Wp + OWVV, nv, m0, lane);
    store_bf16<2, true>(acc, Bp + OBV, h1, LDH, nv, m0, lane);
  }
  __syncthreads();
  if (wn == 0) {  // rgb = v1 @ Wrgb + brgb (f32), columns 0..2
    float acc[MT][1][4];
    zero(acc);
    mma_acc<1, HV>(acc, h1, LDH, Wp + OWRGB, 0, m0, lane);
    if (tg < 2) {
      const int c = tg * 2;  // lane holds columns c, c+1
      const float bb0 = __ldg(Bp + OBRGB + c), bb1 = __ldg(Bp + OBRGB + c + 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const long long r = row0 + m0 + mt * 16 + g;
        if (r < n) {
          rgb[r * 3 + c] = acc[mt][0][0] + bb0;
          if (c + 1 < 3) rgb[r * 3 + c + 1] = acc[mt][0][1] + bb1;
        }
        if (r + 8 < n) {
          rgb[(r + 8) * 3 + c] = acc[mt][0][2] + bb0;
          if (c + 1 < 3) rgb[(r + 8) * 3 + c + 1] = acc[mt][0][3] + bb1;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Element counts of the packed weight (bf16) and bias (f32) buffers.
long long xr_fused_nerf_mlp_fwd_weight_elems() { return (long long)OWEND; }
long long xr_fused_nerf_mlp_fwd_bias_elems() { return (long long)OBEND; }

const char* xr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [n, dx] f32 (dx <= 64), v [n, dv] f32 (dv <= 32), w / b packed as above,
// rgb [n, 3] f32 and sigma [n] f32 written. Launches on `stream`, does not
// synchronise; returns the cudaError_t of the launch (0 on success).
int xr_fused_nerf_mlp_fwd(const float* x, int dx, const float* v, int dv, long long n,
                          const void* w, const float* b, float* rgb, float* sigma,
                          void* stream) {
  if (dx < 1 || dx > PX || dv < 1 || dv > PV || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(fused_nerf_mlp_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + TILE - 1) / TILE;
  fused_nerf_mlp_fwd_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, dx, v, dv, n, reinterpret_cast<const bf16*>(w), b, rgb, sigma);
  return (int)cudaGetLastError();
}

}  // extern "C"
