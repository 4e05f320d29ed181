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
// [in, out] row-major, and are rounded here.
//
// What bounds them: bytes. At the widths Instant-NGP uses, a row moves
// 192 B (32 in, 16 out) for 6,144 FLOP, or 136 B (31 in, 3 out) for 12,544
// FLOP: 32 and 92 FLOP per byte, far under the H100's ~295 FLOP/B ridge.
// So the design spends nothing on device memory beyond x once and out once:
//   - a CTA stages the weights (bf16, transposed to [out][in]) and biases in
//     shared memory once, then walks over 128-row tiles (grid-stride), so
//     the staging is paid once per CTA and not once per tile;
//   - each of the 8 warps owns 16 rows of the tile for the whole chain. It
//     copies its 16 x din block of x (contiguous in global memory) to a
//     warp-private bf16 buffer, reads it back as mma A fragments, and from
//     there the hidden activations never leave registers: the f32
//     accumulator fragment of two neighbouring n-tiles of mma.sync m16n8k16
//     is, after bias, ReLU and rounding, exactly the A fragment of one
//     k-step of the next layer. No block-wide barrier inside the tile loop;
//   - widths are padded with zeros inside the kernel (din to 32, hidden to
//     64, out to 8 or 16), so the caller passes the JAX shapes. A padded
//     hidden unit has zero weights and bias, so it is relu(0) = 0 and adds
//     nothing.
// What is not carried over from the TPU design: the 512-row tile and the
// sequential grid. wgmma, TMA and coalesced output staging are later work.

#include "fused_nerf_mlp_common.cuh"

namespace {
namespace tiny {

constexpr int KIN = 32;      // padded input width (din <= 32)
constexpr int HID = 64;      // padded hidden width (hidden <= 64)
constexpr int ROWS = 128;    // rows per tile
constexpr int WARPS = 8;     // 16 rows each
constexpr int NTHREADS = 32 * WARPS;
constexpr int LDI = KIN + 8; // shared row strides (bf16): +8 keeps the 8 rows
constexpr int LDH = HID + 8; // of an mma fragment on distinct banks

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// NHID hidden layers (1 or 2), output padded to NOUT (8 or 16) columns.
template <int NHID, int NOUT>
__global__ void __launch_bounds__(NTHREADS)
    tiny_mlp_fwd_kernel(const float* __restrict__ x, int din, long long n,
                        const float* __restrict__ w1, const float* __restrict__ b1, int h1,
                        const float* __restrict__ w2, const float* __restrict__ b2, int h2,
                        const float* __restrict__ wo, const float* __restrict__ bo, int dout,
                        float* __restrict__ out) {
  // bf16 storage, declared as raw 16-bit words
  __shared__ __align__(16) unsigned short w1raw[HID * LDI];
  __shared__ __align__(16) unsigned short w2raw[NHID == 2 ? HID * LDH : 8];
  __shared__ __align__(16) unsigned short woraw[NOUT * LDH];
  __shared__ __align__(16) unsigned short xraw[WARPS * 16 * LDI];
  __shared__ float b1s[HID], b2s[HID], bos[NOUT];
  bf16* w1s = reinterpret_cast<bf16*>(w1raw);
  bf16* w2s = reinterpret_cast<bf16*>(w2raw);
  bf16* wos = reinterpret_cast<bf16*>(woraw);

  stage_weight<KIN, HID, LDI>(w1, din, h1, w1s);
  stage_bias<HID>(b1, h1, b1s);
  if constexpr (NHID == 2) {
    stage_weight<HID, HID, LDH>(w2, h1, h2, w2s);
    stage_bias<HID>(b2, h2, b2s);
  }
  stage_weight<HID, NOUT, LDH>(wo, NHID == 2 ? h2 : h1, dout, wos);
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
    if constexpr (NHID == 2) {
      zero_acc(acc);
      layer<HID / 8, HID / 16, LDH>(acc, ah, w2s, lane);
      relu_pack(acc, b2s, ah, lane);
    }
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

template <int NHID>
cudaError_t launch(const float* x, int din, long long n, const float* w1, const float* b1, int h1,
                   const float* w2, const float* b2, int h2, const float* wo, const float* bo,
                   int dout, float* out, cudaStream_t stream) {
  if (din < 1 || din > KIN || h1 < 1 || h1 > HID || h2 < 1 || h2 > HID || dout < 1 ||
      dout > 16 || n < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + ROWS - 1) / ROWS;
  const long long cap = (long long)sms * 4;  // CTAs walk the tiles grid-stride
  const unsigned blocks = (unsigned)(ntiles < cap ? ntiles : cap);
  if (dout <= 8)
    tiny_mlp_fwd_kernel<NHID, 8><<<blocks, NTHREADS, 0, stream>>>(x, din, n, w1, b1, h1, w2, b2,
                                                                  h2, wo, bo, dout, out);
  else
    tiny_mlp_fwd_kernel<NHID, 16><<<blocks, NTHREADS, 0, stream>>>(x, din, n, w1, b1, h1, w2, b2,
                                                                   h2, wo, bo, dout, out);
  return cudaGetLastError();
}

}  // namespace tiny
}  // namespace

extern "C" {

const char* xr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Widest shapes the kernels take: din, hidden, dout.
int xr_fused_mlp_fwd_max_din() { return tiny::KIN; }
int xr_fused_mlp_fwd_max_hidden() { return tiny::HID; }
int xr_fused_mlp_fwd_max_dout() { return 16; }

// out [n, dout] = relu(x [n, din] @ w1 [din, h] + b1) @ w2 [h, dout] + b2, all
// f32 row-major. Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launch (0 on success).
int xr_fused_mlp2_fwd(const float* x, int din, long long n, const float* w1, const float* b1,
                      int h, const float* w2, const float* b2, int dout, float* out,
                      void* stream) {
  return (int)tiny::launch<1>(x, din, n, w1, b1, h, nullptr, nullptr, h, w2, b2, dout, out,
                              (cudaStream_t)stream);
}

// out [n, dout] = relu(relu(x @ w1 [din, h1] + b1) @ w2 [h1, h2] + b2) @ w3
// [h2, dout] + b3.
int xr_fused_mlp3_fwd(const float* x, int din, long long n, const float* w1, const float* b1,
                      int h1, const float* w2, const float* b2, int h2, const float* w3,
                      const float* b3, int dout, float* out, void* stream) {
  return (int)tiny::launch<2>(x, din, n, w1, b1, h1, w2, b2, h2, w3, b3, dout, out,
                              (cudaStream_t)stream);
}

}  // extern "C"
