// Shared pieces of the fused vanilla-NeRF MLP kernels (forward and
// backward): the packed weight / bias layout, the row tile and warp grid,
// and the mma.sync helpers. Included by fused_nerf_mlp_fwd.cu and
// fused_nerf_mlp_bwd.cu; each is its own translation unit, so everything
// here lives in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIDTH = 256;
constexpr int HV = WIDTH / 2;
constexpr int PX = 64;  // posenc(pts) 63 -> 64
constexpr int PV = 32;  // posenc(dirs) 27 -> 32
constexpr int HEAD = 8; // alpha / rgb heads padded to one mma n-tile

constexpr int TILE = 128;
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 8;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MT = TILE / WARPS_M / 16;  // m16 tiles per warp (4)

// Shared-memory row strides (bf16 elements): +8 keeps the 8 rows of an
// mma fragment on distinct banks.
constexpr int LDX = PX + 8;
constexpr int LDV = PV + 8;
constexpr int LDH = WIDTH + 8;

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

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// D += A[16x16, row] * B[16x8, col], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// acc[rows m0..m0+63, cols n0..n0+8*NT) += As[:, 0:K] @ W[n0.., 0:K]^T.
// As: shared bf16 [TILE][lda]; W: global bf16 [out][K].
template <int NT, int K>
__device__ __forceinline__ void mma_acc(float (&acc)[MT][NT][4], const bf16* As, int lda,
                                        const bf16* __restrict__ W, int n0, int m0,
                                        int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; k += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* wp = W + (size_t)(n0 + nt * 8 + g) * K + k + tg * 2;
      b[nt][0] = ldg32(wp);
      b[nt][1] = ldg32(wp + 8);
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

// Out[row, col] = bf16(act(acc + bias[col])) for this warp's fragment.
template <int NT, bool RELU>
__device__ __forceinline__ void store_bf16(const float (&acc)[MT][NT][4],
                                           const float* __restrict__ bias, bf16* Out,
                                           int ldo, int n0, int m0, int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + tg * 2;
    const float bb0 = __ldg(bias + col), bb1 = __ldg(bias + col + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = m0 + mt * 16 + g;
      float v0 = acc[mt][nt][0] + bb0, v1 = acc[mt][nt][1] + bb1;
      float v2 = acc[mt][nt][2] + bb0, v3 = acc[mt][nt][3] + bb1;
      if (RELU) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f);
        v3 = fmaxf(v3, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(Out + row * ldo + col) = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(Out + (row + 8) * ldo + col) =
          __floats2bfloat162_rn(v2, v3);
    }
  }
}

// One 256-wide hidden layer: Out = relu(In @ W^T + b), this warp's columns.
template <int K>
__device__ __forceinline__ void dense_relu(const bf16* In, int ldi, const bf16* __restrict__ W,
                                           const float* __restrict__ b, bf16* Out, int n0,
                                           int m0, int lane) {
  float acc[MT][4][4];
  zero(acc);
  mma_acc<4, K>(acc, In, ldi, W, n0, m0, lane);
  store_bf16<4, true>(acc, b, Out, LDH, n0, m0, lane);
}

// Stage a [TILE, P] bf16 tile of a [n, d] f32 matrix; columns >= d and rows
// >= n read as zero.
template <int P, int LD>
__device__ __forceinline__ void stage(const float* __restrict__ src, int d, long long n,
                                      long long row0, bf16* dst) {
  for (int i = threadIdx.x; i < TILE * P; i += THREADS) {
    const int r = i / P, c = i % P;
    const long long gr = row0 + r;
    const float val = (gr < n && c < d) ? __ldg(src + gr * d + c) : 0.f;
    dst[r * LD + c] = __float2bfloat16_rn(val);
  }
}

}  // namespace
