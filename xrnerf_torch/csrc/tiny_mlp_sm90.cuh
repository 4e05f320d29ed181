// Pieces shared by the wgmma tiny-MLP kernels, the colour-net forward
// (fused_mlp_fwd.cu) and the backwards (fused_mlp_bwd.cu): their widths and
// thread layout, the A fragments of a warp-private bf16 block (load_a), a
// register-A wgmma product against a weight tile in shared memory, and the
// SM count a persistent grid is sized by. Each source is its own
// translation unit, so everything here lives in an anonymous namespace.

#pragma once

#include "sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {
namespace tinyw {

constexpr int KIN = 32;      // padded input width (din <= 32)
constexpr int HID = 64;      // padded hidden width (hidden <= 64)
constexpr int ROWS = 128;    // rows per tile
constexpr int WG_ROWS = 64;  // rows of one consumer warpgroup
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int WTILE = HID * 128;          // one [64][64] bf16 weight tile, 8 KB
// row stride of the warp-private bf16 block of x (+8: the 8 rows of an A
// fragment on distinct banks)
constexpr int LDI = KIN + 8;

constexpr int align1k(int b) { return (b + 1023) & ~1023; }

// acc = A @ B^T for the warpgroup's 64 rows: A in registers (KS k16
// fragments, one per warp), B a K-major weight tile of N / 4 * 8 rows
// (descriptor wd); one wgmma group, waited for.
template <int KS, int N>
__device__ __forceinline__ void product(float (&acc)[N], uint32_t (&a)[KS][4], uint64_t wd) {
  pin(a);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if constexpr (N == 32)
      wgmma_rs_n64<0>(acc, a[ks], wd + ks * KSTEP_KMAJOR, ks > 0);
    else if constexpr (N == 16)
      wgmma_rs_n32<0>(acc, a[ks], wd + ks * KSTEP_KMAJOR, ks > 0);
    else if constexpr (N == 8)
      wgmma_rs_n16<0>(acc, a[ks], wd + ks * KSTEP_KMAJOR, ks > 0);
    else
      wgmma_rs_n8<0>(acc, a[ks], wd + ks * KSTEP_KMAJOR, ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
}

// A fragments (KS k-steps) of a warp-private row-major [16][LD] bf16 block.
template <int KS, int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* blk, int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* ap = blk + g * LD + ks * 16 + tg * 2;
    a[ks][0] = *reinterpret_cast<const uint32_t*>(ap);
    a[ks][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * LD);
    a[ks][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
    a[ks][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * LD + 8);
  }
}

// The current device's number of SMs (host).
inline cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// Barrier over the two consumer warpgroups.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(CONSUMERS) : "memory");
}

}  // namespace tinyw
}  // namespace
