// Hopper (sm_90a) PTX pieces shared by the kernels that stream tiles with
// cp.async.bulk and mbarriers and multiply with wgmma: fused_nerf_mlp_fwd.cu
// and fused_nerf_mlp_bwd.cu (through fused_nerf_mlp_common.cuh) and
// fused_mlp_bwd.cu. Each source is its own translation unit, so everything
// here lives in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// L2 policies for bulk copies: keep (the weights, which every tile reads
// again), drop first (a stream written once and read much later), or the
// default. Without them the backward's scratch stream pushes the weights
// out of the L2.
__device__ __forceinline__ uint64_t l2_keep() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_stream() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// Global -> shared bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) that completes on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// Shared -> global bulk copy, tracked by the issuing thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes,
                                           uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::
                   "l"(dst),
               "r"(src), "r"(bytes), "l"(policy)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The issuing thread's bulk stores have all read their shared source.
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to the async proxy
// (wgmma operand reads, bulk stores).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over the 128 threads of consumer warpgroup `wg` (ids 1, 2).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma is asynchronous and the compiler does not know it: these empty
// statements pin a register operand's value before the first wgmma that
// reads it and after the wait that makes an accumulator readable.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptors, 128-byte swizzle (tiles 1024-byte
// aligned). K-major: rows (M or N index) of 128 bytes = 64 k, groups of 8
// rows 1024 bytes apart; a k16 step advances the start by 32 bytes.
// MN-major: rows (one k each) of 128 bytes = 64 m/n, groups of 8 k 1024
// bytes apart, 64-wide m/n panels `panel_bytes` apart; a k16 step advances
// the start by 2048 bytes.
constexpr uint64_t DESC_SW128 = 1ull << 62;
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return DESC_SW128 | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 16) |
         (uint64_t)((addr & 0x3FFFF) >> 4);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t panel_bytes) {
  return DESC_SW128 | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)(panel_bytes >> 4) << 16) |
         (uint64_t)((addr & 0x3FFFF) >> 4);
}
constexpr uint64_t KSTEP_KMAJOR = 32 >> 4;
constexpr uint64_t KSTEP_MNMAJOR = 2048 >> 4;

// Byte offset of element (r, c) in a swizzled tile of 128-byte rows.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }
__device__ __forceinline__ float bf16r(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

}  // namespace
