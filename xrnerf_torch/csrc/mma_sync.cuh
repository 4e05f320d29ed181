// mma.sync pieces of the tiny-MLP kernels (fused_mlp_fwd.cu, fused_mlp_bwd.cu):
// the m16n8k16 bf16 product with f32 accumulators, and the 32-bit shared-memory
// load that fetches one register of a fragment. Each source is its own
// translation unit, so everything here lives in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

}  // namespace
