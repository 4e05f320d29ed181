// Row scatter-add for Hopper (sm_90a), bound with ctypes: the hash table's
// gradient.
//
// Replaces the TPU kernel of xrnerf_tpu/ops/pallas/scatter_rows.py:
//   xr_scatter_add_rows_i32 / _i64  <-  _kernel (:62), launched by
//       _pallas_scatter_add_rows (pallas_call at :120) under
//       scatter_add_rows (:182)
//
// What it computes: out[idx[i], :] += vals[i, :] for i < n, into an `out`
// [num_rows, w] that the caller has zeroed. A row with idx[i] < 0 is
// dropped; with skip_zero_rows a row whose values are all zero is dropped
// too (the test that the JAX wrapper makes before its kernel, :198-200, is
// made here, in the same pass over the values). Row ids are int32 or int64,
// each with its own entry point; ids >= num_rows must not occur.
//
// What bounds it: bytes (idx and vals read once, out written once; there is
// nothing to compute), and in practice the L2's atomic units. The TPU body
// is a serial read-modify-write loop over an accumulator held on chip,
// because its grid is sequential; here all rows go at once and the additions
// are f32 atomics in L2 (red.global.add), vectorised to one instruction per
// 8 or 16 bytes where the row width and the alignment allow:
//   w == 2            one thread per row, one .v2 reduction;
//   w % 4 == 0        w/4 lanes per row (a power of two <= 32), one .v4
//                     reduction each; the all-zero test is combined over the
//                     row's lanes by shuffles;
//   anything else     one thread per row, scalar reductions.
// Additions to one address serialise, so a table with few rows (the coarsest
// dense level: 4,096) runs slower than a hashed one; the order of the
// additions, and with it the last bits of a sum, changes from run to run.
// A pre-reduction in shared memory for small tables is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
#define XR_VECTOR_RED 1
#else
#define XR_VECTOR_RED 0
#endif

__device__ __forceinline__ void red_add(float* p, float v) { atomicAdd(p, v); }

__device__ __forceinline__ void red_add2(float* p, float2 v) {
#if XR_VECTOR_RED
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(v.x), "f"(v.y) : "memory");
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
#endif
}

__device__ __forceinline__ void red_add4(float* p, float4 v) {
#if XR_VECTOR_RED
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

constexpr int NTHREADS = 256;

// w == 2: one thread per row.
template <typename IdxT>
__global__ void __launch_bounds__(NTHREADS)
    scatter_rows_w2_kernel(const IdxT* __restrict__ idx, const float2* __restrict__ vals,
                           long long n, int skip_zero, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n) return;
  const long long r = (long long)idx[i];
  if (r < 0) return;
  const float2 v = vals[i];
  if (skip_zero && v.x == 0.f && v.y == 0.f) return;
  red_add2(out + r * 2, v);
}

// w == 4 * lanes: `lanes` (a power of two <= 32) threads per row. No thread
// leaves before the shuffles: a row's lanes lie in one warp.
template <typename IdxT>
__global__ void __launch_bounds__(NTHREADS)
    scatter_rows_v4_kernel(const IdxT* __restrict__ idx, const float4* __restrict__ vals,
                           long long n, int lanes, int skip_zero, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  const long long i = t / lanes;
  const int l = (int)(t % lanes);
  const bool valid = i < n;
  long long r = -1;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    r = (long long)idx[i];
    if (r >= 0) v = vals[i * lanes + l];
  }
  if (skip_zero) {
    int nz = (v.x != 0.f) | (v.y != 0.f) | (v.z != 0.f) | (v.w != 0.f);
    for (int o = 1; o < lanes; o <<= 1) nz |= __shfl_xor_sync(0xffffffffu, nz, o);
    if (!nz) return;
  }
  if (r < 0) return;
  red_add4(out + (r * lanes + l) * 4, v);
}

// Any width: one thread per row, scalar reductions.
template <typename IdxT>
__global__ void __launch_bounds__(NTHREADS)
    scatter_rows_any_kernel(const IdxT* __restrict__ idx, const float* __restrict__ vals,
                            long long n, int w, int skip_zero, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n) return;
  const long long r = (long long)idx[i];
  if (r < 0) return;
  const float* v = vals + i * w;
  if (skip_zero) {
    bool nz = false;
    for (int c = 0; c < w; ++c) nz |= v[c] != 0.f;
    if (!nz) return;
  }
  for (int c = 0; c < w; ++c) red_add(out + r * w + c, v[c]);
}

template <typename IdxT>
cudaError_t launch(const IdxT* idx, const float* vals, long long n, int w, int skip_zero,
                   float* out, cudaStream_t stream) {
  if (n < 1 || w < 1) return cudaErrorInvalidValue;
  const uintptr_t pv = (uintptr_t)vals, po = (uintptr_t)out;
  const int lanes = w / 4;
  const bool pow2 = lanes > 0 && (lanes & (lanes - 1)) == 0;
  if (w == 2 && pv % 8 == 0 && po % 8 == 0) {
    const long long blocks = (n + NTHREADS - 1) / NTHREADS;
    scatter_rows_w2_kernel<IdxT><<<(unsigned)blocks, NTHREADS, 0, stream>>>(
        idx, reinterpret_cast<const float2*>(vals), n, skip_zero, out);
  } else if (w % 4 == 0 && pow2 && lanes <= 32 && pv % 16 == 0 && po % 16 == 0) {
    const long long blocks = (n * lanes + NTHREADS - 1) / NTHREADS;
    scatter_rows_v4_kernel<IdxT><<<(unsigned)blocks, NTHREADS, 0, stream>>>(
        idx, reinterpret_cast<const float4*>(vals), n, lanes, skip_zero, out);
  } else {
    const long long blocks = (n + NTHREADS - 1) / NTHREADS;
    scatter_rows_any_kernel<IdxT><<<(unsigned)blocks, NTHREADS, 0, stream>>>(idx, vals, n, w,
                                                                            skip_zero, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* xr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// 1 when the 8- and 16-byte reductions are compiled in, 0 when the toolkit
// predates them and every addition is a scalar one.
int xr_scatter_add_rows_vectorised() { return XR_VECTOR_RED; }

// out [num_rows, w] += vals [n, w] at rows idx [n] (int32 ids); `out` is
// zeroed by the caller. n >= 1. Launches on `stream`, does not synchronise;
// returns the cudaError_t of the launch (0 on success).
int xr_scatter_add_rows_i32(const int* idx, const float* vals, long long n, int w, int skip_zero,
                            float* out, void* stream) {
  return (int)launch<int>(idx, vals, n, w, skip_zero, out, (cudaStream_t)stream);
}

// The same with int64 ids.
int xr_scatter_add_rows_i64(const long long* idx, const float* vals, long long n, int w,
                            int skip_zero, float* out, void* stream) {
  return (int)launch<long long>(idx, vals, n, w, skip_zero, out, (cudaStream_t)stream);
}

}  // extern "C"
