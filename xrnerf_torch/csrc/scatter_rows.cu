// Row scatter-add for Hopper (sm_90a), bound with ctypes: the hash table's
// gradient, all the levels of a backward in one launch.
//
// Replaces the TPU kernel of xrnerf_tpu/ops/pallas/scatter_rows.py:
//   xr_scatter_add_rows_levels_i32 / _i64  <-  _kernel (:62), launched by
//       _pallas_scatter_add_rows (pallas_call at :120) under
//       scatter_add_rows (:182), which the JAX encodings call once per
//       level (models/embedders/hashenc.py:257 vertex, :499 brick)
//
// What it computes: for each level l < L, out[l, idx[l, i], :] += vals[l, i, :]
// for i < m, into an `out` [L, t, w] that the caller has zeroed. A row with
// idx < 0 or idx >= rows[l] is dropped (rows at or past rows[l] of level l
// stay zero: a dense level fills only res^3 of its t rows); with skip_zero
// a row whose values are all zero is dropped too (the test that the JAX
// wrapper makes before its kernel, :198-200, is made here, in the same pass
// over the values), and a dropped row adds nothing anywhere. Row ids are
// int32 or int64, each with its own entry point. One level (L = 1) is the
// single-table scatter.
//
// What bounds it: bytes (ids and values read once, out written once; one
// addition per value), and in practice the L2's atomic units: every update
// row that reaches device memory is one red.global.add.v2/.v4.f32, and
// additions to one address serialise. The TPU body is a serial
// read-modify-write loop over an accumulator held on chip; here rows go in
// parallel, and the design cuts the number of global reductions:
//   - one launch for a stack of levels: CTAs are assigned level-major (a
//     descriptor per level: its row count, its mode, its first CTA), so a
//     level's table (at most t * w * 4 bytes, 4 MB for the vertex table) is
//     hot in the L2 while its additions land, and the encoding's gradient is
//     written in its own layout (no per-level launch, no cat, no stack);
//   - w == 2 rows (the vertex encoding's) are summed within a warp first:
//     where some lane's id repeats its neighbour's, each run of lanes with
//     equal ids is summed by a segmented scan over shuffles, and one lane
//     adds for the run. Samples arrive ray by ray (corner-major [8, N], N in
//     march order), so equal ids come in runs of neighbouring lanes, which
//     the scan sums in five steps whatever the runs' lengths (grouping any
//     equal ids with __match_any_sync would also catch ids that repeat
//     apart, which march order does not make); where no id repeats its
//     neighbour, the test costs two shuffles and one vote. Then each level
//     takes one of two modes:
//   - SHARED, for a level whose table fits the launch's shared budget: each
//     CTA zeroes a private copy of the table, adds its share of the rows
//     with shared-memory atomics, and flushes only its non-zero rows
//     (red.global.add.v2), starting at its own row. The coarsest dense
//     vertex level (4,096 rows) takes 2,097,152 additions into 4,096
//     addresses; in shared memory each CTA does 16,384 of them and sends at
//     most 4,096 to the L2;
//   - AGGREGATE: one red.global.add.v2 per run;
//   - other widths are PLAIN: one reduction per row (.v4 with w / 4 lanes
//     per row for w % 4 == 0, scalar otherwise).
// Which level takes which mode is decided on the host
// (xrnerf_torch/ops/scatter_rows.py:level_modes, whose note gives the
// measured rule). Loads are 16 bytes a thread where the alignment allows:
// two int64 or four int32 ids and two float2 rows per thread for w == 2,
// one float4 a lane with w / 4 lanes per row for w % 4 == 0, scalars
// otherwise. The order of the additions, and with it the last bits of a
// sum, changes from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
#define XR_VECTOR_RED 1
#else
#define XR_VECTOR_RED 0
#endif

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

constexpr int NTHREADS = 512;
constexpr int MAX_LEVELS = 64;
constexpr int ITEMS_PER_THREAD = 4;  // turns a thread makes per CTA (global modes)
constexpr long long SHARED_ROWS_PER_CTA = 16384;  // update rows a SHARED-mode CTA adds
constexpr int MAX_SHARED_BYTES = 227 * 1024;
enum Mode { SHARED = 0, AGGREGATE = 1, PLAIN = 2 };  // the first two for the w == 2 kernel

// Passed by value: where each level's CTAs start, and what they do.
struct Levels {
  int count;
  int rows[MAX_LEVELS];
  int mode[MAX_LEVELS];
  int first[MAX_LEVELS + 1];  // first CTA of level l; first[count] = grid size
};

// What one CTA does: its level, its index among the level's CTAs and their
// count, the level's row count and mode. Every index into the descriptor is
// a constant (an unrolled loop), so it is read from the parameter bank and
// never copied to local memory, and the walk stops at the CTA's level: a CTA
// of level l reads l + 1 entries. (Testing all MAX_LEVELS entries, some 600
// instructions a thread, made the one-level W = 16 scatter 1.5x slower.)
struct Work {
  int level, cta, ctas, rows, mode;
};

__device__ __forceinline__ Work cta_work(const Levels& L) {
  const int b = (int)blockIdx.x;
#pragma unroll
  for (int j = 0; j < MAX_LEVELS; ++j)
    if (b < L.first[j + 1])  // first[count] is the grid size, so j < count here
      return Work{j, b - L.first[j], L.first[j + 1] - L.first[j], L.rows[j], L.mode[j]};
  return Work{0, 0, 1, 0, PLAIN};  // not reached
}

// Sums the w == 2 rows of each run of lanes of a warp that hold the same id
// (lanes l .. l + k with equal ids): the run's last lane keeps the sum in v,
// the others get r = -1. A segmented inclusive scan over the runs, five
// shuffle steps whatever the runs' lengths; taken only where some lane's id
// repeats its neighbour's (one shuffle and one vote decide it), so a level
// without repeats pays almost nothing. Every lane takes part; lanes with
// r < 0 add nothing.
__device__ __forceinline__ void warp_sum_runs(int& r, float2& v, int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, r, 1), next = __shfl_down_sync(0xffffffffu, r, 1);
  const bool tail = lane == 31 || next != r || r < 0;
  if (__all_sync(0xffffffffu, tail)) return;
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != r);
  const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));  // this lane's run begins here
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ox = __shfl_up_sync(0xffffffffu, v.x, d), oy = __shfl_up_sync(0xffffffffu, v.y, d);
    if (lane - d >= start) {
      v.x += ox;
      v.y += oy;
    }
  }
  if (!tail) r = -1;
}

// A SHARED-mode CTA: zero the private table (n floats).
__device__ __forceinline__ void zero_table(float* tab, int n) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) tab[i] = 0.f;
  __syncthreads();
}

// w == 2: the R rows of thread slot gi of one turn, -1 ids past m. With VEC
// R = 16 / sizeof(IdxT) rows (one 16-byte id load, R / 2 float4 value
// loads) where the whole group lies inside the level, else scalar loads.
template <typename IdxT, bool VEC, int R>
__device__ __forceinline__ void load_rows(const IdxT* __restrict__ li, const float* __restrict__ lv,
                                          long long m, long long gi, long long (&r)[R], float2 (&v)[R]) {
  if constexpr (VEC) {
    if ((gi + 1) * R <= m) {
      if constexpr (sizeof(IdxT) == 8) {
        const longlong2 p = *reinterpret_cast<const longlong2*>(li + gi * R);
        r[0] = p.x;
        r[1] = p.y;
      } else {
        const int4 p = *reinterpret_cast<const int4*>(li + gi * R);
        r[0] = p.x;
        r[1] = p.y;
        r[2] = p.z;
        r[3] = p.w;
      }
#pragma unroll
      for (int k = 0; k < R; k += 2) {
        const float4 q = *reinterpret_cast<const float4*>(lv + (gi * R + k) * 2);
        v[k] = make_float2(q.x, q.y);
        v[k + 1] = make_float2(q.z, q.w);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long i = gi * R + k;
    r[k] = i < m ? (long long)li[i] : -1;
    v[k] = i < m ? *reinterpret_cast<const float2*>(lv + i * 2) : make_float2(0.f, 0.f);
  }
}

// w == 2: one turn of the CTA's grid-stride walk at a time. (Issuing the
// loads of four turns before their additions measured 5-7 % slower on a
// training step's 16 levels: more reductions in flight contend for the
// same rows in the L2.)
template <typename IdxT, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
    scatter_rows_levels_w2(const IdxT* __restrict__ idx, const float* __restrict__ vals, long long m,
                           long long t, int skip_zero, float* __restrict__ out, const Levels L) {
  constexpr int R = VEC ? 16 / (int)sizeof(IdxT) : 1;
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  const Work wk = cta_work(L);
  const int l = wk.level, cta = wk.cta, ctas = wk.ctas, mode = wk.mode;
  const long long rows = wk.rows;
  const IdxT* li = idx + l * m;
  const float* lv = vals + l * m * 2;
  float* lo = out + l * t * 2;
  const int lane = threadIdx.x & 31;
  if (mode == SHARED) zero_table(tab, (int)rows * 2);

  const long long groups = (m + R - 1) / R;
  for (long long base = (long long)cta * NTHREADS; base < groups; base += (long long)ctas * NTHREADS) {
    long long r[R];
    float2 v[R];
    load_rows<IdxT, VEC, R>(li, lv, m, base + threadIdx.x, r, v);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      int id = r[k] < 0 || r[k] >= rows || (skip_zero && v[k].x == 0.f && v[k].y == 0.f) ? -1 : (int)r[k];
      warp_sum_runs(id, v[k], lane);
      if (id < 0) continue;
      if (mode == SHARED) {
        atomicAdd(tab + id * 2, v[k].x);
        atomicAdd(tab + id * 2 + 1, v[k].y);
      } else {
        red_add2(lo + (long long)id * 2, v[k]);
      }
    }
  }
  if (mode == SHARED) {
    // each CTA starts its flush at its own row, so the level's CTAs do not
    // all reduce into one row at once
    __syncthreads();
    const float2* tab2 = reinterpret_cast<const float2*>(tab);
    const int n = (int)rows, start = (int)((long long)cta * n / ctas);
    for (int j = threadIdx.x; j < n; j += NTHREADS) {
      const int i = j < n - start ? j + start : j + start - n;
      const float2 s = tab2[i];
      if (s.x != 0.f || s.y != 0.f) red_add2(lo + (long long)i * 2, s);
    }
  }
}

// w == 4 * lanes (a power of two <= 32 lanes): one float4 a lane, PLAIN
// mode only. No lane leaves before the shuffles: a row's lanes lie in one
// warp.
template <typename IdxT>
__global__ void __launch_bounds__(NTHREADS)
    scatter_rows_levels_v4(const IdxT* __restrict__ idx, const float4* __restrict__ vals, long long m,
                           int lanes, long long t, int skip_zero, float* __restrict__ out,
                           const Levels L) {
  const Work wk = cta_work(L);
  const int l = wk.level, cta = wk.cta, ctas = wk.ctas;
  const long long rows = wk.rows;
  const IdxT* li = idx + l * m;
  const float4* lv = vals + l * m * lanes;
  float4* lo = reinterpret_cast<float4*>(out) + l * t * lanes;

  const long long items = m * lanes;
  for (long long base = (long long)cta * NTHREADS; base < items; base += (long long)ctas * NTHREADS) {
    const long long it = base + threadIdx.x;
    const long long i = it / lanes;
    const int c = (int)(it % lanes);
    long long r = -1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (it < items) {
      r = (long long)li[i];
      if (r >= rows) r = -1;
      if (r >= 0) v = lv[it];
    }
    if (skip_zero) {
      int nz = (v.x != 0.f) | (v.y != 0.f) | (v.z != 0.f) | (v.w != 0.f);
      for (int o = 1; o < lanes; o <<= 1) nz |= __shfl_xor_sync(0xffffffffu, nz, o);
      if (!nz) r = -1;
    }
    if (r >= 0) red_add4(reinterpret_cast<float*>(lo + r * lanes + c), v);
  }
}

// Any width: one thread per row, scalar additions, PLAIN mode only.
template <typename IdxT>
__global__ void __launch_bounds__(NTHREADS)
    scatter_rows_levels_any(const IdxT* __restrict__ idx, const float* __restrict__ vals, long long m,
                            int w, long long t, int skip_zero, float* __restrict__ out,
                            const Levels L) {
  const Work wk = cta_work(L);
  const int l = wk.level, cta = wk.cta, ctas = wk.ctas;
  const long long rows = wk.rows;
  const IdxT* li = idx + l * m;
  const float* lv = vals + l * m * w;
  float* lo = out + l * t * w;

  for (long long i = (long long)cta * NTHREADS + threadIdx.x; i < m; i += (long long)ctas * NTHREADS) {
    const long long r = (long long)li[i];
    if (r < 0 || r >= rows) continue;
    const float* v = lv + i * w;
    if (skip_zero) {
      bool nz = false;
      for (int c = 0; c < w; ++c) nz |= v[c] != 0.f;
      if (!nz) continue;
    }
    for (int c = 0; c < w; ++c) atomicAdd(lo + r * w + c, v[c]);
  }
}

template <typename K>
cudaError_t set_shared(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <typename IdxT>
cudaError_t launch(const IdxT* idx, const float* vals, int levels, long long m, int w, long long t,
                   const int* rows, const int* modes, int skip_zero, float* out,
                   cudaStream_t stream) {
  if (levels < 1 || levels > MAX_LEVELS || m < 1 || w < 1 || t < 1) return cudaErrorInvalidValue;
  const uintptr_t pi = (uintptr_t)idx, pv = (uintptr_t)vals, po = (uintptr_t)out;
  const int lanes = w / 4;
  const bool v4 = w % 4 == 0 && lanes > 0 && (lanes & (lanes - 1)) == 0 && lanes <= 32 &&
                  pv % 16 == 0 && po % 16 == 0;
  const bool w2 = w == 2 && pv % 8 == 0 && po % 8 == 0;
  // w == 2 with 16-byte loads: every level's ids and values start 16-byte aligned
  const bool vec = w2 && pi % 16 == 0 && pv % 16 == 0 && (m * (long long)sizeof(IdxT)) % 16 == 0 &&
                   (m * 8) % 16 == 0;
  const int per_row = w2 ? 1 : v4 ? lanes : 1;  // threads per row (w2: rows per thread below)
  const int rows_per_item = vec ? 16 / (int)sizeof(IdxT) : 1;
  Levels L;
  L.count = levels;
  long long grid = 0;
  int shared = 0;
  for (int l = 0; l < levels; ++l) {
    // SHARED and AGGREGATE are the w == 2 kernel's modes; the other kernels add plainly
    if (rows[l] < 0 || rows[l] > t || modes[l] < SHARED || modes[l] > PLAIN || (w == 2 && modes[l] == PLAIN))
      return cudaErrorInvalidValue;
    const int mode = w2 ? modes[l] : PLAIN;
    L.rows[l] = rows[l];
    L.mode[l] = mode;
    L.first[l] = (int)grid;
    long long ctas;
    if (mode == SHARED) {
      const long long bytes = (long long)rows[l] * w * 4;
      if (bytes > MAX_SHARED_BYTES) return cudaErrorInvalidValue;
      if (bytes > shared) shared = (int)bytes;
      ctas = (m + SHARED_ROWS_PER_CTA - 1) / SHARED_ROWS_PER_CTA;
    } else {
      const long long items = w2 ? (m + rows_per_item - 1) / rows_per_item : m * per_row;
      ctas = (items + (long long)NTHREADS * ITEMS_PER_THREAD - 1) / ((long long)NTHREADS * ITEMS_PER_THREAD);
    }
    grid += ctas;
    if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  }
  L.first[levels] = (int)grid;
  cudaError_t err;
  if (w2 && vec) {
    auto k = scatter_rows_levels_w2<IdxT, true>;
    if ((err = set_shared(k, shared)) != cudaSuccess) return err;
    k<<<(unsigned)grid, NTHREADS, shared, stream>>>(idx, vals, m, t, skip_zero, out, L);
  } else if (w2) {
    auto k = scatter_rows_levels_w2<IdxT, false>;
    if ((err = set_shared(k, shared)) != cudaSuccess) return err;
    k<<<(unsigned)grid, NTHREADS, shared, stream>>>(idx, vals, m, t, skip_zero, out, L);
  } else if (v4) {
    scatter_rows_levels_v4<IdxT><<<(unsigned)grid, NTHREADS, 0, stream>>>(
        idx, reinterpret_cast<const float4*>(vals), m, lanes, t, skip_zero, out, L);
  } else {
    scatter_rows_levels_any<IdxT><<<(unsigned)grid, NTHREADS, 0, stream>>>(idx, vals, m, w, t, skip_zero,
                                                                           out, L);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* xr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// 1 when the 8- and 16-byte reductions are compiled in, 0 when the toolkit
// predates them and every addition is a scalar one.
int xr_scatter_add_rows_vectorised() { return XR_VECTOR_RED; }

// The most levels a launch takes, and the most shared memory a SHARED-mode
// level's table may use (bytes).
int xr_scatter_add_rows_max_levels() { return MAX_LEVELS; }
int xr_scatter_add_rows_max_shared_bytes() { return MAX_SHARED_BYTES; }

// out [levels, t, w] += vals [levels, m, w] at rows idx [levels, m] (int32
// ids) of each level, rows[l] the row count of level l (ids >= rows[l] are
// dropped), modes[l] its mode (0 shared or 1 aggregate for w == 2, 2 plain
// for other widths; w == 2 rows at addresses not 8-byte aligned add plainly);
// `out` is zeroed by the caller. m >= 1. Launches on `stream`, does not
// synchronise; returns the cudaError_t of the launch (0 on success).
int xr_scatter_add_rows_levels_i32(const int* idx, const float* vals, int levels, long long m,
                                   int w, long long t, const int* rows, const int* modes,
                                   int skip_zero, float* out, void* stream) {
  return (int)launch<int>(idx, vals, levels, m, w, t, rows, modes, skip_zero, out,
                          (cudaStream_t)stream);
}

// The same with int64 ids.
int xr_scatter_add_rows_levels_i64(const long long* idx, const float* vals, int levels,
                                   long long m, int w, long long t, const int* rows,
                                   const int* modes, int skip_zero, float* out, void* stream) {
  return (int)launch<long long>(idx, vals, levels, m, w, t, rows, modes, skip_zero, out,
                                (cudaStream_t)stream);
}

}  // extern "C"
