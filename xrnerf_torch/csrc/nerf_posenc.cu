// Positional encoding of vanilla NeRF's fused path for Hopper (sm_90a), bound
// with ctypes: both inputs of the fused MLP (fused_nerf_mlp_fwd.cu) in one
// launch.
//
// Replaces no Pallas kernel. The JAX package encodes with posenc_fast
// (xrnerf_tpu/models/embedders/posenc.py), a chain of elementwise operations
// that XLA fuses; run eagerly in PyTorch the same chain
// (xrnerf_torch/models/embedders/posenc.py:posenc_fast) is 29 launches a
// call, each reading and writing a whole [rows, L, 3] float32 tensor, and the
// view encoding is then copied out to every sample of its ray.
//
// What it computes: for each row r < rows (s samples a ray), with p = pts[r]
// and d = dirs[r / s],
//   pts_enc[r]   = [p, sin(2^0 p), cos(2^0 p), ..., sin(2^{L-1} p), cos(2^{L-1} p)]
//   views_enc[r] = the same of d with Ld frequencies,
// 3 (1 + 2 L) and 3 (1 + 2 Ld) floats a row, contiguous. Its arithmetic is
// posenc_fast's, bit for bit: turns = 2^i * (float)(1 / 2 pi),
// tb = x * turns (tb + 0.25 for the cosine), t = tb - rint(tb) (ties to
// even), th = t * (float)(2 pi), then the degree-7 odd polynomial in Horner
// form with its four float32 coefficients. Every product and sum is written
// with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts none of them into
// an FMA and each rounds where torch's separate kernels round.
//
// What bounds it: bytes written. A row reads 12 bytes of point (a direction
// is read once for its s rows) and writes 360 (63 + 27 floats at L = 10,
// Ld = 4), at ~20 float operations a value. The design:
//   - a CTA takes ROWS consecutive rows of both outputs and first stages
//     their points (coalesced) and their rays' directions in shared memory:
//     no expanded copy of the directions exists in device memory;
//   - threads map onto each output's flat range, not onto rows: a thread
//     computes four consecutive floats and writes them with one 16-byte
//     store, so a warp's store is 512 contiguous bytes whatever the row
//     width (63 and 27 are odd; a thread per row would scatter its stores).
//     A tile starts at a multiple of ROWS rows, so every tile's first float
//     is 16-byte aligned; only the very last group of the last tile can be
//     short, and it is written a float at a time;
//   - the per-value work is the arithmetic above and little else: each
//     column's meaning (raw coordinate, or sine or cosine, coordinate and
//     turns) is decoded once a CTA into a table in shared memory; each row's
//     direction is staged beside its point, so no lane divides by s; a
//     thread steps its row and column from one turn of its loop to the next
//     without a division. The lanes of a warp read two or three rows of the
//     staged points and mostly share addresses.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 256;     // rows of a CTA's tile
constexpr int THREADS = 256;  // threads of a CTA
// The fused MLP's padded input widths (ops/fused_nerf_mlp.py: KERNEL_PX, KERNEL_PV): an encoding
// wider than these has no kernel to read it.
constexpr int MAX_PTS_COLS = 64, MAX_VIEW_COLS = 32;

// posenc_fast's constants: Python floats, which torch rounds to float32 (from the double).
constexpr float INV_2PI = (float)0.15915494309189535;
constexpr float TWO_PI = (float)6.283185307179586;
constexpr float C0 = (float)0.9994499860234528, C1 = (float)-0.16583822106984671;
constexpr float C2 = (float)0.00799852029939121, C3 = (float)-0.00014773645626373042;

// sin(2 pi t) as posenc.py:_sin_2pi computes it.
__device__ __forceinline__ float sin_2pi(float t) {
  t = __fsub_rn(t, rintf(t));
  const float th = __fmul_rn(t, TWO_PI);
  const float t2 = __fmul_rn(th, th);
  float p = __fadd_rn(__fmul_rn(t2, C3), C2);
  p = __fadd_rn(__fmul_rn(t2, p), C1);
  p = __fadd_rn(__fmul_rn(t2, p), C0);
  return __fmul_rn(th, p);
}

// What each column of an encoding holds, decoded once a CTA: the raw coordinate
// (RAW, its index in the low two bits), or the sine or cosine (COSINE) of 2^i times a coordinate,
// with turns = 2^i * (float)(1 / 2 pi) beside it. The columns are the raw coordinates first, then
// for each frequency i the sines of 2^i x[0..2] and their cosines.
constexpr unsigned RAW = 4u, COSINE = 8u;

__device__ __forceinline__ void decode_column(int col, float* turns, unsigned char* meta) {
  if (col < 3) {
    turns[col] = 0.0f;
    meta[col] = (unsigned char)(RAW | col);
    return;
  }
  const unsigned k = (unsigned)(col - 3), i = k / 6u, j = k - 6u * i;
  turns[col] = __fmul_rn((float)(1u << i), INV_2PI);  // 2^i exactly, times the float32 1 / (2 pi)
  meta[col] = (unsigned char)(j >= 3u ? COSINE | (j - 3u) : j);
}

// One output's tile: `n` rows of `w` floats from `out`, row r encoding the point src + 3 r. The
// short last group of a ragged tile computes a value or two past the tile from the spare row of
// the staging arrays, and does not store them.
__device__ __forceinline__ void write_tile(float* __restrict__ out, int n, int w, const float* src,
                                           const float* turns, const unsigned char* meta) {
  constexpr int STEP = 4 * THREADS;  // floats a CTA writes in one turn of the loop
  const int count = n * w, step_row = STEP / w, step_col = STEP - step_row * w;
  int row = 4 * threadIdx.x / w, col = 4 * threadIdx.x - row * w;
  for (int f = 4 * threadIdx.x; f < count; f += STEP) {
    int r = row, c = col;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned m = meta[c];
      const float x = src[3 * r + (m & 3u)];
      float tb = __fmul_rn(x, turns[c]);
      if (m & COSINE) tb = __fadd_rn(tb, 0.25f);
      const float e = sin_2pi(tb);
      v[k] = (m & RAW) ? x : e;
      if (++c == w) {  // a group of four crosses at most one row end (w >= 3)
        c = 0;
        ++r;
      }
    }
    if (f + 4 <= count) {
      *reinterpret_cast<float4*>(out + f) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (f + k < count) out[f + k] = v[k];
    }
    col += step_col;
    row += step_row;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    nerf_posenc_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, long long rows,
                       int s, int wp, int wv, float* __restrict__ pts_enc,
                       float* __restrict__ views_enc) {
  // the tile's points, and each row's direction (its ray's), with one spare row each for the
  // short last group of a ragged tile; the columns of both encodings, decoded
  __shared__ float p_s[3 * (ROWS + 1)];
  __shared__ float d_s[3 * (ROWS + 1)];
  __shared__ float turns_s[MAX_PTS_COLS + MAX_VIEW_COLS];
  __shared__ unsigned char meta_s[MAX_PTS_COLS + MAX_VIEW_COLS];
  const long long r0 = (long long)blockIdx.x * ROWS;
  const int n = (int)min((long long)ROWS, rows - r0);
  const long long ray0 = r0 / s;
  const int first = (int)(r0 - ray0 * s);  // the tile's first row's sample within its ray
  for (int i = threadIdx.x; i < 3 * n; i += THREADS) p_s[i] = pts[3 * r0 + i];
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const float* d = dirs + 3 * (ray0 + (first + r) / s);
    d_s[3 * r] = d[0];
    d_s[3 * r + 1] = d[1];
    d_s[3 * r + 2] = d[2];
  }
  if (threadIdx.x < wp) decode_column(threadIdx.x, turns_s, meta_s);
  if (threadIdx.x < wv) decode_column(threadIdx.x, turns_s + MAX_PTS_COLS, meta_s + MAX_PTS_COLS);
  __syncthreads();
  write_tile(pts_enc + r0 * wp, n, wp, p_s, turns_s, meta_s);
  write_tile(views_enc + r0 * wv, n, wv, d_s, turns_s + MAX_PTS_COLS, meta_s + MAX_PTS_COLS);
}

}  // namespace

extern "C" {

const char* xr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// pts [rows, 3] and dirs [rows / s, 3] float32 in; pts_enc [rows, 3 (1 + 2 L)] and
// views_enc [rows, 3 (1 + 2 Ld)] float32 out, all contiguous, the outputs 16-byte aligned; s >= 1
// samples a ray, rows a multiple of s. Launches on `stream`, does not synchronise; returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for arguments out of range).
int xr_nerf_posenc(const float* pts, const float* dirs, long long rows, int s, int L, int Ld,
                   float* pts_enc, float* views_enc, void* stream) {
  const int wp = 3 * (1 + 2 * L), wv = 3 * (1 + 2 * Ld);
  if (rows < 0 || s < 1 || rows % s != 0 || L < 0 || Ld < 0 || wp > MAX_PTS_COLS ||
      wv > MAX_VIEW_COLS || (((uintptr_t)pts_enc | (uintptr_t)views_enc) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + ROWS - 1) / ROWS;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  nerf_posenc_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      pts, dirs, rows, s, wp, wv, pts_enc, views_enc);
  return (int)cudaGetLastError();
}

}  // extern "C"
