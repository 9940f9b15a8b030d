// The absorbed Sinkhorn kernel written out as a matrix, C recomputed on the
// fly — hand-written for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_ot.py, `_kexp_kernel` (reached through
// `kexp`).
//
// Computes, for every lane l of S, row i of k and column j of m:
//
//     out_lij = exp((f_i + g_j − C_ij) · inv_reg),
//     C_ij    = min(Σ_c (y_ic − x_jc)², _D2_CAP)          (ot_common.cuh)
//
// What bounds it on this card: bytes.  It reads O((k + m)·d) floats and
// writes S·k·m of them: at the north star 8 × 1250 × 10,000 × 4 B = 400 MB a
// call, 0.12 ms at 3.35 TB/s, while its 3d+4 operations and one exp a pair
// (1e8 pairs) need about a sixth of that at the FP32 peak.
//
// What the design does about it:
// - a thread owns four consecutive columns of one lane: their coordinates
//   and g sit in registers, and it walks KX_ROWS rows (staged once per block
//   in shared memory), so each output element costs one store and no loads;
// - a warp stores 32 × 4 consecutive floats of a row — 512 contiguous bytes
//   as 16-byte float4 stores, aligned whenever m is a multiple of 4 (the
//   VEC instantiation); otherwise the same layout stores floats one by one;
// - the ragged edge is a bounds check; exp is the full-precision expf, and
//   the exponent is rounded step by step as the plain version rounds it.
#include <cuda_runtime.h>

#include "ot_common.cuh"

constexpr int KX_THREADS = 256;
constexpr int KX_COLS = 4 * KX_THREADS;  // columns per block, four a thread
constexpr int KX_ROWS = 16;              // rows per block

template <int D, bool VEC>
__global__ void __launch_bounds__(KX_THREADS)
ot_kexp_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
               const float* __restrict__ f, const float* __restrict__ g,
               float* __restrict__ out, int k, int m, float inv_reg) {
  __shared__ float sy[KX_ROWS * D];
  __shared__ float sf[KX_ROWS];

  const int lane = blockIdx.z;
  const int i0 = blockIdx.y * KX_ROWS;
  const int jb = blockIdx.x * KX_COLS + 4 * threadIdx.x;
  const int nrows = min(KX_ROWS, k - i0);

  const float* yl = rows + ((long long)lane * k + i0) * D;
  for (int e = threadIdx.x; e < nrows * D; e += KX_THREADS) sy[e] = yl[e];
  for (int e = threadIdx.x; e < nrows; e += KX_THREADS)
    sf[e] = f[(long long)lane * k + i0 + e];
  __syncthreads();
  if (jb >= m) return;

  float xc[4][D], gc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool valid = jb + q < m;
    const long long j = (long long)lane * m + jb + q;
#pragma unroll
    for (int c = 0; c < D; ++c) xc[q][c] = valid ? cols[j * D + c] : 0.f;
    gc[q] = valid ? g[j] : 0.f;
  }

  for (int r = 0; r < nrows; ++r) {
    float yi[D];
#pragma unroll
    for (int c = 0; c < D; ++c) yi[c] = sy[r * D + c];
    const float fi = sf[r];
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = expf(ot_exponent(fi, gc[q], ot_d2<D>(yi, xc[q]), inv_reg));
    float* orow = out + ((long long)lane * k + i0 + r) * m + jb;
    if (VEC) {
      *reinterpret_cast<float4*>(orow) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (jb + q < m) orow[q] = v[q];
    }
  }
}

template <int D>
static cudaError_t launch(const float* rows, const float* cols, const float* f,
                          const float* g, float* out, int S, int k, int m,
                          float inv_reg, cudaStream_t stream) {
  const dim3 grid((m + KX_COLS - 1) / KX_COLS, (k + KX_ROWS - 1) / KX_ROWS, S);
  if (m % 4 == 0)
    ot_kexp_kernel<D, true><<<grid, KX_THREADS, 0, stream>>>(
        rows, cols, f, g, out, k, m, inv_reg);
  else
    ot_kexp_kernel<D, false><<<grid, KX_THREADS, 0, stream>>>(
        rows, cols, f, g, out, k, m, inv_reg);
  return cudaGetLastError();
}

// rows (S, k, d); cols (S, m, d); f (S, k); g (S, m); out (S, k, m).  All
// f32, contiguous, on `device`; out 16-byte aligned (a torch allocation).
// Launches on `stream`, allocates nothing, does not synchronise; returns the
// cudaGetLastError() code of the launch.
extern "C" int ot_kexp_launch(const void* rows, const void* cols, const void* f,
                              const void* g, void* out, int S, int k, int m,
                              int d, float inv_reg, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* fr = static_cast<const float*>(rows);
  const float* fc = static_cast<const float*>(cols);
  const float* ff = static_cast<const float*>(f);
  const float* fg = static_cast<const float*>(g);
  float* fout = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OT_KEXP_CASE(DIM) \
  case DIM:               \
    return (int)launch<DIM>(fr, fc, ff, fg, fout, S, k, m, inv_reg, st);
  switch (d) {
    OT_KEXP_CASE(1)
    OT_KEXP_CASE(2)
    OT_KEXP_CASE(3)
    OT_KEXP_CASE(4)
    OT_KEXP_CASE(5)
    OT_KEXP_CASE(6)
    OT_KEXP_CASE(7)
    OT_KEXP_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OT_KEXP_CASE
}
