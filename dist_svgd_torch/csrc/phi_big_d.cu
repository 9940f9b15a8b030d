// Fused SVGD φ for feature dims 8 < d ≤ 128, exact f32 tier — hand-written
// for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `_phi_kernel` (reached through
// `phi_pallas`) in its exact tier (Precision.HIGHEST), together with its
// `_phi_tail` epilogue.  The bf16x3 tier (`_dot3`, phi_impl='pallas_bf16')
// is not ported yet.
//
// Computes, for every lane l of S and output row i of k:
//
//     d²_ij  = max(‖y_i‖² + ‖x_j‖² − 2·y_i·x_j, 0)        (the MXU form)
//     K_ij   = exp(−d²_ij / h)
//     φ(y_i) = (Σ_j K_ij · xs_j + (2/h) · y_i · Σ_j K_ij) / m,
//     xs     = s − (2/h)·x     (formed once by the wrapper in torch)
//
// What bounds it on this card: arithmetic.  A north-star call at d = 61 is
// 1e8 pairs at ~4d+6 f32 operations (two length-d products per pair: the
// distance dot and the drive), on a few MB of inputs.  Exactness is pinned to
// f32, so the tensor cores (TF32 / bf16) are off the table in this tier and
// the floor is the FP32 CUDA-core rate.
//
// What the design does about it (a simple, correct first kernel; making it
// fast — 3×TF32 splits on wgmma, deeper register tiles — is later work):
// - a block of 256 threads owns BD_ROWS = 64 output rows of one lane and
//   keeps their y rows and ‖y‖² in shared memory for its whole m range;
// - x and xs stream through shared memory BD_COLS = 64 rows at a time, rows
//   padded to an odd stride so column reads hit distinct banks;
// - phase 1: each thread forms a 4×4 register tile of the 64×64 distance
//   dots, clamps, exps (full-precision expf) and stores the Gram tile in
//   shared memory; columns past the ragged edge are never read;
// - phase 2: four threads share an output row, each holding NQ = ⌈d/4⌉
//   drive accumulators in registers (template: d ≤ 4·NQ), and the row-sum is
//   combined with two warp shuffles in a fixed order;
// - the m axis is split across `nsplit` blocks per row tile (the north star
//   has only 160 row tiles for 132 SMs) and phi_finalize (phi_common.cuh)
//   reduces the partials in a fixed order — deterministic, no float atomics.
#include <cuda_runtime.h>

#include "phi_common.cuh"

constexpr int BD_ROWS = 64;     // output rows per block
constexpr int BD_COLS = 64;     // interaction rows per shared-memory tile
constexpr int BD_THREADS = 256;
constexpr int BD_MAX_D = 128;   // the wrapper refuses larger d

static size_t big_d_smem_bytes(int d) {
  const int ld = d | 1;
  return sizeof(float) * ((size_t)BD_ROWS * ld + 2 * (size_t)BD_COLS * ld +
                          (size_t)BD_ROWS * (BD_COLS + 1) + BD_ROWS + BD_COLS);
}

template <int NQ>
__global__ void __launch_bounds__(BD_THREADS)
phi_big_d_partial(const float* __restrict__ y, const float* __restrict__ x,
                  const float* __restrict__ xs, float* __restrict__ part, int S,
                  int k, int m, int d, int x_lane_stride, int chunk,
                  float inv_h) {
  extern __shared__ float smem[];
  const int ld = d | 1;  // odd row stride: conflict-free column reads
  float* sy = smem;                              // BD_ROWS × ld
  float* sx = sy + BD_ROWS * ld;                 // BD_COLS × ld
  float* sxs = sx + BD_COLS * ld;                // BD_COLS × ld
  float* sk = sxs + BD_COLS * ld;                // BD_ROWS × (BD_COLS + 1)
  float* sy2 = sk + BD_ROWS * (BD_COLS + 1);     // BD_ROWS
  float* sx2 = sy2 + BD_ROWS;                    // BD_COLS
  constexpr int KLD = BD_COLS + 1;

  const int tid = threadIdx.x;
  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int row0 = blockIdx.x * BD_ROWS;
  const float* yl = y + (long long)lane * k * d;
  const float* xl = x + (long long)lane * x_lane_stride;
  const float* xsl = xs + (long long)lane * m * d;

  // the block's y rows (zeros past k) and their squared norms
  for (int e = tid; e < BD_ROWS * d; e += BD_THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    sy[r * ld + c] = row0 + r < k ? yl[(long long)(row0 + r) * d + c] : 0.f;
  }
  __syncthreads();
  if (tid < BD_ROWS) {
    float s2 = 0.f;
    for (int c = 0; c < d; ++c) s2 = fmaf(sy[tid * ld + c], sy[tid * ld + c], s2);
    sy2[tid] = s2;
  }

  // phase-1 mapping: rows ty*4 + a, columns tx + 16*b (a, b < 4)
  const int ty = tid >> 4;
  const int tx = tid & 15;
  // phase-2 mapping: output row ri, drive columns g + 4*q
  const int ri = tid >> 2;
  const int g = tid & 3;
  float acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
  float ksum = 0.f;

  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += BD_COLS) {
    const int n = min(BD_COLS, j1 - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BD_COLS * d; e += BD_THREADS) {
      const int r = e / d;
      const int c = e - r * d;
      const long long off = (long long)(t0 + r) * d + c;
      sx[r * ld + c] = r < n ? xl[off] : 0.f;
      sxs[r * ld + c] = r < n ? xsl[off] : 0.f;
    }
    __syncthreads();
    if (tid < BD_COLS) {
      float s2 = 0.f;
      for (int c = 0; c < d; ++c) s2 = fmaf(sx[tid * ld + c], sx[tid * ld + c], s2);
      sx2[tid] = s2;
    }
    __syncthreads();

    // phase 1: the 64×64 Gram tile
    float dot[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dot[a][b] = 0.f;
    for (int c = 0; c < d; ++c) {
      float ya[4], xb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ya[a] = sy[(ty * 4 + a) * ld + c];
#pragma unroll
      for (int b = 0; b < 4; ++b) xb[b] = sx[(tx + 16 * b) * ld + c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) dot[a][b] = fmaf(ya[a], xb[b], dot[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty * 4 + a;
        const int j = tx + 16 * b;
        const float d2 = fmaxf(sy2[r] + sx2[j] - 2.0f * dot[a][b], 0.f);
        sk[r * KLD + j] = j < n ? expf(-d2 * inv_h) : 0.f;
      }
    }
    __syncthreads();

    // phase 2: drive and row-sum over the tile's n valid columns
    const float* krow = sk + ri * KLD;
    for (int j = 0; j < n; ++j) {
      const float kv = krow[j];
      const float* xsr = sxs + j * ld;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = g + 4 * q;
        if (c < d) acc[q] = fmaf(kv, xsr[c], acc[q]);
      }
    }
    for (int j = g; j < n; j += 4) ksum += krow[j];
  }
  // combine the row-sum partials of the four threads of a row (same warp)
  ksum += __shfl_xor_sync(0xffffffffu, ksum, 1);
  ksum += __shfl_xor_sync(0xffffffffu, ksum, 2);

  const int i = row0 + ri;
  if (i < k) {
    float* pr = part + (((long long)split * S + lane) * k + i) * (d + 1);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = g + 4 * q;
      if (c < d) pr[c] = acc[q];
    }
    if (g == 0) pr[d] = ksum;
  }
}

template <int NQ>
static cudaError_t launch(const float* y, const float* x, const float* xs,
                          float* part, float* out, int S, int k, int m, int d,
                          int x_lane_stride, int chunk, int nsplit, float inv_h,
                          cudaStream_t stream) {
  const size_t smem = big_d_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      phi_big_d_partial<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((k + BD_ROWS - 1) / BD_ROWS, S, nsplit);
  phi_big_d_partial<NQ><<<grid, BD_THREADS, smem, stream>>>(
      y, x, xs, part, S, k, m, d, x_lane_stride, chunk, inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_phi_finalize(part, y, out, nsplit, S, k, d, m, inv_h, stream);
}

// y (S, k, d); x (m, d) with x_lane_stride 0, or (S, m, d) with stride m·d;
// xs (S, m, d); part (nsplit, S, k, d + 1) scratch; out (S, k, d).  All f32,
// contiguous, on `device`; 8 < d ≤ 128.  Launches on `stream`, allocates
// nothing, does not synchronise; returns the cudaGetLastError() code.
extern "C" int phi_big_d_launch(const void* y, const void* x, const void* xs,
                                void* part, void* out, int S, int k, int m,
                                int d, int x_lane_stride, int chunk, int nsplit,
                                float inv_h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > BD_MAX_D) return (int)cudaErrorInvalidValue;
  const float* fy = static_cast<const float*>(y);
  const float* fx = static_cast<const float*>(x);
  const float* fxs = static_cast<const float*>(xs);
  float* fpart = static_cast<float*>(part);
  float* fout = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 16)
    return (int)launch<4>(fy, fx, fxs, fpart, fout, S, k, m, d, x_lane_stride,
                          chunk, nsplit, inv_h, st);
  if (d <= 32)
    return (int)launch<8>(fy, fx, fxs, fpart, fout, S, k, m, d, x_lane_stride,
                          chunk, nsplit, inv_h, st);
  if (d <= 64)
    return (int)launch<16>(fy, fx, fxs, fpart, fout, S, k, m, d, x_lane_stride,
                           chunk, nsplit, inv_h, st);
  return (int)launch<32>(fy, fx, fxs, fpart, fout, S, k, m, d, x_lane_stride,
                         chunk, nsplit, inv_h, st);
}
