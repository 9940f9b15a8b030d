// Fused SVGD φ for feature dims 128 < d ≤ 2432, exact f32 tier — hand-written
// for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `_phi_kernel` (reached through
// `phi_pallas`) in its exact tier (Precision.HIGHEST) beyond the d ≤ 128 of
// phi_big_d.cu, up to the d = 2432 that `fits_vmem_big_d` admits, together
// with its `_phi_tail` epilogue.  The path that runs it is the Bayesian
// neural network of BASELINE.json config 5 (a particle is the flat weight
// vector, d = 753 on boston).
//
// Computes, for every lane l of S and output row i of k:
//
//     d²_ij  = max((‖y_i‖² + ‖x_j‖²) − 2·y_i·x_j, 0)      (the MXU form)
//     K_ij   = exp(−d²_ij / h)                            (masked j ≥ m)
//     φ(y_i) = (Σ_j K_ij · xs_j + (2/h) · y_i · Σ_j K_ij) / m,
//     xs     = s − (2/h)·x     (formed once by the wrapper in torch)
//
// The wrapper passes the row norms ‖y‖² and ‖x‖², summed in torch as the
// plain version sums them.  At the path's h = 1 every off-diagonal K
// underflows and φ rides K_ii, whose d²_ii is the cancellation of three
// numbers near 2‖y‖²: its rounding is that of the y·x sum, so each distance
// dot is summed as an FMA chain over each 64-column chunk, the chunk's
// partial then added to the running sum, which rounds less than one chain
// over all of d (chip_smoke.py's "self h=1" row holds the result against
// the float64 φ).
//
// What bounds it on this card: arithmetic.  A BNN call (500 × 500 pairs at
// d = 753) is 4d + 6 f32 operations a pair, 7.5e8 operations, ~11 µs at the
// 67 TFLOP/s FP32 peak, on ~4.5 MB of inputs; exactness pins the tier to
// the FP32 CUDA cores (no TF32 or bf16 tensor-core products).
//
// What the design does about it (a simple, correct first kernel; register
// tiles fed by wider loads, or 3×TF32 on wgmma, are later work):
// - the d ≤ 128 kernel keeps a block's y rows and two x/xs tiles at full d
//   in shared memory and a row's drive in registers; at d = 753 that is
//   ~595 KB and ~190 registers a thread.  Here the feature axis is tiled:
//   both contractions stream 64-column chunks through shared memory, rows
//   padded to an odd stride so column reads hit distinct banks;
// - the drive accumulator of the block's R output rows (R × d floats) lives
//   in shared memory, R chosen by d so that it fits: 32 rows up to
//   d = 1024 (133 KB at d = 753), 16 rows beyond (182 KB at d = 2432).
//   Each thread owns fixed elements of it, read into registers once per
//   chunk and tile and written back — no other thread touches them;
// - phase 1: each thread forms a (R/16)×4 register tile of the R×64 Gram
//   tile over all chunks, then clamps, exps (full-precision expf), masks
//   the ragged columns and stores K in shared memory;
// - phase 2: for each 64-column chunk of xs, the R×64 block of the
//   accumulator takes K·xs over the tile's valid columns;
// - the m axis is split across `nsplit` blocks per row tile and
//   phi_finalize (phi_common.cuh) reduces the partials in a fixed order —
//   deterministic, no float atomics.  The alternative design, splitting
//   the output columns across blocks with the drive in registers, would
//   recompute the Gram tile ⌈d/128⌉ times (6× the distance work at d = 753).
#include <cuda_runtime.h>

#include "phi_common.cuh"

constexpr int WD_COLS = 64;            // interaction rows per tile
constexpr int WD_DC = 64;              // feature columns per staged chunk
constexpr int WD_THREADS = 256;
constexpr int WD_LDC = WD_DC + 1;      // odd stride of a staged row
constexpr int WD_KLD = WD_COLS + 1;    // odd stride of a K row
constexpr int WD_MAX_D = 2432;         // fits_vmem_big_d's largest d
constexpr int WD_WIDE_ROWS_MAX_D = 1024;  // 32 rows a block up to here, 16 above

// Row stride of the shared accumulator: a multiple of 32 plus the number of
// threads that share a row, so the rows a warp touches fall on distinct banks.
__host__ __device__ constexpr int wide_d_lda(int d, int tpr) {
  return ((d + 31) / 32) * 32 + tpr;
}

template <int R>
static size_t wide_d_smem_bytes(int d) {
  constexpr int TPR = WD_THREADS / R;
  return sizeof(float) * ((size_t)R * wide_d_lda(d, TPR) + (size_t)R * WD_LDC +
                          (size_t)WD_COLS * WD_LDC + (size_t)R * WD_KLD + R +
                          WD_COLS);
}

template <int R>
__global__ void __launch_bounds__(WD_THREADS)
phi_wide_d_partial(const float* __restrict__ y, const float* __restrict__ x,
                   const float* __restrict__ xs, const float* __restrict__ y2,
                   const float* __restrict__ x2, float* __restrict__ part, int S,
                   int k, int m, int d, int x_lane_stride, int chunk,
                   float inv_h) {
  constexpr int RPT = R / 16;             // Gram rows per thread
  constexpr int TPR = WD_THREADS / R;     // threads that share an output row
  constexpr int CPT = WD_DC / TPR;        // drive columns per thread per chunk
  extern __shared__ float smem[];
  const int lda = wide_d_lda(d, TPR);
  float* sacc = smem;                           // R × lda drive accumulator
  float* sy = sacc + R * lda;                   // R × WD_LDC y chunk
  float* sx = sy + R * WD_LDC;                  // WD_COLS × WD_LDC x / xs chunk
  float* sk = sx + WD_COLS * WD_LDC;            // R × WD_KLD Gram tile
  float* sy2 = sk + R * WD_KLD;                 // R
  float* sx2 = sy2 + R;                         // WD_COLS

  const int tid = threadIdx.x;
  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int row0 = blockIdx.x * R;
  const float* yl = y + (long long)lane * k * d;
  const float* xl = x + (long long)lane * x_lane_stride;
  const float* xsl = xs + (long long)lane * m * d;
  const float* y2l = y2 + (long long)lane * k;
  const float* x2l = x2 + (x_lane_stride ? (long long)lane * m : 0LL);

  for (int e = tid; e < R * lda; e += WD_THREADS) sacc[e] = 0.f;
  if (tid < R) sy2[tid] = row0 + tid < k ? y2l[row0 + tid] : 0.f;

  // phase-1 mapping: Gram rows ty*RPT + a, columns tx + 16*b
  const int ty = tid >> 4;
  const int tx = tid & 15;
  // phase-2 mapping: output row ri, drive columns g + TPR*q of each chunk
  const int ri = tid / TPR;
  const int g = tid % TPR;
  float ksum = 0.f;

  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += WD_COLS) {
    const int n = min(WD_COLS, j1 - t0);

    // phase 1: the R×64 distance dots, an FMA chain over each chunk added to
    // the running sum
    float dot[RPT][4];
#pragma unroll
    for (int a = 0; a < RPT; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dot[a][b] = 0.f;
    for (int c0 = 0; c0 < d; c0 += WD_DC) {
      const int nc = min(WD_DC, d - c0);
      __syncthreads();  // the previous readers of sy / sx / sx2 are done
      for (int e = tid; e < R * WD_DC; e += WD_THREADS) {
        const int r = e / WD_DC;
        const int c = e - r * WD_DC;
        sy[r * WD_LDC + c] =
            (row0 + r < k && c < nc) ? yl[(long long)(row0 + r) * d + c0 + c] : 0.f;
      }
      for (int e = tid; e < WD_COLS * WD_DC; e += WD_THREADS) {
        const int r = e / WD_DC;
        const int c = e - r * WD_DC;
        sx[r * WD_LDC + c] =
            (r < n && c < nc) ? xl[(long long)(t0 + r) * d + c0 + c] : 0.f;
      }
      if (c0 == 0 && tid < WD_COLS) sx2[tid] = tid < n ? x2l[t0 + tid] : 0.f;
      __syncthreads();
      float pd[RPT][4];  // this chunk's partial dots, added to the running sums
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) pd[a][b] = 0.f;
      for (int c = 0; c < nc; ++c) {
        float ya[RPT], xb[4];
#pragma unroll
        for (int a = 0; a < RPT; ++a) ya[a] = sy[(ty * RPT + a) * WD_LDC + c];
#pragma unroll
        for (int b = 0; b < 4; ++b) xb[b] = sx[(tx + 16 * b) * WD_LDC + c];
#pragma unroll
        for (int a = 0; a < RPT; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) pd[a][b] = fmaf(ya[a], xb[b], pd[a][b]);
      }
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) dot[a][b] += pd[a][b];
    }
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty * RPT + a;
        const int j = tx + 16 * b;
        // (y² + x²) − 2·yx, the plain version's order (2·yx is exact)
        const float d2 = fmaxf(__fadd_rn(sy2[r], sx2[j]) - 2.0f * dot[a][b], 0.f);
        sk[r * WD_KLD + j] = j < n ? expf(-d2 * inv_h) : 0.f;
      }
    }
    __syncthreads();
    for (int j = g; j < n; j += TPR) ksum += sk[ri * WD_KLD + j];

    // phase 2: the drive, K·xs, one 64-column chunk of xs at a time
    const float* krow = sk + ri * WD_KLD;
    float* arow = sacc + ri * lda;
    for (int c0 = 0; c0 < d; c0 += WD_DC) {
      const int nc = min(WD_DC, d - c0);
      __syncthreads();  // the previous readers of sx are done
      for (int e = tid; e < WD_COLS * WD_DC; e += WD_THREADS) {
        const int r = e / WD_DC;
        const int c = e - r * WD_DC;
        sx[r * WD_LDC + c] =
            (r < n && c < nc) ? xsl[(long long)(t0 + r) * d + c0 + c] : 0.f;
      }
      __syncthreads();
      float acc[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = g + TPR * q;
        acc[q] = c < nc ? arow[c0 + c] : 0.f;
      }
      for (int j = 0; j < n; ++j) {
        const float kv = krow[j];
        const float* xr = sx + j * WD_LDC + g;
#pragma unroll
        for (int q = 0; q < CPT; ++q) acc[q] = fmaf(kv, xr[TPR * q], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = g + TPR * q;
        if (c < nc) arow[c0 + c] = acc[q];
      }
    }
  }
  // combine the row-sum partials of the TPR threads of a row (one warp)
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    ksum += __shfl_xor_sync(0xffffffffu, ksum, off);
  __syncthreads();

  float* pl = part + ((long long)split * S + lane) * k * (d + 1);
  for (int e = tid; e < R * d; e += WD_THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    if (row0 + r < k) pl[(long long)(row0 + r) * (d + 1) + c] = sacc[r * lda + c];
  }
  if (g == 0 && row0 + ri < k) pl[(long long)(row0 + ri) * (d + 1) + d] = ksum;
}

template <int R>
static cudaError_t launch(const float* y, const float* x, const float* xs,
                          const float* y2, const float* x2, float* part, float* out,
                          int S, int k, int m, int d, int x_lane_stride, int chunk,
                          int nsplit, float inv_h, cudaStream_t stream) {
  const size_t smem = wide_d_smem_bytes<R>(d);
  cudaError_t err = cudaFuncSetAttribute(
      phi_wide_d_partial<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((k + R - 1) / R, S, nsplit);
  phi_wide_d_partial<R><<<grid, WD_THREADS, smem, stream>>>(
      y, x, xs, y2, x2, part, S, k, m, d, x_lane_stride, chunk, inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_phi_finalize(part, y, out, nsplit, S, k, d, m, inv_h, stream);
}

// y (S, k, d); x (m, d) with x_lane_stride 0, or (S, m, d) with stride m·d;
// xs (S, m, d); y2 (S, k) and x2 (m) or (S, m) the row norms ‖·‖²;
// part (nsplit, S, k, d + 1) scratch; out (S, k, d).  All f32, contiguous,
// on `device`; 1 ≤ d ≤ 2432 (the wrapper routes 128 < d here); chunk a
// multiple of 64.  Launches on `stream`, allocates nothing, does not
// synchronise; returns the cudaGetLastError() code.
extern "C" int phi_wide_d_launch(const void* y, const void* x, const void* xs,
                                 const void* y2, const void* x2, void* part,
                                 void* out, int S, int k, int m, int d,
                                 int x_lane_stride, int chunk, int nsplit,
                                 float inv_h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > WD_MAX_D || chunk % WD_COLS) return (int)cudaErrorInvalidValue;
  const float* fy = static_cast<const float*>(y);
  const float* fx = static_cast<const float*>(x);
  const float* fxs = static_cast<const float*>(xs);
  const float* fy2 = static_cast<const float*>(y2);
  const float* fx2 = static_cast<const float*>(x2);
  float* fpart = static_cast<float*>(part);
  float* fout = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= WD_WIDE_ROWS_MAX_D)
    return (int)launch<32>(fy, fx, fxs, fy2, fx2, fpart, fout, S, k, m, d,
                           x_lane_stride, chunk, nsplit, inv_h, st);
  return (int)launch<16>(fy, fx, fxs, fy2, fx2, fpart, fout, S, k, m, d,
                         x_lane_stride, chunk, nsplit, inv_h, st);
}
