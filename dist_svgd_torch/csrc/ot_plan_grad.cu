// Fused W2 gradient from the Sinkhorn potentials, the plan rebuilt tile by
// tile — hand-written for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_ot.py, `_plan_grad_kernel` (reached
// through `plan_grad`).
//
// Computes, for every lane l of S and output row i of k:
//
//     grad_i = y_i · Σ_j P_ij − Σ_j P_ij · x_j,
//     P_ij   = exp((f_i + g_j − C_ij) · inv_reg),
//     C_ij   = Σ_c (y_ic − x_jc)²
//
// The plan never exists in memory.  It is the finish of the streaming
// Sinkhorn solve, once per solve.
//
// What bounds it on this card: instruction issue.  On the 100k streaming
// path one call is 8 × 12,500 × 100,000 = 1e10 pairs on ~10 MB of inputs.
// An SM issues 128 thread-instructions a clock over all pipes, and its MUFU
// pipe takes 16 exps a clock: at ~12 instructions and one exp a pair the
// two floors are ~3.6 and ~2.4 ms.
//
// What the design does about it (ot_kmat_vec.cu's design, with d sums a row
// in place of r):
// - each thread keeps OT_PG_ROWS_PER_THREAD rows (strided by 128) with their
//   coordinates, s·f_i and d sums in registers; every staged column is read
//   from shared memory once for all of them;
// - a column is staged packed with its potential — (x0, x1, x2, g) is one
//   float4 broadcast at d ≤ 3;
// - the exponent in base 2 (ot_common.cuh:ot_exponent2) and P =
//   ex2.approx.ftz: 3d + 1 FP32 instructions and one exp a pair;
// - the gradient is summed as Σ_j P_ij·(y_i − x_j), d FMAs a pair on the
//   differences the distance already made: the same function as y_i·Σ_j
//   P_ij − Σ_j P_ij·x_j without the row sum's add a pair, and without the
//   epilogue's cancellation of terms tens of times the result;
// - each tile is summed on its own and then added to the running sums (two
//   levels), so a float32 chain is OT_TILE terms long, not m / nsplit;
// - the m axis is split across `nsplit` blocks per row tile when the rows
//   cannot fill 132 SMs, and ot_sum_splits adds the per-split partials in
//   split order — deterministic, no float atomics;
// - the ragged edge is a bounds check: a thread computes all of its rows and
//   stores the ones inside k; a thread with none skips the tiles' work.
#include <cuda_runtime.h>

#include "ot_common.cuh"

template <int D>
__global__ void __launch_bounds__(OT_THREADS)
ot_plan_grad_partial(const float* __restrict__ rows,
                     const float* __restrict__ cols,
                     const float* __restrict__ f, const float* __restrict__ g,
                     float* __restrict__ part, int S, int k, int m, int chunk,
                     float s) {
  constexpr int W = OtPack<D>::W;
  constexpr int RB = OT_PG_ROWS_PER_THREAD;
  __shared__ float4 sp[OT_TILE * OtPack<D>::V];

  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int i0 = blockIdx.x * OT_THREADS * RB + threadIdx.x;
  const float* xl = cols + (long long)lane * m * D;
  const float* gl = g + (long long)lane * m;

  float y[RB][D], sf[RB], acc[RB][D];
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const int i = i0 + q * OT_THREADS;
    ot_load_row<D>(rows, (long long)lane * k + i, i < k, y[q]);
    sf[q] = i < k ? s * f[(long long)lane * k + i] : 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[q][c] = 0.f;
  }
  const bool any = i0 < k;  // row q = 0 is this thread's first

  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += OT_TILE) {
    const int n = min(OT_TILE, j1 - t0);
    __syncthreads();  // the previous tile's readers are done
    ot_stage_packed<D>(reinterpret_cast<float*>(sp), xl, gl, t0, n);
    __syncthreads();
    if (any) {
      float tacc[RB][D];  // this tile's sums, added once per tile
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int c = 0; c < D; ++c) tacc[q][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float xv[W];
        ot_read_packed<D>(sp, j, xv);
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          float diff[D];
          const float pv = ot_ex2(ot_exponent2<D>(y[q], xv, sf[q], s, diff));
#pragma unroll
          for (int c = 0; c < D; ++c) tacc[q][c] = fmaf(pv, diff[c], tacc[q][c]);
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int c = 0; c < D; ++c) acc[q][c] += tacc[q][c];
    }
  }
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const int i = i0 + q * OT_THREADS;
    if (i < k) {
      float* pr = part + (((long long)split * S + lane) * k + i) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) pr[c] = acc[q][c];
    }
  }
}

template <int D>
static cudaError_t launch(const float* rows, const float* cols, const float* f,
                          const float* g, float* part, float* out, int S,
                          int k, int m, int chunk, int nsplit, float inv_reg,
                          cudaStream_t stream) {
  constexpr int rows_per_block = OT_THREADS * OT_PG_ROWS_PER_THREAD;
  const dim3 grid((k + rows_per_block - 1) / rows_per_block, S, nsplit);
  ot_plan_grad_partial<D><<<grid, OT_THREADS, 0, stream>>>(
      rows, cols, f, g, part, S, k, m, chunk, inv_reg * OT_LOG2E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)S * k * D;
  ot_sum_splits<<<ot_fin_blocks(total), OT_FIN_THREADS, 0, stream>>>(
      part, out, nsplit, total);
  return cudaGetLastError();
}

// rows (S, k, d); cols (S, m, d); f (S, k); g (S, m); part (nsplit, S, k,
// d) scratch; out (S, k, d).  All f32, contiguous, on `device`.
// Launches on `stream`, allocates nothing, does not synchronise; returns the
// cudaGetLastError() code of the launches.
extern "C" int ot_plan_grad_launch(const void* rows, const void* cols,
                                   const void* f, const void* g, void* part,
                                   void* out, int S, int k, int m, int d,
                                   int chunk, int nsplit, float inv_reg,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* fr = static_cast<const float*>(rows);
  const float* fc = static_cast<const float*>(cols);
  const float* ff = static_cast<const float*>(f);
  const float* fg = static_cast<const float*>(g);
  float* fpart = static_cast<float*>(part);
  float* fout = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OT_PG_CASE(DIM)                                                     \
  case DIM:                                                                 \
    return (int)launch<DIM>(fr, fc, ff, fg, fpart, fout, S, k, m, chunk,    \
                            nsplit, inv_reg, st);
  switch (d) {
    OT_PG_CASE(1)
    OT_PG_CASE(2)
    OT_PG_CASE(3)
    OT_PG_CASE(4)
    OT_PG_CASE(5)
    OT_PG_CASE(6)
    OT_PG_CASE(7)
    OT_PG_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OT_PG_CASE
}
