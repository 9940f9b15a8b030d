// Streaming product of the absorbed Sinkhorn kernel with a few right-hand
// sides, the kernel rebuilt tile by tile — hand-written for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_ot.py, `_kmat_vec_kernel` (reached
// through `kmat_vec`).
//
// Computes, for every lane l of S and output row i of k:
//
//     out_ic = Σ_j P_ij · R_jc,   c < r ≤ 8,
//     P_ij   = exp((f_i + g_j − C_ij) · inv_reg),
//     C_ij   = Σ_c (y_ic − x_jc)²
//
// Pᵀu is the same call with rows and columns (and f and g) swapped.  No
// (k, m) buffer exists: memory is O((k + m)·(d + r)).
//
// What bounds it on this card: instruction issue.  On the 100k streaming
// path one call is 8 × 12,500 × 100,000 = 1e10 pairs on ~10 MB of inputs.
// An SM issues 128 thread-instructions a clock over all pipes, and its MUFU
// pipe takes 16 exps a clock: at ~9 instructions and one exp a pair the two
// floors are ~2.8 and ~2.4 ms.
//
// What the design does about it:
// - each thread keeps OT_KMV_ROWS_PER_THREAD = 8 rows (1024 a block, strided
//   by 128 so loads and stores stay coalesced) with their coordinates, s·f_i
//   and accumulators in registers; every staged column is read from shared
//   memory once for all of them, and their independent exp and FMA chains
//   hide each other's latency;
// - a column is staged packed with its potential — (x0, x1, x2, g) is one
//   float4 broadcast at d ≤ 3 (ot_common.cuh:OtPack) — and R beside it;
// - the exponent is built in base 2 (ot_common.cuh:ot_exponent2): the FMA
//   chain t = g_j − Σ_c (y_c − x_c)², then fma(t, s, s·f_i) with s =
//   inv_reg·log2(e), and P = ex2.approx.ftz (one MUFU op; within 2 ulp, and
//   the exponent's rounding ~|f| + |g| ulps of it, far inside the 1e-4 of
//   the parity rows) — 3d + 1 FP32 instructions, one exp and r FMAs a pair;
// - each tile is summed on its own and then added to the running sums (two
//   levels), so a float32 chain is OT_TILE terms long, not m / nsplit: at
//   m = 100,000 one sequential chain lost ~3e-5 of the sum;
// - the m axis is split across `nsplit` blocks per row tile when the rows
//   alone cannot fill 132 SMs (one lane of 12,500 rows is 13 blocks), and
//   ot_sum_splits adds the per-split partials in split order —
//   deterministic, no float atomics;
// - instantiated for r = 1 (the scaling loop's matvec) and for r ≤ 8 with
//   eight register accumulators a row and a uniform runtime bound;
// - the ragged edge is a bounds check: a thread computes all of its rows and
//   stores the ones inside k; a thread with none skips the tiles' work.
#include <cuda_runtime.h>

#include "ot_common.cuh"

template <int D, int R>
__global__ void __launch_bounds__(OT_THREADS)
ot_kmat_vec_partial(const float* __restrict__ rows,
                    const float* __restrict__ cols,
                    const float* __restrict__ f, const float* __restrict__ g,
                    const float* __restrict__ rhs, float* __restrict__ part,
                    int S, int k, int m, int r, int chunk, float s) {
  constexpr int W = OtPack<D>::W;
  constexpr int RB = OT_KMV_ROWS_PER_THREAD;
  __shared__ float4 sp[OT_TILE * OtPack<D>::V];
  __shared__ __align__(16) float sr[OT_TILE * R];

  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int i0 = blockIdx.x * OT_THREADS * RB + threadIdx.x;
  const float* xl = cols + (long long)lane * m * D;
  const float* gl = g + (long long)lane * m;
  const float* rl = rhs + (long long)lane * m * r;

  float y[RB][D], sf[RB], acc[RB][R];
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const int i = i0 + q * OT_THREADS;
    ot_load_row<D>(rows, (long long)lane * k + i, i < k, y[q]);
    sf[q] = i < k ? s * f[(long long)lane * k + i] : 0.f;
#pragma unroll
    for (int c = 0; c < R; ++c) acc[q][c] = 0.f;
  }
  const bool any = i0 < k;  // row q = 0 is this thread's first

  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += OT_TILE) {
    const int n = min(OT_TILE, j1 - t0);
    __syncthreads();  // the previous tile's readers are done
    ot_stage_packed<D>(reinterpret_cast<float*>(sp), xl, gl, t0, n);
    for (int e = threadIdx.x; e < n * r; e += OT_THREADS) {
      const int j = e / r;
      sr[j * R + (e - j * r)] = rl[(long long)t0 * r + e];
    }
    __syncthreads();
    if (any) {
      float tacc[RB][R];  // this tile's sums, added to acc once per tile
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int c = 0; c < R; ++c) tacc[q][c] = 0.f;
      // four columns an iteration for r = 1; two for r ≤ 8, where a
      // thread's 2 × 64 sums leave no registers for four without spilling
#pragma unroll (R == 1 ? 4 : 2)
      for (int j = 0; j < n; ++j) {
        float xv[W], rv[R], diff[D];
        ot_read_packed<D>(sp, j, xv);
#pragma unroll
        for (int c = 0; c < R; ++c) rv[c] = sr[j * R + c];
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          const float pv = ot_ex2(ot_exponent2<D>(y[q], xv, sf[q], s, diff));
#pragma unroll
          for (int c = 0; c < R; ++c)
            if (R == 1 || c < r) tacc[q][c] = fmaf(pv, rv[c], tacc[q][c]);
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[q][c] += tacc[q][c];
    }
  }
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const int i = i0 + q * OT_THREADS;
    if (i < k) {
      float* pr = part + (((long long)split * S + lane) * k + i) * r;
#pragma unroll
      for (int c = 0; c < R; ++c)
        if (R == 1 || c < r) pr[c] = acc[q][c];
    }
  }
}

template <int D, int R>
static cudaError_t launch(const float* rows, const float* cols, const float* f,
                          const float* g, const float* rhs, float* part,
                          float* out, int S, int k, int m, int r, int chunk,
                          int nsplit, float inv_reg, cudaStream_t stream) {
  constexpr int rows_per_block = OT_THREADS * OT_KMV_ROWS_PER_THREAD;
  const dim3 grid((k + rows_per_block - 1) / rows_per_block, S, nsplit);
  ot_kmat_vec_partial<D, R><<<grid, OT_THREADS, 0, stream>>>(
      rows, cols, f, g, rhs, part, S, k, m, r, chunk, inv_reg * OT_LOG2E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)S * k * r;
  ot_sum_splits<<<ot_fin_blocks(total), OT_FIN_THREADS, 0, stream>>>(
      part, out, nsplit, total);
  return cudaGetLastError();
}

// rows (S, k, d); cols (S, m, d); f (S, k); g (S, m); rhs (S, m, r);
// part (nsplit, S, k, r) scratch; out (S, k, r).  All f32, contiguous, on
// `device`.  Launches on `stream`, allocates nothing, does not synchronise;
// returns the cudaGetLastError() code of the launches.
extern "C" int ot_kmat_vec_launch(const void* rows, const void* cols,
                                  const void* f, const void* g,
                                  const void* rhs, void* part, void* out,
                                  int S, int k, int m, int d, int r, int chunk,
                                  int nsplit, float inv_reg, int device,
                                  void* stream) {
  if (r < 1 || r > 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* fr = static_cast<const float*>(rows);
  const float* fc = static_cast<const float*>(cols);
  const float* ff = static_cast<const float*>(f);
  const float* fg = static_cast<const float*>(g);
  const float* frhs = static_cast<const float*>(rhs);
  float* fpart = static_cast<float*>(part);
  float* fout = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OT_KMV_CASE(DIM)                                                      \
  case DIM:                                                                   \
    return r == 1 ? (int)launch<DIM, 1>(fr, fc, ff, fg, frhs, fpart, fout, S, \
                                        k, m, r, chunk, nsplit, inv_reg, st)  \
                  : (int)launch<DIM, 8>(fr, fc, ff, fg, frhs, fpart, fout, S, \
                                        k, m, r, chunk, nsplit, inv_reg, st);
  switch (d) {
    OT_KMV_CASE(1)
    OT_KMV_CASE(2)
    OT_KMV_CASE(3)
    OT_KMV_CASE(4)
    OT_KMV_CASE(5)
    OT_KMV_CASE(6)
    OT_KMV_CASE(7)
    OT_KMV_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OT_KMV_CASE
}
