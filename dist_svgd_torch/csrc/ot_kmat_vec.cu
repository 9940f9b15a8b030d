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
//     C_ij   = min(Σ_c (y_ic − x_jc)², _D2_CAP)            (ot_common.cuh)
//
// Pᵀu is the same call with rows and columns (and f and g) swapped.  No
// (k, m) buffer exists: memory is O((k + m)·(d + r)).
//
// What bounds it on this card: arithmetic.  On the 100k streaming path one
// call is 8 × 12,500 × 100,000 = 1e10 pairs at 3d+4+2r operations and one exp
// a pair, on ~10 MB of inputs: the FP32 and SFU (exp) pipes set the floor.
//
// What the design does about it:
// - phi_small_d.cu's structure: one thread per output row keeps its row,
//   f_i and its r accumulators in registers; the lane's columns, g and R
//   stream through shared memory in tiles of OT_TILE (coordinates padded to
//   4 or 8 floats for float4 broadcasts);
// - each tile is summed on its own and then added to the running sums (two
//   levels), so a float32 chain is OT_TILE terms long, not m / nsplit: at
//   m = 100,000 one sequential chain lost ~3e-5 of the sum;
// - the m axis is split across `nsplit` blocks per row tile when the rows
//   alone cannot fill 132 SMs (one lane of 12,500 rows is 98 blocks), and
//   ot_sum_splits adds the per-split partials in split order —
//   deterministic, no float atomics;
// - instantiated for r = 1 (the scaling loop's matvec) and for r ≤ 8 with
//   eight register accumulators and a uniform runtime bound;
// - the ragged edge is a bounds check; exp is the full-precision expf.
#include <cuda_runtime.h>

#include "ot_common.cuh"

template <int D, int R>
__global__ void __launch_bounds__(OT_THREADS)
ot_kmat_vec_partial(const float* __restrict__ rows,
                    const float* __restrict__ cols,
                    const float* __restrict__ f, const float* __restrict__ g,
                    const float* __restrict__ rhs, float* __restrict__ part,
                    int S, int k, int m, int r, int chunk, float inv_reg) {
  constexpr int DP = OtRow<D>::DP;
  __shared__ float4 sx[OT_TILE * OtRow<D>::DV];
  __shared__ float sg[OT_TILE];
  __shared__ float sr[OT_TILE * R];

  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int i = blockIdx.x * OT_THREADS + threadIdx.x;
  const bool active = i < k;
  const float* xl = cols + (long long)lane * m * D;
  const float* gl = g + (long long)lane * m;
  const float* rl = rhs + (long long)lane * m * r;

  float yi[D];
  ot_load_row<D>(rows, (long long)lane * k + i, active, yi);
  const float fi = active ? f[(long long)lane * k + i] : 0.f;
  float acc[R];
#pragma unroll
  for (int c = 0; c < R; ++c) acc[c] = 0.f;

  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += OT_TILE) {
    const int n = min(OT_TILE, j1 - t0);
    __syncthreads();  // the previous tile's readers are done
    ot_stage_cols<D>(reinterpret_cast<float*>(sx), xl, t0, n);
    ot_stage_vec(sg, gl + t0, n);
    for (int e = threadIdx.x; e < n * r; e += OT_THREADS) {
      const int j = e / r;
      sr[j * R + (e - j * r)] = rl[(long long)t0 * r + e];
    }
    __syncthreads();
    if (active) {
      float tacc[R];  // this tile's sums, added to acc once per tile
#pragma unroll
      for (int c = 0; c < R; ++c) tacc[c] = 0.f;
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float xv[DP];
        ot_read_col<D>(sx, j, xv);
        const float pv =
            expf(ot_exponent(fi, sg[j], ot_d2<D>(yi, xv), inv_reg));
#pragma unroll
        for (int c = 0; c < R; ++c)
          if (R == 1 || c < r) tacc[c] = fmaf(pv, sr[j * R + c], tacc[c]);
      }
#pragma unroll
      for (int c = 0; c < R; ++c) acc[c] += tacc[c];
    }
  }
  if (active) {
    float* pr = part + (((long long)split * S + lane) * k + i) * r;
#pragma unroll
    for (int c = 0; c < R; ++c)
      if (R == 1 || c < r) pr[c] = acc[c];
  }
}

template <int D, int R>
static cudaError_t launch(const float* rows, const float* cols, const float* f,
                          const float* g, const float* rhs, float* part,
                          float* out, int S, int k, int m, int r, int chunk,
                          int nsplit, float inv_reg, cudaStream_t stream) {
  const dim3 grid((k + OT_THREADS - 1) / OT_THREADS, S, nsplit);
  ot_kmat_vec_partial<D, R><<<grid, OT_THREADS, 0, stream>>>(
      rows, cols, f, g, rhs, part, S, k, m, r, chunk, inv_reg);
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
