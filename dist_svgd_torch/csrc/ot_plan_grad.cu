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
//     C_ij   = min(Σ_c (y_ic − x_jc)², _D2_CAP)            (ot_common.cuh)
//
// The plan never exists in memory.  It is the finish of the streaming
// Sinkhorn solve, once per solve.
//
// What bounds it on this card: arithmetic.  On the 100k streaming path one
// call is 8 × 12,500 × 100,000 = 1e10 pairs at 5d+5 operations and one exp a
// pair, on ~10 MB of inputs: the FP32 and SFU (exp) pipes set the floor.
//
// What the design does about it:
// - phi_small_d.cu's structure: one thread per output row keeps its row,
//   f_i, the d coordinate accumulators and the row sum in registers; the
//   lane's columns and g stream through shared memory in tiles of OT_TILE
//   (padded to 4 or 8 floats for float4 broadcasts), the same staged
//   coordinates serving the distance and the accumulation;
// - each tile is summed on its own and then added to the running sums (two
//   levels), so a float32 chain is OT_TILE terms long, not m / nsplit; the
//   epilogue y·rowsum − acc cancels, so the sums' rounding is what the
//   result's error is made of;
// - the m axis is split across `nsplit` blocks per row tile when the rows
//   cannot fill 132 SMs, and ot_plan_grad_finalize reduces the per-split
//   partials in split order — deterministic, no float atomics — then
//   applies the epilogue y·rowsum − acc;
// - the ragged edge is a bounds check; exp is the full-precision expf.
#include <cuda_runtime.h>

#include "ot_common.cuh"

template <int D>
__global__ void __launch_bounds__(OT_THREADS)
ot_plan_grad_partial(const float* __restrict__ rows,
                     const float* __restrict__ cols,
                     const float* __restrict__ f, const float* __restrict__ g,
                     float* __restrict__ part, int S, int k, int m, int chunk,
                     float inv_reg) {
  constexpr int DP = OtRow<D>::DP;
  __shared__ float4 sx[OT_TILE * OtRow<D>::DV];
  __shared__ float sg[OT_TILE];

  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int i = blockIdx.x * OT_THREADS + threadIdx.x;
  const bool active = i < k;
  const float* xl = cols + (long long)lane * m * D;
  const float* gl = g + (long long)lane * m;

  float yi[D], acc[D];
  ot_load_row<D>(rows, (long long)lane * k + i, active, yi);
  const float fi = active ? f[(long long)lane * k + i] : 0.f;
  float ksum = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;

  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += OT_TILE) {
    const int n = min(OT_TILE, j1 - t0);
    __syncthreads();  // the previous tile's readers are done
    ot_stage_cols<D>(reinterpret_cast<float*>(sx), xl, t0, n);
    ot_stage_vec(sg, gl + t0, n);
    __syncthreads();
    if (active) {
      float tacc[D], tsum = 0.f;  // this tile's sums, added once per tile
#pragma unroll
      for (int c = 0; c < D; ++c) tacc[c] = 0.f;
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float xv[DP];
        ot_read_col<D>(sx, j, xv);
        const float pv =
            expf(ot_exponent(fi, sg[j], ot_d2<D>(yi, xv), inv_reg));
        tsum += pv;
#pragma unroll
        for (int c = 0; c < D; ++c) tacc[c] = fmaf(pv, xv[c], tacc[c]);
      }
      ksum += tsum;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] += tacc[c];
    }
  }
  if (active) {
    float* pr = part + (((long long)split * S + lane) * k + i) * (D + 1);
#pragma unroll
    for (int c = 0; c < D; ++c) pr[c] = acc[c];
    pr[D] = ksum;
  }
}

// out = y·Σ_p ksum_p − Σ_p acc_p, the splits added in order.
static __global__ void __launch_bounds__(OT_FIN_THREADS)
ot_plan_grad_finalize(const float* __restrict__ part,
                      const float* __restrict__ rows, float* __restrict__ out,
                      int nsplit, long long nrows, int d) {
  const long long idx = (long long)blockIdx.x * OT_FIN_THREADS + threadIdx.x;
  if (idx >= nrows * d) return;
  const long long row = idx / d;
  const int c = (int)(idx - row * d);
  float acc = 0.f, ksum = 0.f;
  for (int p = 0; p < nsplit; ++p) {
    const float* pr = part + ((long long)p * nrows + row) * (d + 1);
    acc += pr[c];
    ksum += pr[d];
  }
  out[idx] = rows[idx] * ksum - acc;
}

template <int D>
static cudaError_t launch(const float* rows, const float* cols, const float* f,
                          const float* g, float* part, float* out, int S,
                          int k, int m, int chunk, int nsplit, float inv_reg,
                          cudaStream_t stream) {
  const dim3 grid((k + OT_THREADS - 1) / OT_THREADS, S, nsplit);
  ot_plan_grad_partial<D><<<grid, OT_THREADS, 0, stream>>>(
      rows, cols, f, g, part, S, k, m, chunk, inv_reg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nrows = (long long)S * k;
  ot_plan_grad_finalize<<<ot_fin_blocks(nrows * D), OT_FIN_THREADS, 0,
                          stream>>>(part, rows, out, nsplit, nrows, D);
  return cudaGetLastError();
}

// rows (S, k, d); cols (S, m, d); f (S, k); g (S, m); part (nsplit, S, k,
// d + 1) scratch; out (S, k, d).  All f32, contiguous, on `device`.
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
