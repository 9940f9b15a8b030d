// Row-wise c-transform of the squared-distance cost without building C —
// hand-written for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_ot.py, `_ct_kernel` (reached through
// `ctransform_reduce`).
//
// Computes, for every lane l of S and output row i of k, against the lane's
// m columns x_j with potentials p_j:
//
//     hard:  out_i = min_j (C_ij − p_j)
//     soft:  out_i = logsumexp_j ((p_j − C_ij) · inv_reg)
//     C_ij = min(Σ_c (y_ic − x_jc)², _D2_CAP)            (ot_common.cuh)
//
// The soft form keeps an online (max, sum) pair per row: the running max
// starts at _NEG_HUGE = −3e38 (never −inf, so no inf − inf), the hard min at
// +3e38.
//
// What bounds it on this card: arithmetic.  A north-star call is 8 × 1250 ×
// 10,000 = 1e8 pairs (or the transposed 8 × 10,000 × 1,250) at 3d+2
// operations a pair (hard) or 3d+5 and one exp (soft), on under 1 MB of
// inputs; the FP32 and SFU (exp) pipes set the floor, not HBM.
//
// What the design does about it:
// - one thread per output row keeps its row and its running pair in
//   registers; the lane's columns and potentials stream through shared
//   memory in tiles of OT_TILE, padded to 4 or 8 floats a row so that a
//   column is one or two float4 broadcasts;
// - 1,250 rows per lane are too few to fill 132 SMs, so the m axis is split
//   across `nsplit` blocks per row tile (the wrapper's _split_m) and
//   ot_ctransform_finalize merges the per-split pairs in split order —
//   min for hard, M = max(m_a, m_b), s = s_a·e^(m_a−M) + s_b·e^(m_b−M) for
//   soft — deterministic, no float atomics;
// - the ragged edge is a bounds check; exp is the full-precision expf (no
//   fast math).
#include <cuda_runtime.h>

#include "ot_common.cuh"

template <int D, bool SOFT>
__global__ void __launch_bounds__(OT_THREADS)
ot_ctransform_partial(const float* __restrict__ rows,
                      const float* __restrict__ cols,
                      const float* __restrict__ pot, float* __restrict__ part,
                      int S, int k, int m, int chunk, float inv_reg) {
  constexpr int DP = OtRow<D>::DP;
  __shared__ float4 sx[OT_TILE * OtRow<D>::DV];
  __shared__ float sp[OT_TILE];

  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int i = blockIdx.x * OT_THREADS + threadIdx.x;
  const bool active = i < k;
  const float* xl = cols + (long long)lane * m * D;
  const float* pl = pot + (long long)lane * m;

  float yi[D];
  ot_load_row<D>(rows, (long long)lane * k + i, active, yi);
  float run = SOFT ? OT_NEG_HUGE : OT_POS_HUGE;  // running max / min
  float s = 0.f;                                 // running sum (soft)

  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += OT_TILE) {
    const int n = min(OT_TILE, j1 - t0);
    __syncthreads();  // the previous tile's readers are done
    ot_stage_cols<D>(reinterpret_cast<float*>(sx), xl, t0, n);
    ot_stage_vec(sp, pl + t0, n);
    __syncthreads();
    if (active) {
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float xv[DP];
        ot_read_col<D>(sx, j, xv);
        const float d2 = ot_d2<D>(yi, xv);
        if (SOFT) {
          const float e = __fmul_rn(__fsub_rn(sp[j], d2), inv_reg);
          if (e > run) {
            s = fmaf(s, expf(run - e), 1.f);
            run = e;
          } else {
            s += expf(e - run);
          }
        } else {
          run = fminf(run, __fsub_rn(d2, sp[j]));
        }
      }
    }
  }
  if (active) {
    float* pr = part + (((long long)split * S + lane) * k + i) * 2;
    pr[0] = run;
    pr[1] = s;
  }
}

template <bool SOFT>
__global__ void __launch_bounds__(OT_FIN_THREADS)
ot_ctransform_finalize(const float* __restrict__ part, float* __restrict__ out,
                       int nsplit, long long rows) {
  const long long idx = (long long)blockIdx.x * OT_FIN_THREADS + threadIdx.x;
  if (idx >= rows) return;
  float run = part[idx * 2];
  float s = part[idx * 2 + 1];
  for (int p = 1; p < nsplit; ++p) {
    const float* pr = part + ((long long)p * rows + idx) * 2;
    if (SOFT) {
      const float mx = fmaxf(run, pr[0]);
      s = s * expf(run - mx) + pr[1] * expf(pr[0] - mx);
      run = mx;
    } else {
      run = fminf(run, pr[0]);
    }
  }
  out[idx] = SOFT ? run + logf(s) : run;
}

template <int D, bool SOFT>
static cudaError_t launch(const float* rows, const float* cols,
                          const float* pot, float* part, float* out, int S,
                          int k, int m, int chunk, int nsplit, float inv_reg,
                          cudaStream_t stream) {
  const dim3 grid((k + OT_THREADS - 1) / OT_THREADS, S, nsplit);
  ot_ctransform_partial<D, SOFT><<<grid, OT_THREADS, 0, stream>>>(
      rows, cols, pot, part, S, k, m, chunk, inv_reg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)S * k;
  ot_ctransform_finalize<SOFT><<<ot_fin_blocks(total), OT_FIN_THREADS, 0,
                                 stream>>>(part, out, nsplit, total);
  return cudaGetLastError();
}

// rows (S, k, d); cols (S, m, d); pot (S, m); part (nsplit, S, k, 2)
// scratch; out (S, k).  All f32, contiguous, on `device`.  Launches on
// `stream`, allocates nothing, does not synchronise; returns the
// cudaGetLastError() code of the launches.
extern "C" int ot_ctransform_launch(const void* rows, const void* cols,
                                    const void* pot, void* part, void* out,
                                    int S, int k, int m, int d, int chunk,
                                    int nsplit, int soft, float inv_reg,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* fr = static_cast<const float*>(rows);
  const float* fc = static_cast<const float*>(cols);
  const float* fp = static_cast<const float*>(pot);
  float* fpart = static_cast<float*>(part);
  float* fout = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OT_CT_CASE(DIM)                                                      \
  case DIM:                                                                  \
    return soft ? (int)launch<DIM, true>(fr, fc, fp, fpart, fout, S, k, m,   \
                                         chunk, nsplit, inv_reg, st)         \
                : (int)launch<DIM, false>(fr, fc, fp, fpart, fout, S, k, m,  \
                                          chunk, nsplit, inv_reg, st);
  switch (d) {
    OT_CT_CASE(1)
    OT_CT_CASE(2)
    OT_CT_CASE(3)
    OT_CT_CASE(4)
    OT_CT_CASE(5)
    OT_CT_CASE(6)
    OT_CT_CASE(7)
    OT_CT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OT_CT_CASE
}
