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
//     C_ij = Σ_c (y_ic − x_jc)²                            (ot_common.cuh)
//
// What bounds it on this card: instruction issue and the exp.  On the 100k
// streaming route the soft form runs twice a W2 step at 8 × 12,500 ×
// 100,000 and 8 × 100,000 × 12,500 = 1e10 pairs on ~10 MB of inputs (the
// solve's warm start); its MUFU floor, one exp a pair at 16 a clock an SM,
// is ~2.4 ms, and ~10 instructions a pair issue in ~3 ms.
//
// What the design does about it (the lines of ot_kmat_vec.cu):
// - each thread keeps OT_CT_ROWS_PER_THREAD rows (strided by 128 so loads
//   and stores stay coalesced) with their coordinates, reference and sums
//   in registers; a staged column serves all of them;
// - a column is staged packed with its potential, (x0, x1, x2, p) one float4
//   broadcast at d ≤ 3 (ot_common.cuh:OtPack);
// - soft: the exponent is built in base 2, z = (p_j − Σ_c (y_c − x_c)²)·s
//   with s = inv_reg·log2(e), as an FMA chain (ot_exponent2) that ends in
//   z − M directly, and each pair takes one ex2.approx.ftz;
// - soft: the running logsumexp keeps a lazily updated reference M per row
//   in place of the running max.  M starts at the row's z of the first
//   column of its chunk, every pair adds 2^(z − M), and only a pair with
//   z − M > OT_CT_TAU rescales (s ·= 2^(M − z), M = z).  The test is one
//   vote a column across the warp (__any_sync), so the warp stays
//   converged and the rare rescale runs as a branch of its own, which
//   recomputes the pair's z for the new M.  Every term is ≤ 2^OT_CT_TAU, so
//   a sum over m ≤ 2^31 columns stays below 2^95, far inside float32; M is
//   always a z the row has seen, so it never passes the row's maximum, the
//   sum holds a term 2^0 = 1, and a term that ex2 flushes to 0 (below
//   2^-126) is below 2^-126 of the sum;
// - soft: each 256-column tile is summed on its own and then added to the
//   running sum (two levels), so a float32 chain is OT_TILE terms long, not
//   m / nsplit: one sequential chain over 50,000 columns drifts;
// - hard: the same row tiling and packed columns, with the plain version's
//   per-dim differences summed without FMA contraction and clamped at
//   _D2_CAP (ot_d2), so its result is bitwise the plain version's; it has no
//   exp and runs only on a solve's cold start;
// - the m axis is split across `nsplit` blocks per row tile when the rows
//   alone cannot fill 132 SMs, and ot_ctransform_finalize merges the
//   per-split pairs in split order — min for hard; for soft, in base 2,
//   M = max(M_a, M_b), s = s_a·2^(M_a − M) + s_b·2^(M_b − M), out =
//   (M + log2 s)·ln 2 — deterministic, no float atomics;
// - the ragged edge is a bounds check: a thread computes all of its rows
//   and stores the ones inside k.
//
// The _D2_CAP clamp is left out of the soft form (ot_exponent2): a C that
// overflows float32 — coordinates beyond ~1e19 — reads as a zero term, and
// a row whose every C overflows returns −inf where the clamped plain
// version returns about −1e30·inv_reg.
#include <cuda_runtime.h>

#include "ot_common.cuh"

// A pair rescales its row's reference when its base-2 exponent lies more
// than this above it (the CPU model of the schedule in
// tests/test_torch_ctransform_rescale.py reads it here).
constexpr float OT_CT_TAU = 64.f;

constexpr float OT_LN2 = 0.6931471805599453f;

template <int D, bool SOFT>
__global__ void __launch_bounds__(OT_THREADS)
ot_ctransform_partial(const float* __restrict__ rows,
                      const float* __restrict__ cols,
                      const float* __restrict__ pot, float* __restrict__ part,
                      int S, int k, int m, int chunk, float s) {
  constexpr int W = OtPack<D>::W;
  constexpr int RB = OT_CT_ROWS_PER_THREAD;
  __shared__ float4 sp[OT_TILE * OtPack<D>::V];

  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int i0 = blockIdx.x * OT_THREADS * RB + threadIdx.x;
  const float* xl = cols + (long long)lane * m * D;
  const float* pl = pot + (long long)lane * m;

  float y[RB][D];
  // soft: −M (the reference, negated so that z − M is one FMA), the running
  // and the tile's sums; hard: the running min in acc
  float negm[RB], acc[RB];
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const int i = i0 + q * OT_THREADS;
    ot_load_row<D>(rows, (long long)lane * k + i, i < k, y[q]);
    negm[q] = 0.f;
    acc[q] = SOFT ? 0.f : OT_POS_HUGE;
  }
  // a warp with no row inside k skips the tiles' work; the vote below runs
  // in whole warps only
  const bool warp_any = __any_sync(0xffffffffu, i0 < k);

  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += OT_TILE) {
    const int n = min(OT_TILE, j1 - t0);
    __syncthreads();  // the previous tile's readers are done
    ot_stage_packed<D>(reinterpret_cast<float*>(sp), xl, pl, t0, n);
    __syncthreads();
    if (!warp_any) continue;
    if (SOFT) {
      float diff[D];
      if (t0 == j0) {  // the reference starts at the chunk's first column
        float xv[W];
        ot_read_packed<D>(sp, 0, xv);
#pragma unroll
        for (int q = 0; q < RB; ++q)
          negm[q] = -fmaxf(ot_exponent2<D>(y[q], xv, 0.f, s, diff), OT_NEG_HUGE);
      }
      float tacc[RB];  // this tile's sums, added to acc once per tile
#pragma unroll
      for (int q = 0; q < RB; ++q) tacc[q] = 0.f;
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float xv[W], dz[RB];
        ot_read_packed<D>(sp, j, xv);
        bool big = false;
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          dz[q] = ot_exponent2<D>(y[q], xv, negm[q], s, diff);  // z − M
          big |= dz[q] > OT_CT_TAU;
        }
        if (__any_sync(0xffffffffu, big)) {
          // rare: move the reference of each row that passed it to the
          // pair's own z, rescaling what the row has summed
#pragma unroll
          for (int q = 0; q < RB; ++q) {
            if (dz[q] > OT_CT_TAU) {
              const float z = ot_exponent2<D>(y[q], xv, 0.f, s, diff);
              const float r = ot_ex2(-dz[q]);
              acc[q] *= r;
              tacc[q] *= r;
              negm[q] = -z;
              dz[q] = 0.f;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < RB; ++q) tacc[q] += ot_ex2(dz[q]);
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) acc[q] += tacc[q];
    } else {
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float xv[W];
        ot_read_packed<D>(sp, j, xv);
#pragma unroll
        for (int q = 0; q < RB; ++q)
          acc[q] = fminf(acc[q], __fsub_rn(ot_d2<D>(y[q], xv), xv[D]));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const int i = i0 + q * OT_THREADS;
    if (i < k) {
      float* pr = part + (((long long)split * S + lane) * k + i) * 2;
      pr[0] = SOFT ? -negm[q] : acc[q];
      pr[1] = SOFT ? acc[q] : 0.f;
    }
  }
}

template <bool SOFT>
__global__ void __launch_bounds__(OT_FIN_THREADS)
ot_ctransform_finalize(const float* __restrict__ part, float* __restrict__ out,
                       int nsplit, long long rows) {
  const long long idx = (long long)blockIdx.x * OT_FIN_THREADS + threadIdx.x;
  if (idx >= rows) return;
  float run = part[idx * 2];  // soft: the base-2 reference M; hard: the min
  float s = part[idx * 2 + 1];
  for (int p = 1; p < nsplit; ++p) {
    const float* pr = part + ((long long)p * rows + idx) * 2;
    if (SOFT) {
      const float mx = fmaxf(run, pr[0]);
      s = s * exp2f(run - mx) + pr[1] * exp2f(pr[0] - mx);
      run = mx;
    } else {
      run = fminf(run, pr[0]);
    }
  }
  out[idx] = SOFT ? (run + log2f(s)) * OT_LN2 : run;
}

template <int D, bool SOFT>
static cudaError_t launch(const float* rows, const float* cols,
                          const float* pot, float* part, float* out, int S,
                          int k, int m, int chunk, int nsplit, float inv_reg,
                          cudaStream_t stream) {
  constexpr int rows_per_block = OT_THREADS * OT_CT_ROWS_PER_THREAD;
  const dim3 grid((k + rows_per_block - 1) / rows_per_block, S, nsplit);
  ot_ctransform_partial<D, SOFT><<<grid, OT_THREADS, 0, stream>>>(
      rows, cols, pot, part, S, k, m, chunk, inv_reg * OT_LOG2E);
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
