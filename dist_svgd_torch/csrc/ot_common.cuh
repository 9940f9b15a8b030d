// Shared pieces of the four Sinkhorn kernels (ot_ctransform.cu, ot_kexp.cu,
// ot_kmat_vec.cu, ot_plan_grad.cu), the port of dist_svgd_tpu/ops/pallas_ot.py;
// phi_small_d.cu takes its base-2 exp (ot_ex2, OT_LOG2E) from here too.
//
// Every kernel works on lanes — the emulated shards, each its own problem —
// with rows (S, k, d) and columns (S, m, d), float32, contiguous, d ≤ 8.
// A cost entry is rebuilt on chip as the per-dim differences of the TPU
// kernels' _d2_tile, summed in order WITHOUT FMA contraction (the __f*_rn
// intrinsics) and clamped at _D2_CAP, so that it is bitwise the plain
// PyTorch version's Σ_c (y_c − x_c)² and a comparison of kernel and plain
// version measures the kernel.  The ragged edge is a bounds check; the TPU's
// _FAR padding sentinel and transposed lane-dense layouts are not used.
//
// Which kernels still match their plain version bitwise: ot_kexp (the
// absorbed kernel, one full-precision expf of the plain version's exponent)
// and the hard form of ot_ctransform (a min of the plain version's
// C_ij − p_j).  ot_kmat_vec, ot_plan_grad and the soft ot_ctransform, which
// take 1e10 pairs a call on the 100k streaming route, trade that bitwise
// match for issue slots: they build the exponent in base 2 with FMA
// contraction and take one ex2.approx a pair (ot_exponent2, ot_ex2 below),
// and each thread keeps several output rows.  They are held against the
// plain version in float64 (chip_smoke.py).
#pragma once

#include <cuda_runtime.h>

constexpr int OT_THREADS = 128;      // threads per block of a row kernel
constexpr int OT_TILE = 256;         // columns per shared-memory tile
constexpr int OT_FIN_THREADS = 256;  // threads per block of a finalize kernel

// Output rows a thread of ot_kmat_vec / ot_plan_grad / ot_ctransform keeps:
// each staged column serves this many pairs (ops/cuda_ot.py:
// _KMV_ROWS_PER_THREAD, _PG_ROWS_PER_THREAD, _CT_ROWS_PER_THREAD), the
// fastest of 2, 4 and 8 at the 100k lanes on an H100 (the soft form for
// ot_ctransform), none of them spilling.
constexpr int OT_KMV_ROWS_PER_THREAD = 8;
constexpr int OT_PG_ROWS_PER_THREAD = 4;
constexpr int OT_CT_ROWS_PER_THREAD = 4;

// The m-split's target of blocks an SM that the wrapper gives these three
// kernels (ops/cuda_ot.py:_STREAMING_BLOCKS_PER_SM, _CT_BLOCKS_PER_SM; the
// wrapper computes the split, the kernels take it as `chunk`, `nsplit`):
// recorded here beside the rows a block it was measured with, so that an
// old-against-new timing (tools/ot_ab.py) runs each version at its own.
constexpr int OT_STREAMING_BLOCKS_PER_SM = 32;
constexpr int OT_CT_BLOCKS_PER_SM = 32;

constexpr float OT_D2_CAP = 1e30f;     // pallas_svgd.py:_D2_CAP
constexpr float OT_NEG_HUGE = -3.0e38f;  // pallas_ot.py:_NEG_HUGE, never −inf
constexpr float OT_POS_HUGE = 3.0e38f;   // the hard min's start (pallas_ot.py:175)

// min(Σ_c (y_c − x_c)², _D2_CAP), rounded as the plain version rounds it.
template <int D>
__device__ __forceinline__ float ot_d2(const float* y, const float* x) {
  float d2 = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float diff = __fsub_rn(y[c], x[c]);
    const float sq = __fmul_rn(diff, diff);
    d2 = c == 0 ? sq : __fadd_rn(d2, sq);
  }
  return fminf(d2, OT_D2_CAP);
}

// Row `row` of a (·, D) array into registers (zeros for an inactive thread).
template <int D>
__device__ __forceinline__ void ot_load_row(const float* __restrict__ a,
                                            long long row, bool active,
                                            float* y) {
#pragma unroll
  for (int c = 0; c < D; ++c) y[c] = active ? a[row * D + c] : 0.f;
}

// (f_i + g_j − d2)·inv_reg, each step rounded as the plain version rounds it.
__device__ __forceinline__ float ot_exponent(float fi, float gj, float d2,
                                             float inv_reg) {
  return __fmul_rn(__fsub_rn(__fadd_rn(fi, gj), d2), inv_reg);
}

// Width of a packed staged column of ot_kmat_vec / ot_plan_grad: the D
// coordinates, then the column potential g_j, zero padded to whole float4s
// (one float4 for D ≤ 3: x0, x1, x2, g).
template <int D>
struct OtPack {
  static constexpr int W = (D + 1 + 3) / 4 * 4;
  static constexpr int V = W / 4;
};

// Stage columns [t0, t0 + n) of one lane's coordinates and potentials as
// packed columns, W floats each.
template <int D>
__device__ __forceinline__ void ot_stage_packed(float* sp,
                                                const float* __restrict__ xl,
                                                const float* __restrict__ gl,
                                                int t0, int n) {
  constexpr int W = OtPack<D>::W;
  for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
    const int j = e / W;
    const int c = e - j * W;
    sp[e] = c < D ? xl[(long long)(t0 + j) * D + c]
                  : (c == D ? gl[t0 + j] : 0.f);
  }
}

// Packed column j into registers (a shared-memory broadcast).
template <int D>
__device__ __forceinline__ void ot_read_packed(const float4* sp, int j,
                                               float* xv) {
  constexpr int V = OtPack<D>::V;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const float4 a = sp[j * V + q];
    xv[4 * q] = a.x;
    xv[4 * q + 1] = a.y;
    xv[4 * q + 2] = a.z;
    xv[4 * q + 3] = a.w;
  }
}

// log2(e): the kernels' base-2 scale is s = inv_reg·log2(e).
constexpr float OT_LOG2E = 1.4426950408889634f;

// The absorbed kernel's exponent in base 2, (f_i + g_j − C_ij)·s, from a
// packed column xv (g_j at xv[D]) and sf = s·f_i: t = g_j − Σ_c (y_c − x_c)²
// in an FMA chain (the direct differences, never ‖y‖² + ‖x‖² − 2y·x, whose
// cancellation far from the origin would cost more than the tolerance),
// then fma(t, s, sf).  3d + 1 instructions; the differences y_c − x_c are
// left in `diff`.  The _D2_CAP clamp is left out: it acts only beyond
// C = 1e30, where the exponent is below −1e29·s while f_i + g_j is finite
// and below 1e29, and a C that overflows to +inf gives −inf; ex2 reads 0 in
// every such case, as the clamped version's exp does.
template <int D>
__device__ __forceinline__ float ot_exponent2(const float* y, const float* xv,
                                              float sf, float s, float* diff) {
  float t = xv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    diff[c] = y[c] - xv[c];
    t = fmaf(-diff[c], diff[c], t);
  }
  return fmaf(t, s, sf);
}

// 2^z on the MUFU pipe: one instruction, within 2 ulp; flushes results below
// 2^-126 to 0 (a row of a real solve holds a term near 1, so a dropped
// subnormal is below 2^-126 of its sum).
__device__ __forceinline__ float ot_ex2(float z) {
  float p;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(z));
  return p;
}

static inline unsigned ot_fin_blocks(long long total) {
  return (unsigned)((total + OT_FIN_THREADS - 1) / OT_FIN_THREADS);
}

// out[idx] = Σ_p part[p][idx] over the m-splits, in split order: no float
// atomics, so a run is bitwise repeatable.
static __global__ void __launch_bounds__(OT_FIN_THREADS)
ot_sum_splits(const float* __restrict__ part, float* __restrict__ out,
              int nsplit, long long total) {
  const long long idx = (long long)blockIdx.x * OT_FIN_THREADS + threadIdx.x;
  if (idx >= total) return;
  float acc = part[idx];
  for (int p = 1; p < nsplit; ++p) acc += part[(long long)p * total + idx];
  out[idx] = acc;
}
