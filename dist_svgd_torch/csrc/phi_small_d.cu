// Fused SVGD φ for small feature dims (d ≤ 8), exact f32 and bf16-exp tiers
// and a no-exp timing probe — hand-written for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `_phi_kernel_small_d` (reached
// through `phi_pallas`), together with its `_phi_tail` epilogue, in both of
// its tiers: exact f32 (phi_small_d_launch) and bf16_gram
// (phi_impl='pallas_bf16', here phi_small_d_bf16_launch).
//
// Replaces: tools/pallas_autotune.py, `_noexp_kernel` (reached through
// `phi_noexp`) — the third mode, MODE_NOEXP (phi_small_d_noexp_launch).
// It is this kernel with the exp replaced by the clamped negated distance,
// kv = −min(d², D2_CAP), and no bandwidth (the wrapper passes h = 1): the
// same FMA distance chain, shared tiles, m-split partials and finalize, so
// that T_exact − T_noexp isolates the exp's cost.  It differs from the TPU
// probe on purpose at the ragged edge: the TPU probe pads x with the _FAR
// sentinel and, with no exp to send those columns to 0, sums the padding
// into its result (a huge finite garbage where m is not a multiple of its
// column tile); here the edge is the bounds check of the other two modes,
// so the probe computes the defined function on every shape.  The two
// agree only where the TPU probe pads no columns.
//
// Computes, for every lane l of S and output row i of k:
//
//     K_ij   = exp(−Σ_c (y_ic − x_jc)² / h)               (direct differences)
//     φ(y_i) = (Σ_j K_ij · xs_j + (2/h) · y_i · Σ_j K_ij) / m,
//     xs     = s − (2/h)·x     (formed once by the wrapper in torch)
//
// The bf16 tier (MODE_BF16) rounds the exponent −d²/h to bf16 and
// takes its f32 exp, as the TPU kernel's `jnp.exp(neg.astype(bfloat16))`
// computes in the JAX program (XLA's excess precision keeps the exp's
// result in f32: see phi_small_d_bf16_plain); the drive and the row-sum
// take that K.  Its distance is summed without FMA contraction
// (__fmul_rn/__fadd_rn), the order of the plain version, so that an
// exponent near a bf16 rounding boundary rounds the same way on both
// sides; the exp of the rounded exponent e is ex2.approx(e·log2(e)), within
// ~|e|·2^-23 + 2 ulp of the plain version's expf.
//
// What bounds it on this card: instruction issue and the exp, not memory.
// A north-star call (S=8, k=1250, m=10000, d=3) is 1e8 pairs, the W2
// streaming route's (S=8, k=12,500, m=100,000) 1e10, at ~5d+2 f32 operations
// and one exp each, on under 10 MB of inputs.  At d ≤ 8 there is no matrix
// product worth a tensor core.
// The no-exp probe does ~5d+3 f32 operations a pair and no exp.
//
// What the design does about it:
// - each thread keeps SD_ROWS_PER_THREAD rows (strided by 128 so loads
//   and stores stay coalesced) with their D drive accumulators, row-sum and
//   coordinates in registers; every staged column serves all of them;
// - a column is staged packed, x then xs (SdPack: one float4 at d ≤ 2, two
//   at d = 3 and 4), in tiles of SD_TILE columns;
// - exact tier: the exponent is built in base 2 with the bandwidth folded
//   into the coordinates: the thread's y rows and each staged x tile are
//   scaled once by a = √(log2(e)/h), so K = 2^(−Σ_c (a·y_c − a·x_c)²) is d
//   differences, an FMA chain and one ex2.approx.ftz a pair (2 ulp; K below
//   2^-126 reads 0).  The scaled differences round a·y and a·x apart, an
//   exponent error of ~2·|a(y − x)|·|a·y|·2^-24, which is 1e-5 of the
//   exponent only for |a·y| ≳ 100 with a K of order 1;
// - each thread sums a tile's SD_TILE columns on their own and adds the
//   tile's sums to its running ones, as the TPU kernel sums per column
//   tile: one long chain of f32 adds over a 50,000-column chunk (the
//   100k-particle lanes) drifted 1.2e-4 of max|φ| from the float64 φ on
//   an H100;
// - the output has only S·k rows, so the m axis is split across `nsplit`
//   blocks per row tile (the wrapper's split, SD_BLOCKS_PER_SM); each block
//   writes partial sums and phi_finalize (phi_common.cuh) reduces them in a
//   fixed order — deterministic, no float atomics;
// - the ragged edge is a bounds check (rows outside k are computed and not
//   stored; a short last tile), not the TPU kernel's _FAR padding sentinel;
// - the no-exp probe is a template mode of the same loop, not a copy, with
//   K' = −min(d², D2_CAP) in place of the ex2 (at h = 1, a = 1), so that
//   it times the same loop without the exp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "ot_common.cuh"  // ot_ex2, OT_LOG2E
#include "phi_common.cuh"

constexpr int SD_THREADS = 128;  // threads per block
constexpr int SD_TILE = 256;     // interaction columns per shared-memory tile

// Output rows a thread keeps (ops/cuda_svgd.py:_SD_ROWS_PER_THREAD): of 2, 4
// and 8, 4 and 8 were within 1% at the W2 streaming lanes on an H100 (2 was
// 11% slower), and at 4 a lane of 1250 rows fills 81% of its three blocks
// (61% of two at 8) and d = 8 keeps its 3d + 2 sums a row without spilling.
constexpr int SD_ROWS_PER_THREAD = 4;

// The m-split's target of blocks an SM that the wrapper gives this kernel
// (ops/cuda_svgd.py:_KERNELS; the kernel takes the split as `chunk`,
// `nsplit`), recorded beside the rows a block it was measured with.
constexpr int SD_BLOCKS_PER_SM = 32;

// Width of a packed staged column: the D coordinates of x, then the D of
// xs, zero padded to whole float4s.
template <int D>
struct SdPack {
  static constexpr int W = (2 * D + 3) / 4 * 4;
  static constexpr int V = W / 4;
};

// What K is made of: the exact exp, the exp of a bf16-rounded exponent, or
// the no-exp probe's −min(d², D2_CAP).
constexpr int MODE_EXACT = 0;
constexpr int MODE_BF16 = 1;
constexpr int MODE_NOEXP = 2;
constexpr float D2_CAP = 1e30f;  // pallas_svgd.py:_D2_CAP

// `sc` scales the coordinates of the distance (a = √(log2(e)/h) in the exact
// tier, 1 in the others, where the multiply is exact).
template <int D, int MODE>
__global__ void __launch_bounds__(SD_THREADS)
phi_small_d_partial(const float* __restrict__ y, const float* __restrict__ x,
                    const float* __restrict__ xs, float* __restrict__ part,
                    int S, int k, int m, int x_lane_stride, int chunk,
                    float inv_h, float sc) {
  constexpr int W = SdPack<D>::W;
  constexpr int RB = SD_ROWS_PER_THREAD;
  __shared__ float4 sp[SD_TILE * SdPack<D>::V];
  float* fsp = reinterpret_cast<float*>(sp);

  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int i0 = blockIdx.x * SD_THREADS * RB + threadIdx.x;
  const float* xl = x + (long long)lane * x_lane_stride;
  const float* xsl = xs + (long long)lane * m * D;

  float yv[RB][D], acc[RB][D], ksum[RB];
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const int i = i0 + q * SD_THREADS;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      yv[q][c] = i < k ? y[((long long)lane * k + i) * D + c] * sc : 0.f;
      acc[q][c] = 0.f;
    }
    ksum[q] = 0.f;
  }
  const bool any = i0 < k;  // row q = 0 is this thread's first

  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += SD_TILE) {
    const int n = min(SD_TILE, j1 - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < n * W; e += SD_THREADS) {
      const int j = e / W;
      const int c = e - j * W;
      const long long row = (long long)(t0 + j) * D;
      fsp[e] = c < D ? xl[row + c] * sc : (c < 2 * D ? xsl[row + c - D] : 0.f);
    }
    __syncthreads();
    if (!any) continue;
    // the tile's own sums, added to the running ones once per tile: a
    // thread's chain is at most SD_TILE terms long plus one term a tile,
    // not `chunk` terms (50,000 at the 100k-particle lanes)
    float tacc[RB][D], tks[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      tks[q] = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) tacc[q][c] = 0.f;
    }
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      float xv[W];
#pragma unroll
      for (int v = 0; v < SdPack<D>::V; ++v) {
        const float4 a = sp[j * SdPack<D>::V + v];
        xv[4 * v] = a.x;
        xv[4 * v + 1] = a.y;
        xv[4 * v + 2] = a.z;
        xv[4 * v + 3] = a.w;
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        float kv;
        if constexpr (MODE == MODE_BF16) {
          float d2 = 0.f;
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const float diff = __fsub_rn(yv[q][c], xv[c]);
            d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
          }
          const float e = __bfloat162float(__float2bfloat16_rn(__fmul_rn(-d2, inv_h)));
          kv = ot_ex2(__fmul_rn(e, OT_LOG2E));
        } else {
          float t = 0.f;  // −Σ_c diff², in the scaled coordinates (exact tier)
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const float diff = yv[q][c] - xv[c];
            t = fmaf(-diff, diff, t);
          }
          kv = MODE == MODE_NOEXP ? fmaxf(t, -D2_CAP) : ot_ex2(t);
        }
        tks[q] += kv;
#pragma unroll
        for (int c = 0; c < D; ++c) tacc[q][c] = fmaf(kv, xv[D + c], tacc[q][c]);
      }
    }
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      ksum[q] += tks[q];
#pragma unroll
      for (int c = 0; c < D; ++c) acc[q][c] += tacc[q][c];
    }
  }
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const int i = i0 + q * SD_THREADS;
    if (i < k) {
      float* pr = part + (((long long)split * S + lane) * k + i) * (D + 1);
#pragma unroll
      for (int c = 0; c < D; ++c) pr[c] = acc[q][c];
      pr[D] = ksum[q];
    }
  }
}

template <int D, int MODE>
static cudaError_t launch(const float* y, const float* x, const float* xs,
                          float* part, float* out, int S, int k, int m,
                          int x_lane_stride, int chunk, int nsplit, float inv_h,
                          cudaStream_t stream) {
  constexpr int rows_per_block = SD_THREADS * SD_ROWS_PER_THREAD;
  const dim3 grid((k + rows_per_block - 1) / rows_per_block, S, nsplit);
  const float sc = MODE == MODE_EXACT ? sqrtf(OT_LOG2E * inv_h) : 1.f;
  phi_small_d_partial<D, MODE><<<grid, SD_THREADS, 0, stream>>>(
      y, x, xs, part, S, k, m, x_lane_stride, chunk, inv_h, sc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_phi_finalize(part, y, out, nsplit, S, k, D, m, inv_h, stream);
}

template <int MODE>
static int dispatch(const void* y, const void* x, const void* xs, void* part,
                    void* out, int S, int k, int m, int d, int x_lane_stride,
                    int chunk, int nsplit, float inv_h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* fy = static_cast<const float*>(y);
  const float* fx = static_cast<const float*>(x);
  const float* fxs = static_cast<const float*>(xs);
  float* fpart = static_cast<float*>(part);
  float* fout = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PHI_SMALL_D_CASE(DIM)                                                 \
  case DIM:                                                                   \
    return (int)launch<DIM, MODE>(fy, fx, fxs, fpart, fout, S, k, m,         \
                                  x_lane_stride, chunk, nsplit, inv_h, st);
  switch (d) {
    PHI_SMALL_D_CASE(1)
    PHI_SMALL_D_CASE(2)
    PHI_SMALL_D_CASE(3)
    PHI_SMALL_D_CASE(4)
    PHI_SMALL_D_CASE(5)
    PHI_SMALL_D_CASE(6)
    PHI_SMALL_D_CASE(7)
    PHI_SMALL_D_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PHI_SMALL_D_CASE
}

// y (S, k, d); x (m, d) with x_lane_stride 0, or (S, m, d) with stride m·d;
// xs (S, m, d); part (nsplit, S, k, d + 1) scratch; out (S, k, d).  All f32,
// contiguous, on `device`.  Launches on `stream`, allocates nothing, does
// not synchronise; returns the cudaGetLastError() code of the launches.
extern "C" int phi_small_d_launch(const void* y, const void* x, const void* xs,
                                  void* part, void* out, int S, int k, int m,
                                  int d, int x_lane_stride, int chunk,
                                  int nsplit, float inv_h, int device,
                                  void* stream) {
  return dispatch<MODE_EXACT>(y, x, xs, part, out, S, k, m, d, x_lane_stride,
                              chunk, nsplit, inv_h, device, stream);
}

// The bf16 tier: the same arguments and contract.
extern "C" int phi_small_d_bf16_launch(const void* y, const void* x,
                                       const void* xs, void* part, void* out,
                                       int S, int k, int m, int d,
                                       int x_lane_stride, int chunk, int nsplit,
                                       float inv_h, int device, void* stream) {
  return dispatch<MODE_BF16>(y, x, xs, part, out, S, k, m, d, x_lane_stride,
                             chunk, nsplit, inv_h, device, stream);
}

// The no-exp probe: the same arguments and contract; the wrapper passes
// inv_h = 1, which the finalize's (2/h)·y·ksum reads and the partials do
// not.
extern "C" int phi_small_d_noexp_launch(const void* y, const void* x,
                                        const void* xs, void* part, void* out,
                                        int S, int k, int m, int d,
                                        int x_lane_stride, int chunk,
                                        int nsplit, float inv_h, int device,
                                        void* stream) {
  return dispatch<MODE_NOEXP>(y, x, xs, part, out, S, k, m, d, x_lane_stride,
                              chunk, nsplit, inv_h, device, stream);
}
