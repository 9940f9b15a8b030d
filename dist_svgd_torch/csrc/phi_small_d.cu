// Fused SVGD φ for small feature dims (d ≤ 8), exact f32 and bf16-exp tiers
// — hand-written for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `_phi_kernel_small_d` (reached
// through `phi_pallas`), together with its `_phi_tail` epilogue, in both of
// its tiers: exact f32 (phi_small_d_launch) and bf16_gram
// (phi_impl='pallas_bf16', here phi_small_d_bf16_launch).
//
// Computes, for every lane l of S and output row i of k:
//
//     K_ij   = exp(−Σ_c (y_ic − x_jc)² / h)               (direct differences)
//     φ(y_i) = (Σ_j K_ij · xs_j + (2/h) · y_i · Σ_j K_ij) / m,
//     xs     = s − (2/h)·x     (formed once by the wrapper in torch)
//
// The bf16 tier (template flag BF16) rounds the exponent −d²/h to bf16 and
// takes its f32 exp, as the TPU kernel's `jnp.exp(neg.astype(bfloat16))`
// computes in the JAX program (XLA's excess precision keeps the exp's
// result in f32: see phi_small_d_bf16_plain); the drive and the row-sum
// take that K.  Its distance is summed without FMA contraction
// (__fmul_rn/__fadd_rn), the order of the plain version, so that an
// exponent near a bf16 rounding boundary rounds the same way on both
// sides.
//
// What bounds it on this card: arithmetic, not memory.  A north-star call
// (S=8, k=1250, m=10000, d=3) is 1e8 pairs at ~5d+2 f32 operations and one
// exp each, on under 1 MB of inputs — the FP32 and SFU (exp) pipes set the
// floor, not HBM.  At d ≤ 8 there is no matrix product worth a tensor core.
//
// What the design does about it:
// - one thread per output row keeps its D drive accumulators, its row-sum
//   and its y row in registers (the kernel is templated on D);
// - the interaction rows x and xs stream through shared memory in tiles of
//   SD_TILE columns, padded to 4 or 8 floats a row so that each thread reads
//   a column with one or two float4 broadcasts;
// - the output has only S·k rows (10,000 at the north star: 79 blocks of
//   128 for 132 SMs), so the m axis is split across `nsplit` blocks per row
//   tile; each block writes partial sums and phi_finalize (phi_common.cuh)
//   reduces them in a fixed order — deterministic, no float atomics;
// - the ragged edge is a bounds check (inactive rows, short last tile), not
//   the TPU kernel's _FAR padding sentinel;
// - exp is the full-precision expf: no --use_fast_math, no __expf, so
//   denormals and the f32 tolerance survive.  In the bf16 tier the SFU
//   work is the same and one bf16 rounding is added: it is a precision
//   option, not a faster kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "phi_common.cuh"

constexpr int SD_THREADS = 128;  // output rows per block, one thread each
constexpr int SD_TILE = 256;     // interaction columns per shared-memory tile

template <int D, bool BF16>
__global__ void __launch_bounds__(SD_THREADS)
phi_small_d_partial(const float* __restrict__ y, const float* __restrict__ x,
                    const float* __restrict__ xs, float* __restrict__ part,
                    int S, int k, int m, int x_lane_stride, int chunk,
                    float inv_h) {
  constexpr int DP = D <= 4 ? 4 : 8;  // padded shared row width (float4 reads)
  constexpr int DV = DP / 4;
  __shared__ float4 sx[SD_TILE * DV];
  __shared__ float4 sxs[SD_TILE * DV];
  float* fx = reinterpret_cast<float*>(sx);
  float* fxs = reinterpret_cast<float*>(sxs);

  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int i = blockIdx.x * SD_THREADS + threadIdx.x;
  const bool active = i < k;
  const float* xl = x + (long long)lane * x_lane_stride;
  const float* xsl = xs + (long long)lane * m * D;

  float yi[D], acc[D];
  float ksum = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    yi[c] = active ? y[((long long)lane * k + i) * D + c] : 0.f;
    acc[c] = 0.f;
  }

  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += SD_TILE) {
    const int n = min(SD_TILE, j1 - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < n * DP; e += SD_THREADS) {
      const int j = e / DP;
      const int c = e - j * DP;
      const long long off = (long long)(t0 + j) * D + c;
      fx[e] = c < D ? xl[off] : 0.f;
      fxs[e] = c < D ? xsl[off] : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float xv[DP], sv[DP];
#pragma unroll
        for (int q = 0; q < DV; ++q) {
          const float4 a = sx[j * DV + q];
          const float4 b = sxs[j * DV + q];
          xv[4 * q] = a.x; xv[4 * q + 1] = a.y; xv[4 * q + 2] = a.z; xv[4 * q + 3] = a.w;
          sv[4 * q] = b.x; sv[4 * q + 1] = b.y; sv[4 * q + 2] = b.z; sv[4 * q + 3] = b.w;
        }
        float d2 = 0.f;
        float kv;
        if constexpr (BF16) {
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const float diff = __fsub_rn(yi[c], xv[c]);
            d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
          }
          const float e = __bfloat162float(__float2bfloat16_rn(__fmul_rn(-d2, inv_h)));
          kv = expf(e);
        } else {
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const float diff = yi[c] - xv[c];
            d2 = fmaf(diff, diff, d2);
          }
          kv = expf(-d2 * inv_h);
        }
        ksum += kv;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = fmaf(kv, sv[c], acc[c]);
      }
    }
  }
  if (active) {
    float* pr = part + (((long long)split * S + lane) * k + i) * (D + 1);
#pragma unroll
    for (int c = 0; c < D; ++c) pr[c] = acc[c];
    pr[D] = ksum;
  }
}

template <int D, bool BF16>
static cudaError_t launch(const float* y, const float* x, const float* xs,
                          float* part, float* out, int S, int k, int m,
                          int x_lane_stride, int chunk, int nsplit, float inv_h,
                          cudaStream_t stream) {
  const dim3 grid((k + SD_THREADS - 1) / SD_THREADS, S, nsplit);
  phi_small_d_partial<D, BF16><<<grid, SD_THREADS, 0, stream>>>(
      y, x, xs, part, S, k, m, x_lane_stride, chunk, inv_h);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_phi_finalize(part, y, out, nsplit, S, k, D, m, inv_h, stream);
}

template <bool BF16>
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
    return (int)launch<DIM, BF16>(fy, fx, fxs, fpart, fout, S, k, m,         \
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
  return dispatch<false>(y, x, xs, part, out, S, k, m, d, x_lane_stride, chunk,
                         nsplit, inv_h, device, stream);
}

// The bf16 tier: the same arguments and contract.
extern "C" int phi_small_d_bf16_launch(const void* y, const void* x,
                                       const void* xs, void* part, void* out,
                                       int S, int k, int m, int d,
                                       int x_lane_stride, int chunk, int nsplit,
                                       float inv_h, int device, void* stream) {
  return dispatch<true>(y, x, xs, part, out, S, k, m, d, x_lane_stride, chunk,
                        nsplit, inv_h, device, stream);
}
