// Shared epilogue of the two hand-written φ kernels (phi_small_d.cu,
// phi_big_d.cu).
//
// Both kernels split the interaction axis m across blocks to fill the card
// and write per-split partial sums to a scratch tensor `part` of shape
// (nsplit, S, k, d + 1): columns 0..d-1 hold the drive partials
// Σ_j K_ij (s_j − (2/h) x_j), column d the Gram row-sum partial Σ_j K_ij.
// phi_finalize reduces the splits in a fixed order (no float atomics, so a
// run is bitwise repeatable) and applies the epilogue of the TPU kernels'
// `_phi_tail` (dist_svgd_tpu/ops/pallas_svgd.py):
//
//     φ(y_i) = (acc_i + (2/h) · y_i · ksum_i) / m
#pragma once

#include <cuda_runtime.h>

constexpr int FINALIZE_THREADS = 256;

static __global__ void __launch_bounds__(FINALIZE_THREADS)
phi_finalize(const float* __restrict__ part, const float* __restrict__ y,
             float* __restrict__ out, int nsplit, int S, int k, int d, int m,
             float inv_h) {
  const long long total = (long long)S * k * d;
  const long long idx = (long long)blockIdx.x * FINALIZE_THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long row = idx / d;  // lane * k + i
  const int c = (int)(idx - row * d);
  const long long rows = (long long)S * k;
  float acc = 0.f, ksum = 0.f;
  for (int p = 0; p < nsplit; ++p) {
    const float* pr = part + ((long long)p * rows + row) * (d + 1);
    acc += pr[c];
    ksum += pr[d];
  }
  out[idx] = (acc + (2.0f * inv_h) * y[idx] * ksum) / (float)m;
}

static inline cudaError_t launch_phi_finalize(const float* part, const float* y,
                                              float* out, int nsplit, int S,
                                              int k, int d, int m, float inv_h,
                                              cudaStream_t stream) {
  const long long total = (long long)S * k * d;
  const unsigned blocks =
      (unsigned)((total + FINALIZE_THREADS - 1) / FINALIZE_THREADS);
  phi_finalize<<<blocks, FINALIZE_THREADS, 0, stream>>>(part, y, out, nsplit, S,
                                                        k, d, m, inv_h);
  return cudaGetLastError();
}
