// Fused SVGD φ for feature dims 128 < d ≤ 2432, bf16x3 tier on the tensor
// cores — hand-written for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `_phi_kernel` (reached through
// `phi_pallas`) in its bf16 tier (gram_dtype=bfloat16, phi_impl='pallas_bf16'
// — here 'cuda_bf16') beyond the d ≤ 128 of phi_big_d_bf16x3.cu, up to the
// d = 2432 that `fits_vmem_big_d` admits, where both contractions run as
// `_dot3`'s three-pass bf16 splits, together with its `_phi_tail` epilogue.
//
// Computes, for every lane l of S and output row i of k:
//
//     yx_ij  = hi(y)·hi(x) + hi(y)·lo(x) + lo(y)·hi(x)      (_dot3, f32 sums)
//     d²_ij  = max((‖y_i‖² + ‖x_j‖²) − 2·yx_ij, 0)        (norms in f32)
//     K_ij   = exp(−d²_ij / h)                             (f32, masked j ≥ m)
//     φ(y_i) = (_dot3(K, xs)_i + (2/h) · y_i · Σ_j K_ij) / m,
//     xs     = s − (2/h)·x     (formed once by the wrapper in torch)
//
// with hi(a) = bf16(a) and lo(a) = bf16(a − hi(a)), rounded to nearest even;
// the row-sum is over the unsplit f32 K.  The wrapper passes the norms ‖y‖²
// and ‖x‖², summed in torch as the plain version sums them.
//
// What bounds it on this card: the tensor cores.  A BNN call (500 × 500
// pairs at d = 753) is 12·d bf16 flops a pair (three products of depth d
// for the distance and three for the drive), 2.3e9 flops, ~2.3 µs at the
// 989 TFLOP/s bf16 peak; the per-pair norm form, exp, mask and splits on the
// CUDA cores (8 + 2·⌈d/16⌉ f32 operations a pair) are ~0.4 µs.
//
// What the design does about it (a simple, correct first kernel; wgmma, TMA
// and a pipelined ring of tiles are later work):
// - phi_big_d_bf16x3.cu keeps a warp's 16 rows × dp drive accumulator in
//   registers (384 a thread at dp = 768) and its y rows at full width in
//   shared memory; here the feature axis is tiled in 64-column chunks
//   (four 16-deep k-steps of mma.sync.m16n8k16) and the accumulator of the
//   block's 16 output rows lives in shared memory as f32: 50 KB at
//   d = 753, 156 KB at d = 2432;
// - a block is four warps over one 16-row tile.  For each 64-column tile of
//   x, warp w forms the 16×16 Gram slice of columns 16w..16w+15 over every
//   chunk (y and x chunks split into bf16 hi/lo as they are staged, rows
//   padded to 4 (mod 8) words so fragment loads hit 32 distinct banks);
//   each k-step's three products go into a zeroed fragment that is then
//   added to the running f32 sum, phi_big_d_bf16x3.cu's fresh-fragment
//   summation;
// - the warp turns its Gram fragment into K in registers (norms, clamp,
//   expf, column mask, row-sum), splits it into hi/lo and, by the
//   accumulator-to-A layout identity of m16n8k16, has the A fragment of
//   one drive k-step; the four warps swap these through shared memory, so
//   every warp holds K for the whole tile as four A fragments;
// - the drive streams xs in 64-column chunks, stored transposed so every B
//   fragment is one 32-bit shared load; warp w owns two of each chunk's
//   eight n-tiles of the accumulator, loads them from shared memory, adds
//   the tile's four k-steps and stores them back — no other warp touches
//   them;
// - the m axis is split across `nsplit` blocks per row tile and
//   phi_finalize (phi_common.cuh) reduces the partials in a fixed order —
//   deterministic, no float atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phi_common.cuh"

constexpr int BW_ROWS = 16;              // output rows per block: one m16 tile
constexpr int BW_COLS = 64;              // interaction rows per tile
constexpr int BW_WARPS = 4;
constexpr int BW_THREADS = 32 * BW_WARPS;
constexpr int BW_DC = 64;                // feature columns per chunk (4 k-steps)
constexpr int BW_LDW = BW_DC / 2 + 4;    // words of a staged row (36 ≡ 4 mod 8)
constexpr int BW_LDT = BW_COLS / 2 + 4;  // words of a transposed xs row
constexpr int BW_MAX_D = 2432;           // fits_vmem_big_d's largest d

// Shared-memory layout, in 32-bit words, for a feature dim padded to dpc (a
// multiple of BW_DC): the f32 accumulator rows are dpc + 8 words apart.
struct BwLayout {
  int lda, y_hi, y_lo, x_hi, x_lo, xs_hi, xs_lo, kf, y2, x2, ks, words;
  __host__ __device__ explicit BwLayout(int d) {
    const int dpc = (d + BW_DC - 1) / BW_DC * BW_DC;
    lda = dpc + 8;
    y_hi = BW_ROWS * lda;
    y_lo = y_hi + BW_ROWS * BW_LDW;
    x_hi = y_lo + BW_ROWS * BW_LDW;
    x_lo = x_hi + BW_COLS * BW_LDW;
    xs_hi = x_lo + BW_COLS * BW_LDW;        // BW_DC feature rows × BW_LDT
    xs_lo = xs_hi + BW_DC * BW_LDT;
    kf = xs_lo + BW_DC * BW_LDT;            // 4 warps × 32 lanes × 8 words
    y2 = kf + BW_WARPS * 32 * 8;            // BW_ROWS floats
    x2 = y2 + BW_ROWS;                      // BW_COLS floats
    ks = x2 + BW_COLS;                      // BW_WARPS × BW_ROWS floats
    words = ks + BW_WARPS * BW_ROWS;
  }
};

__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Two floats as a bf16 pair in one register: `a` in the low half (the lower
// column index of an MMA fragment), `b` in the high half.
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// d (16×8, f32) += a (16×16, bf16, row) · b (16×8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three passes of `_dot3` for one fragment, into a zeroed partial that
// is then added to `acc` with f32 round-to-nearest.
__device__ __forceinline__ void dot3_step(float (&acc)[4], const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4], uint32_t bhi0,
                                          uint32_t bhi1, uint32_t blo0,
                                          uint32_t blo1) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(p, ahi, bhi0, bhi1);
  mma_bf16(p, ahi, blo0, blo1);
  mma_bf16(p, alo, bhi0, bhi1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += p[i];
}

__global__ void __launch_bounds__(BW_THREADS)
phi_wide_d_bf16x3_partial(const float* __restrict__ y, const float* __restrict__ x,
                          const float* __restrict__ xs, const float* __restrict__ y2,
                          const float* __restrict__ x2, float* __restrict__ part,
                          int S, int k, int m, int d, int x_lane_stride, int chunk,
                          float inv_h) {
  extern __shared__ uint32_t smem[];
  const BwLayout L(d);
  const int lda = L.lda;
  const int dpc = lda - 8;
  float* sacc = reinterpret_cast<float*>(smem);
  __nv_bfloat16* syh = reinterpret_cast<__nv_bfloat16*>(smem + L.y_hi);
  __nv_bfloat16* syl = reinterpret_cast<__nv_bfloat16*>(smem + L.y_lo);
  __nv_bfloat16* sxh = reinterpret_cast<__nv_bfloat16*>(smem + L.x_hi);
  __nv_bfloat16* sxl = reinterpret_cast<__nv_bfloat16*>(smem + L.x_lo);
  __nv_bfloat16* sxsh = reinterpret_cast<__nv_bfloat16*>(smem + L.xs_hi);
  __nv_bfloat16* sxsl = reinterpret_cast<__nv_bfloat16*>(smem + L.xs_lo);
  uint4* skf = reinterpret_cast<uint4*>(smem + L.kf);
  float* sy2 = reinterpret_cast<float*>(smem + L.y2);
  float* sx2 = reinterpret_cast<float*>(smem + L.x2);
  float* sks = reinterpret_cast<float*>(smem + L.ks);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;
  const int g = ln >> 2;   // fragment row group
  const int t4 = ln & 3;   // thread within the group
  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int row0 = blockIdx.x * BW_ROWS;
  const float* yl = y + (long long)lane * k * d;
  const float* xl = x + (long long)lane * x_lane_stride;
  const float* xsl = xs + (long long)lane * m * d;
  const float* y2l = y2 + (long long)lane * k;
  const float* x2l = x2 + (x_lane_stride ? (long long)lane * m : 0LL);

  for (int e = tid; e < BW_ROWS * lda; e += BW_THREADS) sacc[e] = 0.f;
  if (tid < BW_ROWS) sy2[tid] = row0 + tid < k ? y2l[row0 + tid] : 0.f;
  float ks0 = 0.f, ks1 = 0.f;  // row-sum partials of rows g and g + 8

  const uint32_t* wyh = smem + L.y_hi + g * BW_LDW + t4;
  const uint32_t* wyl = smem + L.y_lo + g * BW_LDW + t4;
  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += BW_COLS) {
    const int n = min(BW_COLS, j1 - t0);

    // the warp's 16×16 Gram slice (n-tiles 2w, 2w + 1), y·xᵀ by _dot3
    float sk[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) sk[h][i] = 0.f;
    for (int c0 = 0; c0 < dpc; c0 += BW_DC) {
      __syncthreads();  // the previous readers of the staged chunks are done
      for (int e = tid; e < BW_ROWS * BW_DC; e += BW_THREADS) {
        const int r = e / BW_DC;
        const int c = e - r * BW_DC;
        const float v = (row0 + r < k && c0 + c < d)
                            ? yl[(long long)(row0 + r) * d + c0 + c] : 0.f;
        split_bf16(v, syh[r * 2 * BW_LDW + c], syl[r * 2 * BW_LDW + c]);
      }
      for (int e = tid; e < BW_COLS * BW_DC; e += BW_THREADS) {
        const int r = e / BW_DC;
        const int c = e - r * BW_DC;
        const float v = (r < n && c0 + c < d) ? xl[(long long)(t0 + r) * d + c0 + c] : 0.f;
        split_bf16(v, sxh[r * 2 * BW_LDW + c], sxl[r * 2 * BW_LDW + c]);
      }
      if (c0 == 0 && tid < BW_COLS) sx2[tid] = tid < n ? x2l[t0 + tid] : 0.f;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BW_DC / 16; ++kk) {
        const uint32_t ahi[4] = {wyh[kk * 8], wyh[8 * BW_LDW + kk * 8], wyh[kk * 8 + 4],
                                 wyh[8 * BW_LDW + kk * 8 + 4]};
        const uint32_t alo[4] = {wyl[kk * 8], wyl[8 * BW_LDW + kk * 8], wyl[kk * 8 + 4],
                                 wyl[8 * BW_LDW + kk * 8 + 4]};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 2 * warp + h;
          const uint32_t* bh = smem + L.x_hi + (q * 8 + g) * BW_LDW + kk * 8 + t4;
          const uint32_t* bl = smem + L.x_lo + (q * 8 + g) * BW_LDW + kk * 8 + t4;
          dot3_step(sk[h], ahi, alo, bh[0], bh[4], bl[0], bl[4]);
        }
      }
    }

    // K in registers: norms, clamp, exp, column mask, row-sums; then split
    // into hi/lo, the A fragment of the drive's k-step `warp`
    const float y2a = sy2[g];
    const float y2b = sy2[g + 8];
    uint32_t khi[4], klo[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat16 hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = (2 * warp + h) * 8 + 2 * t4 + (i & 1);
        // (y² + x²) − 2·yx, the plain version's order (2·yx is exact)
        const float d2 = fmaxf(__fadd_rn(i < 2 ? y2a : y2b, sx2[col]) - 2.0f * sk[h][i],
                               0.f);
        const float kv = col < n ? expf(-d2 * inv_h) : 0.f;
        if (i < 2) ks0 += kv; else ks1 += kv;
        split_bf16(kv, hi[i], lo[i]);
      }
      khi[2 * h] = pack_bf16(hi[0], hi[1]);
      khi[2 * h + 1] = pack_bf16(hi[2], hi[3]);
      klo[2 * h] = pack_bf16(lo[0], lo[1]);
      klo[2 * h + 1] = pack_bf16(lo[2], lo[3]);
    }
    skf[(warp * 32 + ln) * 2] = make_uint4(khi[0], khi[1], khi[2], khi[3]);
    skf[(warp * 32 + ln) * 2 + 1] = make_uint4(klo[0], klo[1], klo[2], klo[3]);
    __syncthreads();
    uint32_t ahi[BW_WARPS][4], alo[BW_WARPS][4];
#pragma unroll
    for (int kk = 0; kk < BW_WARPS; ++kk) {
      const uint4 vh = skf[(kk * 32 + ln) * 2];
      const uint4 vl = skf[(kk * 32 + ln) * 2 + 1];
      ahi[kk][0] = vh.x; ahi[kk][1] = vh.y; ahi[kk][2] = vh.z; ahi[kk][3] = vh.w;
      alo[kk][0] = vl.x; alo[kk][1] = vl.y; alo[kk][2] = vl.z; alo[kk][3] = vl.w;
    }

    // the drive, K·xs by _dot3, one 64-column chunk of xs at a time
    for (int c0 = 0; c0 < dpc; c0 += BW_DC) {
      __syncthreads();  // the previous readers of the xs chunk are done
      for (int e = tid; e < BW_COLS * BW_DC; e += BW_THREADS) {
        const int r = e / BW_DC;
        const int c = e - r * BW_DC;
        const float v = (r < n && c0 + c < d) ? xsl[(long long)(t0 + r) * d + c0 + c] : 0.f;
        split_bf16(v, sxsh[c * 2 * BW_LDT + r], sxsl[c * 2 * BW_LDT + r]);
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 2 * warp + h;
        float* a0 = sacc + g * lda + c0 + q * 8 + 2 * t4;
        float* a1 = a0 + 8 * lda;
        float acc[4] = {a0[0], a0[1], a1[0], a1[1]};
#pragma unroll
        for (int kk = 0; kk < BW_WARPS; ++kk) {
          const uint32_t* bh = smem + L.xs_hi + (q * 8 + g) * BW_LDT + kk * 8 + t4;
          const uint32_t* bl = smem + L.xs_lo + (q * 8 + g) * BW_LDT + kk * 8 + t4;
          dot3_step(acc, ahi[kk], alo[kk], bh[0], bh[4], bl[0], bl[4]);
        }
        a0[0] = acc[0]; a0[1] = acc[1];
        a1[0] = acc[2]; a1[1] = acc[3];
      }
    }
  }
  // row-sums: the four threads of a row group, then the four warps, in a
  // fixed order
  ks0 += __shfl_xor_sync(0xffffffffu, ks0, 1);
  ks0 += __shfl_xor_sync(0xffffffffu, ks0, 2);
  ks1 += __shfl_xor_sync(0xffffffffu, ks1, 1);
  ks1 += __shfl_xor_sync(0xffffffffu, ks1, 2);
  if (t4 == 0) {
    sks[warp * BW_ROWS + g] = ks0;
    sks[warp * BW_ROWS + g + 8] = ks1;
  }
  __syncthreads();

  float* pl = part + ((long long)split * S + lane) * k * (d + 1);
  for (int e = tid; e < BW_ROWS * d; e += BW_THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    if (row0 + r < k) pl[(long long)(row0 + r) * (d + 1) + c] = sacc[r * lda + c];
  }
  if (tid < BW_ROWS && row0 + tid < k) {
    float ksum = sks[tid];
#pragma unroll
    for (int w = 1; w < BW_WARPS; ++w) ksum += sks[w * BW_ROWS + tid];
    pl[(long long)(row0 + tid) * (d + 1) + d] = ksum;
  }
}

// y (S, k, d); x (m, d) with x_lane_stride 0, or (S, m, d) with stride m·d;
// xs (S, m, d); y2 (S, k) and x2 (m) or (S, m) the row norms ‖·‖²;
// part (nsplit, S, k, d + 1) scratch; out (S, k, d).  All f32, contiguous,
// on `device`; 1 ≤ d ≤ 2432 (the wrapper routes 128 < d here); chunk a
// multiple of 64.  Launches on `stream`, allocates nothing, does not
// synchronise; returns the cudaGetLastError() code.
extern "C" int phi_wide_d_bf16x3_launch(const void* y, const void* x,
                                        const void* xs, const void* y2,
                                        const void* x2, void* part, void* out,
                                        int S, int k, int m, int d,
                                        int x_lane_stride, int chunk, int nsplit,
                                        float inv_h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > BW_MAX_D || chunk % BW_COLS) return (int)cudaErrorInvalidValue;
  const float* fy = static_cast<const float*>(y);
  float* fpart = static_cast<float*>(part);
  const size_t smem = sizeof(uint32_t) * (size_t)BwLayout(d).words;
  err = cudaFuncSetAttribute(phi_wide_d_bf16x3_partial,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((k + BW_ROWS - 1) / BW_ROWS, S, nsplit);
  phi_wide_d_bf16x3_partial<<<grid, BW_THREADS, smem, st>>>(
      fy, static_cast<const float*>(x), static_cast<const float*>(xs),
      static_cast<const float*>(y2), static_cast<const float*>(x2), fpart, S, k, m,
      d, x_lane_stride, chunk, inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_phi_finalize(fpart, fy, static_cast<float*>(out), nsplit, S, k,
                                  d, m, inv_h, st);
}
