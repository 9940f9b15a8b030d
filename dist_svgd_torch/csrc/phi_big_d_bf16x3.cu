// Fused SVGD φ for feature dims 8 < d ≤ 128, bf16x3 tier on the tensor
// cores — hand-written for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `_phi_kernel` (reached through
// `phi_pallas`) in its bf16 tier (gram_dtype=bfloat16, phi_impl='pallas_bf16'
// — here 'cuda_bf16'), where both contractions run as `_dot3`'s three-pass
// bf16 splits, together with its `_phi_tail` epilogue.
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
// and ‖x‖², summed in torch as the plain version sums them: at the path's
// h = 1 φ rides the Gram diagonal, where d² is the small difference of
// three numbers near 2d, so the kernel and its plain version differ there
// only by the order of the y·xᵀ sums.
//
// What bounds it on this card: the tensor cores.  A Covertype call (8 lanes
// × 1250 rows × 10,000, d = 55) is 1e8 pairs at 6·d bf16 flops a pair for
// each contraction, ~6.6e10 flops, 0.067 ms at the 989 TFLOP/s bf16 peak;
// the per-pair norm form, exp, mask and split on the CUDA cores
// (~16 f32 operations a pair) are ~0.02 ms at 67 TFLOP/s, and the inputs
// are a few MB.
//
// What the design does about it (a simple, correct first kernel; wgmma,
// TMA and a pipelined ring of tiles are later work):
// - a block of four warps owns 64 output rows of one lane; each warp owns
//   16 rows and keeps them as bf16 hi/lo in shared memory, padded to dp, a
//   multiple of 16 (the k depth of one mma.sync.m16n8k16 bf16 product);
// - x and xs stream through shared memory 64 rows at a time, split into
//   bf16 hi/lo as they are loaded (x row-major, xs transposed, so that every
//   A and B fragment is one 32-bit shared load of two neighbouring values;
//   rows padded to a stride of 4 (mod 8) words, so the fragment loads hit
//   32 distinct banks);
// - the 16×64 Gram tile of a warp is 8 n-tiles × dp/16 k-steps × 3 MMAs;
//   its f32 accumulator fragment is turned into K in registers (norms,
//   clamp, expf, column mask, row-sum) and, split into hi/lo, becomes the
//   A fragment of the drive product as it stands (the accumulator-to-A
//   layout identity of m16n8k16), so K never leaves registers;
// - each k-step's three products go into a zeroed fragment that is then
//   added to the running f32 sum: the tensor cores' f32 accumulation
//   truncates, and a small fresh sum loses fewer bits than adding every
//   product into the large running one (the Gram's diagonal cancels in
//   y² + x² − 2·yx);
// - the m axis is split across `nsplit` blocks per row tile and
//   phi_finalize (phi_common.cuh) reduces the partials in a fixed order —
//   deterministic, no float atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phi_common.cuh"

constexpr int BX_ROWS = 64;  // output rows per block, 16 per warp
constexpr int BX_COLS = 64;  // interaction rows per shared-memory tile
constexpr int BX_WARPS = 4;
constexpr int BX_THREADS = 32 * BX_WARPS;
constexpr int BX_MAX_D = 128;  // the wrapper refuses larger d
constexpr int BX_LDT = BX_COLS / 2 + 4;  // words a transposed xs row

// Shared-memory layout for dp = 16·KD, in 32-bit words (two bf16 each).
template <int KD>
struct BxLayout {
  static constexpr int DP = 16 * KD;
  static constexpr int LDW = DP / 2 + 4;  // words a y or x row
  static constexpr int Y_HI = 0;
  static constexpr int Y_LO = Y_HI + BX_ROWS * LDW;
  static constexpr int X_HI = Y_LO + BX_ROWS * LDW;
  static constexpr int X_LO = X_HI + BX_COLS * LDW;
  static constexpr int XS_HI = X_LO + BX_COLS * LDW;  // DP rows × BX_LDT
  static constexpr int XS_LO = XS_HI + DP * BX_LDT;
  static constexpr int Y2 = XS_LO + DP * BX_LDT;       // BX_ROWS floats
  static constexpr int X2 = Y2 + BX_ROWS;              // BX_COLS floats
  static constexpr int WORDS = X2 + BX_COLS;
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

template <int KD>
__global__ void __launch_bounds__(BX_THREADS)
phi_big_d_bf16x3_partial(const float* __restrict__ y, const float* __restrict__ x,
                         const float* __restrict__ xs, const float* __restrict__ y2,
                         const float* __restrict__ x2, float* __restrict__ part,
                         int S, int k, int m, int d, int x_lane_stride, int chunk,
                         float inv_h) {
  using L = BxLayout<KD>;
  constexpr int DP = L::DP;
  constexpr int LDW = L::LDW;
  constexpr int NT = 2 * KD;        // 8-column n-tiles of the drive output
  constexpr int GT = BX_COLS / 8;   // 8-column n-tiles of the Gram tile
  extern __shared__ uint32_t smem[];
  __nv_bfloat16* syh = reinterpret_cast<__nv_bfloat16*>(smem + L::Y_HI);
  __nv_bfloat16* syl = reinterpret_cast<__nv_bfloat16*>(smem + L::Y_LO);
  __nv_bfloat16* sxh = reinterpret_cast<__nv_bfloat16*>(smem + L::X_HI);
  __nv_bfloat16* sxl = reinterpret_cast<__nv_bfloat16*>(smem + L::X_LO);
  __nv_bfloat16* sxsh = reinterpret_cast<__nv_bfloat16*>(smem + L::XS_HI);
  __nv_bfloat16* sxsl = reinterpret_cast<__nv_bfloat16*>(smem + L::XS_LO);
  float* sy2 = reinterpret_cast<float*>(smem + L::Y2);
  float* sx2 = reinterpret_cast<float*>(smem + L::X2);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // fragment row group
  const int t4 = tid & 3;         // thread within the group
  const int wr = warp * 16;       // the warp's first row in the block
  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int row0 = blockIdx.x * BX_ROWS;
  const float* yl = y + (long long)lane * k * d;
  const float* xl = x + (long long)lane * x_lane_stride;
  const float* xsl = xs + (long long)lane * m * d;
  const float* y2l = y2 + (long long)lane * k;
  const float* x2l = x2 + (x_lane_stride ? (long long)lane * m : 0LL);

  // the block's y rows, split (zeros past k and past d), and their norms
  for (int e = tid; e < BX_ROWS * DP; e += BX_THREADS) {
    const int r = e / DP;
    const int c = e - r * DP;
    const float v = (row0 + r < k && c < d) ? yl[(long long)(row0 + r) * d + c] : 0.f;
    split_bf16(v, syh[r * 2 * LDW + c], syl[r * 2 * LDW + c]);
  }
  if (tid < BX_ROWS) sy2[tid] = row0 + tid < k ? y2l[row0 + tid] : 0.f;

  float acc[NT][4];
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
  float ks0 = 0.f, ks1 = 0.f;  // row-sum partials of rows g and g + 8

  const uint32_t* wyh = smem + L::Y_HI + (wr + g) * LDW + t4;
  const uint32_t* wyl = smem + L::Y_LO + (wr + g) * LDW + t4;
  const int j0 = split * chunk;
  const int j1 = min(m, j0 + chunk);
  for (int t0 = j0; t0 < j1; t0 += BX_COLS) {
    const int n = min(BX_COLS, j1 - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BX_COLS * DP; e += BX_THREADS) {
      const int r = e / DP;
      const int c = e - r * DP;
      const bool ok = r < n && c < d;
      const long long off = (long long)(t0 + r) * d + c;
      split_bf16(ok ? xl[off] : 0.f, sxh[r * 2 * LDW + c], sxl[r * 2 * LDW + c]);
      split_bf16(ok ? xsl[off] : 0.f, sxsh[c * 2 * BX_LDT + r],
                 sxsl[c * 2 * BX_LDT + r]);
    }
    if (tid < BX_COLS) sx2[tid] = tid < n ? x2l[t0 + tid] : 0.f;
    __syncthreads();

    // the warp's 16×64 Gram tile, y·xᵀ by _dot3
    float sk[GT][4];
#pragma unroll
    for (int q = 0; q < GT; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) sk[q][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const uint32_t ahi[4] = {wyh[kk * 8], wyh[8 * LDW + kk * 8], wyh[kk * 8 + 4],
                               wyh[8 * LDW + kk * 8 + 4]};
      const uint32_t alo[4] = {wyl[kk * 8], wyl[8 * LDW + kk * 8], wyl[kk * 8 + 4],
                               wyl[8 * LDW + kk * 8 + 4]};
#pragma unroll
      for (int q = 0; q < GT; ++q) {
        const uint32_t* bh = smem + L::X_HI + (q * 8 + g) * LDW + kk * 8 + t4;
        const uint32_t* bl = smem + L::X_LO + (q * 8 + g) * LDW + kk * 8 + t4;
        dot3_step(sk[q], ahi, alo, bh[0], bh[4], bl[0], bl[4]);
      }
    }

    // K in registers: norms, clamp, exp, column mask, row-sums
    const float y2a = sy2[wr + g];
    const float y2b = sy2[wr + g + 8];
#pragma unroll
    for (int q = 0; q < GT; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = q * 8 + 2 * t4 + (i & 1);
        // (y² + x²) − 2·yx, the plain version's order (2·yx is exact)
        const float d2 = fmaxf(__fadd_rn((i < 2 ? y2a : y2b), sx2[col]) - 2.0f * sk[q][i],
                               0.f);
        const float kv = col < n ? expf(-d2 * inv_h) : 0.f;
        sk[q][i] = kv;
        if (i < 2) ks0 += kv; else ks1 += kv;
      }
    }

    // the drive, K·xs by _dot3: two Gram n-tiles make one A fragment
#pragma unroll
    for (int kk = 0; kk < BX_COLS / 16; ++kk) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // n-tile 2kk + h → registers 2h, 2h + 1
        __nv_bfloat16 hi0, lo0, hi1, lo1, hi2, lo2, hi3, lo3;
        split_bf16(sk[2 * kk + h][0], hi0, lo0);
        split_bf16(sk[2 * kk + h][1], hi1, lo1);
        split_bf16(sk[2 * kk + h][2], hi2, lo2);
        split_bf16(sk[2 * kk + h][3], hi3, lo3);
        ahi[2 * h] = pack_bf16(hi0, hi1);
        ahi[2 * h + 1] = pack_bf16(hi2, hi3);
        alo[2 * h] = pack_bf16(lo0, lo1);
        alo[2 * h + 1] = pack_bf16(lo2, lo3);
      }
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const uint32_t* bh = smem + L::XS_HI + (q * 8 + g) * BX_LDT + kk * 8 + t4;
        const uint32_t* bl = smem + L::XS_LO + (q * 8 + g) * BX_LDT + kk * 8 + t4;
        dot3_step(acc[q], ahi, alo, bh[0], bh[4], bl[0], bl[4]);
      }
    }
  }
  // the four threads of a row group hold disjoint columns: combine the
  // row-sums in a fixed order
  ks0 += __shfl_xor_sync(0xffffffffu, ks0, 1);
  ks0 += __shfl_xor_sync(0xffffffffu, ks0, 2);
  ks1 += __shfl_xor_sync(0xffffffffu, ks1, 1);
  ks1 += __shfl_xor_sync(0xffffffffu, ks1, 2);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = row0 + wr + g + 8 * half;
    if (i >= k) continue;
    float* pr = part + (((long long)split * S + lane) * k + i) * (d + 1);
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int c = q * 8 + 2 * t4;
      if (c < d) pr[c] = acc[q][2 * half];
      if (c + 1 < d) pr[c + 1] = acc[q][2 * half + 1];
    }
    if (t4 == 0) pr[d] = half ? ks1 : ks0;
  }
}

template <int KD>
static cudaError_t launch(const float* y, const float* x, const float* xs,
                          const float* y2, const float* x2, float* part, float* out,
                          int S, int k, int m, int d, int x_lane_stride, int chunk,
                          int nsplit, float inv_h, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * (size_t)BxLayout<KD>::WORDS;
  cudaError_t err = cudaFuncSetAttribute(
      phi_big_d_bf16x3_partial<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((k + BX_ROWS - 1) / BX_ROWS, S, nsplit);
  phi_big_d_bf16x3_partial<KD><<<grid, BX_THREADS, smem, stream>>>(
      y, x, xs, y2, x2, part, S, k, m, d, x_lane_stride, chunk, inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_phi_finalize(part, y, out, nsplit, S, k, d, m, inv_h, stream);
}

// y (S, k, d); x (m, d) with x_lane_stride 0, or (S, m, d) with stride m·d;
// xs (S, m, d); y2 (S, k) and x2 (m) or (S, m) the row norms ‖·‖²;
// part (nsplit, S, k, d + 1) scratch; out (S, k, d).  All f32, contiguous,
// on `device`; 8 < d ≤ 128; chunk a multiple of 64.  Launches on `stream`,
// allocates nothing, does not synchronise; returns the cudaGetLastError()
// code.
extern "C" int phi_big_d_bf16x3_launch(const void* y, const void* x,
                                       const void* xs, const void* y2,
                                       const void* x2, void* part, void* out,
                                       int S, int k, int m, int d,
                                       int x_lane_stride, int chunk, int nsplit,
                                       float inv_h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > BX_MAX_D) return (int)cudaErrorInvalidValue;
  const float* fy = static_cast<const float*>(y);
  const float* fx = static_cast<const float*>(x);
  const float* fxs = static_cast<const float*>(xs);
  const float* fy2 = static_cast<const float*>(y2);
  const float* fx2 = static_cast<const float*>(x2);
  float* fpart = static_cast<float*>(part);
  float* fout = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PHI_BF16X3_CASE(KD)                                                    \
  case KD:                                                                     \
    return (int)launch<KD>(fy, fx, fxs, fy2, fx2, fpart, fout, S, k, m, d,      \
                           x_lane_stride, chunk, nsplit, inv_h, st);
  switch ((d + 15) / 16) {
    PHI_BF16X3_CASE(1)
    PHI_BF16X3_CASE(2)
    PHI_BF16X3_CASE(3)
    PHI_BF16X3_CASE(4)
    PHI_BF16X3_CASE(5)
    PHI_BF16X3_CASE(6)
    PHI_BF16X3_CASE(7)
    PHI_BF16X3_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PHI_BF16X3_CASE
}
